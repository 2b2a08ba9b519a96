"""Chunked gather engine: the JAX package's `xla` backend
(psa_tpu/ops/engine_xla.py), in plain torch.

The straightforward formulation of the sweep: per block of _BLOCK offsets,
take the Seq1 windows, look each (Seq1 code, Seq2 code) pair up in the
flat 32 x 32 fused code table, and decode the codes into the four
sign-class counts and the max substitution rank.  The name `xla` is the JAX
package's, kept so that `psa-torch --backend xla` takes the argument `psa`
takes; on the card this is plain torch indexing (a view, one gather and a
few reductions per block), not a hand-written kernel.  It is the portable
differential reference of the CUDA sweep (csrc/sweep.cu): exact integers
on any device, and the sharded paths' `kernel="xla"` (parallel/mesh.py).

Memory: a block holds _BLOCK x l2p pairs.  The windows are a view of Seq1
(`unfold`, no copy); the pair index is int32 (4 bytes a pair), the looked-up
code int8 (1 byte) and each decode step a bool or int8 temporary of the
same shape (1 byte).  At l2p = 250,016 (the 600k x 250k query's padded
Seq2 on the sharded path) a block is 1.28e8 pairs: 512 MB of index and
under 1 GB of temporaries at the peak.
"""

from __future__ import annotations

import numpy as np
import torch

from psa_torch.core.tables import ScoringTables

_BLOCK = 512


def stats_from_codevals(codeval: torch.Tensor):
    """Decode fused code values -> (counts (..., 4) int32, maxrank (...,)
    int32).

    codeval: integer tensor (..., n2-axis last); 0 = inert, else
    1 + class + 4 (rank + 1)."""
    valid = codeval > 0
    v = codeval - 1
    minus1 = torch.full_like(v, -1)
    cls = torch.where(valid, v & 3, minus1)
    counts = torch.stack([(cls == k).sum(-1, dtype=torch.int32)
                          for k in range(4)], dim=-1)
    rank = torch.where(valid, (v >> 2) - 1, minus1)
    return counts, rank.amax(-1).to(torch.int32)


def stats5_xla(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
               width: int) -> torch.Tensor:
    """(5, width) int32 stats5 of offsets [0, width) on c1's device: rows
    0-3 the class counts, row 4 the maxrank (the layout of ops/sweep.sweep).

    c1: (>= width + l2p - 1,) integer codes; c2: (l2p,) integer codes;
    code: (32, 32) fused table.  Works in blocks of _BLOCK offsets (the last
    may be shorter)."""
    l2p = c2.shape[0]
    if c1.shape[0] < width + l2p - 1:
        raise ValueError(f"Seq1 of {c1.shape[0]} codes does not cover "
                         f"{width} windows of {l2p}")
    code_flat = code.reshape(-1)
    wins = c1.unfold(0, l2p, 1)                  # (n1 - l2p + 1, l2p) view
    c2i = c2.to(torch.int32)
    out = torch.empty((5, width), dtype=torch.int32, device=c1.device)
    for o0 in range(0, width, _BLOCK):
        o1 = min(o0 + _BLOCK, width)
        idx = wins[o0:o1].to(torch.int32, copy=True)
        idx.mul_(32).add_(c2i)
        counts, maxrank = stats_from_codevals(code_flat[idx])
        del idx
        out[:4, o0:o1] = counts.T
        out[4, o0:o1] = maxrank
    return out


def offset_stats_xla(codes1: np.ndarray, codes2: np.ndarray,
                     tables: ScoringTables, device):
    """Per-offset (counts (noff, 4) int32, maxrank (noff,) int32) on the
    host, computed on `device`.  Both sequences go in at their own lengths:
    the JAX package pads them to a few bucketed shapes to bound its
    compiles, which the card does not need, and the last block is cut at
    noff."""
    dev = torch.device(device)
    c1 = torch.from_numpy(np.asarray(codes1).astype(np.uint8)).to(dev)
    c2 = torch.from_numpy(np.asarray(codes2).astype(np.uint8)).to(dev)
    code = torch.from_numpy(np.ascontiguousarray(tables.code)).to(dev)
    noff = c1.shape[0] - c2.shape[0] + 1
    st = stats5_xla(c1, c2, code, noff).cpu().numpy()
    return st[:4].T.copy(), st[4].copy()
