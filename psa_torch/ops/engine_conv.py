"""One-hot convolution engine: the JAX package's `conv` backend
(psa_tpu/ops/engine_conv.py), as one `torch.nn.functional.conv1d`.

The per-offset statistics are cross-correlations of indicator sequences, so
the whole sweep is one convolution:

    input   X[0, a, j]   = onehot(seq1[j])[a]                 (1, 32, L1)
    filter  K[f, a, i]   = feature_f(code[a, seq2[i]])        (F, 32, L2)
    output  C[0, f, o]   = sum_(a, i) X[0, a, o + i] K[f, a, i]   (1, F, noff)

with F = 4 sign-class indicators + num_ranks rank indicators.  torch's
conv1d is a cross-correlation, as `lax.conv` is, so the filter is not
flipped.  counts = C[:4]; maxrank = the largest r with C[4 + r] > 0, else -1.

Exactness is the design constraint.  Every output is an integer below
2^24, held exactly in f32, only if the operands are 0/1, the output is f32
and the product is a direct or implicit-GEMM sum.  So:
- X and K are f32 and the conv runs with autocast off.  Never bf16 or fp16:
  torch's conv returns its inputs' dtype (JAX asks for f32 accumulation with
  `preferred_element_type`, torch has no such argument), and a bf16 count
  above 256 is no longer exact.  TF32 (cuDNN's default for f32 convs on the
  card) is exact on 0/1 operands, and the sums accumulate in f32, so
  `torch.backends.cudnn.allow_tf32` may stay as it is.
- The output is rounded (`torch.round`) before its int32 cast, and checked
  on its device in the same call: if any output lies 0.25 or more from an
  integer (an FFT or Winograd algorithm would leave such residues), the
  engine raises.  It never turns to another engine or to the host.
Both sequences go in at their own lengths, so the output holds exactly the
noff real offsets (the JAX package pads them to a few bucketed shapes to
bound its compiles and drops the padded offsets).  On the CPU the same code
runs through oneDNN.

`num_ranks == 0` (no pair admits a substitution) goes to the numpy oracle,
as in the JAX package: that is its semantics, not a device fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from psa_torch.core.alphabet import NCODES_PAD
from psa_torch.core.tables import ScoringTables

# the largest distance from an integer that a conv output may show before
# rounding; exact sums show 0
INT_TOLERANCE = 0.25


def onehot_seq1(c1: torch.Tensor) -> torch.Tensor:
    """(..., L1) integer codes -> (..., 32, L1) f32 one-hot."""
    return torch.nn.functional.one_hot(c1.long(), NCODES_PAD).to(
        torch.float32).transpose(-1, -2).contiguous()


def indicator_filter(code: torch.Tensor, c2: torch.Tensor,
                     num_ranks: int) -> torch.Tensor:
    """(..., L2) integer Seq2 codes -> (..., F, 32, L2) f32 filter, F = 4 +
    num_ranks: K[f, a, i] = 1 where the fused code of (a, seq2[i]) has sign
    class f (f < 4) or substitution rank f - 4."""
    col = code.to(torch.int32)[:, c2.long()]            # (32, ..., L2)
    col = col.movedim(0, -2)                            # (..., 32, L2)
    valid = col > 0
    v = col - 1
    minus1 = torch.full_like(v, -1)
    cls = torch.where(valid, v & 3, minus1)
    rank = torch.where(valid, (v >> 2) - 1, minus1)
    feats = [cls == k for k in range(4)] + [rank == r for r in range(num_ranks)]
    return torch.stack(feats, dim=-3).to(torch.float32)


def exact_int32(out: torch.Tensor) -> torch.Tensor:
    """The conv's f32 output rounded to int32, after checking on its device
    that no value lies INT_TOLERANCE or more from an integer; raises
    RuntimeError otherwise."""
    rounded = torch.round(out)
    err = float((out - rounded).abs().max())
    if not err < INT_TOLERANCE:
        raise RuntimeError(
            f"the conv engine's output is {err:g} from an integer: the "
            "convolution algorithm is not exact on this device")
    return rounded.to(torch.int32)


def stats5_from_conv(out: torch.Tensor) -> torch.Tensor:
    """(..., F, N) f32 conv output, F = 4 + num_ranks with num_ranks >= 1
    -> (..., 5, N) int32 stats5 (rows 0-3 the class counts, row 4 the
    maxrank, as ops/sweep.sweep returns), through `exact_int32`."""
    ints = exact_int32(out)
    rank_rows = ints[..., 4:, :]
    r = torch.arange(rank_rows.shape[-2], dtype=torch.int32,
                     device=ints.device)[:, None]
    maxrank = torch.where(rank_rows > 0, r, torch.full_like(rank_rows, -1)
                          ).amax(-2, keepdim=True)
    return torch.cat([ints[..., :4, :], maxrank], dim=-2)


def conv1d_f32(x: torch.Tensor, k: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """The one library call: torch's conv1d on f32 operands with autocast
    off, so it can never run in a lower precision."""
    if x.dtype != torch.float32 or k.dtype != torch.float32:
        raise ValueError("the conv engine runs on float32 operands only")
    with torch.autocast(device_type=x.device.type, enabled=False):
        return torch.nn.functional.conv1d(x, k, groups=groups)


def conv_stats5(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
                num_ranks: int) -> torch.Tensor:
    """(5, n1 - n2 + 1) int32 stats5 of one query on c1's device: c1 and c2
    integer code tensors, code the (32, 32) fused table."""
    x = onehot_seq1(c1)[None]                           # (1, 32, L1)
    k = indicator_filter(code, c2, num_ranks)           # (F, 32, L2)
    return stats5_from_conv(conv1d_f32(x, k)[0])


def offset_stats_conv(codes1: np.ndarray, codes2: np.ndarray,
                      tables: ScoringTables, device):
    """Per-offset (counts (noff, 4) int32, maxrank (noff,) int32) on the
    host, computed on `device` by one conv1d."""
    if tables.num_ranks == 0:  # degenerate: no pair admits any substitution
        from psa_torch.core.oracle import offset_stats_numpy

        return offset_stats_numpy(codes1, codes2, tables)
    dev = torch.device(device)
    c1 = torch.from_numpy(np.asarray(codes1).astype(np.uint8)).to(dev)
    c2 = torch.from_numpy(np.asarray(codes2).astype(np.uint8)).to(dev)
    code = torch.from_numpy(np.ascontiguousarray(tables.code)).to(dev)
    st = conv_stats5(c1, c2, code, tables.num_ranks).cpu().numpy()
    return st[:4].T.copy(), st[4].copy()
