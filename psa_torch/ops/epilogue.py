"""The top-k epilogue and its pack: the CUDA kernel's wrapper, its plain
PyTorch version and the comparator the tests and the smoke share.

`epilogue_pack` turns B rows of stats5 (rows 0-3 the class counts, row 4
the maxrank) into the (B, 6k+2) int32 pack that one fetch brings to the
host: [topi (k, global offsets) | stats5 at topi (5 x k) | near | best as
f32 bits] (`unpack_epilogue_outputs` reads it on the host).  CUDA tensors
go through the hand-written kernel (csrc/epilogue.cu: one launch when a row
fits one block of EPILOGUE_COLS offsets, two otherwise, no host
synchronisation); CPU tensors through `epilogue_pack_plain`, the torch
composition the device paths ran before (`exact_topk_epilogue_rows` and
`pack_epilogue_outputs`; models/batch re-exports the three).  A failed
build or launch raises; a CUDA tensor never reaches the plain version.

The kernel replaces XLA code of the JAX package, not a Pallas kernel: its
runners fuse psa_tpu/models/batch.py:643 `exact_topk_epilogue_rows_ops`
and :703 `pack_epilogue_outputs` into one executable.

Equal keys may come out in another order than torch.topk's, so two packs
are compared with `same_pack`: best bits, near, the multiset of keys at
topi, the stats5 columns at topi, and distinct in-range indices.
"""

from __future__ import annotations

import numpy as np
import torch

from psa_torch.core.tables import DeviceTables
from psa_torch.ops import sweep as sw
from psa_torch.ops.common import keyed_f32_totals_ops

TOPK = 32
EPILOGUE_COLS = 2048   # offsets per block of the kernel (csrc/epilogue.cu kCols)

# Epilogue calls that launched the kernel, and the CUDA launches they made
# (one or two each): plain integers a caller can zero and read.
launches = 0
cuda_launches = 0


def exact_topk_epilogue_rows(stats5: torch.Tensor, dtabs: DeviceTables,
                             noff: int, l2p: int, k: int = TOPK):
    """Rows-layout checkable-exact epilogue.

    stats5: (..., 5, NP) int32 — rows 0-3 class counts, row 4 maxrank;
    noff: the real offset count, an int or a per-row (...,) tensor.
    Returns (topi (..., k) int32, stats_k (..., 5, k), near (...,),
    best (...,) f32).  torch.topk orders equal keys differently from
    lax.top_k; that cannot change a winner, because every band member is in
    the top k whenever near <= k, and near > k makes the host fall back.
    """
    keyed, _ = keyed_f32_totals_ops(stats5[..., :4, :], stats5[..., 4, :],
                                    dtabs.w32, dtabs.diff32, dtabs.is_max,
                                    noff)
    best = keyed.amax(dim=-1)
    near = (keyed >= (best - dtabs.eps(l2p)).unsqueeze(-1)).sum(-1)
    topi = torch.topk(keyed, k, dim=-1).indices
    idx = topi.unsqueeze(-2).expand(*stats5.shape[:-1], k)
    stats_k = torch.gather(stats5, -1, idx)
    return topi.to(torch.int32), stats_k, near, best


def pack_epilogue_outputs(topi, stats_k, near, best) -> torch.Tensor:
    """Pack the epilogue outputs into ONE int32 array (B, 6k+2), so that one
    fetch brings them to the host.  Layout per row:
    [topi (k) | stats5 (5k) | near | best_bits_f32]."""
    b, k = topi.shape
    return torch.cat([topi.to(torch.int32),
                      stats_k.reshape(b, 5 * k).to(torch.int32),
                      near.to(torch.int32).reshape(b, 1),
                      best.to(torch.float32).contiguous()
                      .view(torch.int32).reshape(b, 1)], dim=1)


def unpack_epilogue_outputs(buf: np.ndarray, k: int):
    """Host-side inverse of `pack_epilogue_outputs` (numpy)."""
    topi = buf[:, :k]
    stats_k = buf[:, k:6 * k].reshape(buf.shape[0], 5, k)
    near = buf[:, 6 * k]
    best = buf[:, 6 * k + 1].view(np.float32)
    return topi, stats_k, near, best


def epilogue_pack_plain(stats5: torch.Tensor, dtabs: DeviceTables, noff,
                        l2p: int, k: int = TOPK, g0: int = 0) -> torch.Tensor:
    """The plain PyTorch version of `epilogue_pack`, on any device: the
    rows epilogue, its pack, and the offsets moved by g0."""
    topi, stats_k, near, best = exact_topk_epilogue_rows(stats5, dtabs, noff,
                                                         l2p, k)
    return pack_epilogue_outputs(topi + g0, stats_k, near, best)


def _check(stats5: torch.Tensor, dtabs: DeviceTables, noff, k: int):
    """Shapes, types and devices the kernel takes -> (b, np)."""
    if stats5.dtype != torch.int32 or stats5.dim() != 3 or stats5.shape[1] != 5:
        raise ValueError("expected stats5 (B, 5, NP) int32, got "
                         f"{tuple(stats5.shape)} {stats5.dtype}")
    b, _, np_ = stats5.shape
    if not 1 <= b <= 65535:
        raise ValueError(f"the epilogue takes 1 to 65535 rows, got {b}")
    if not 1 <= k <= np_:
        raise ValueError(f"k = {k} needs 1 <= k <= NP = {np_}")
    if stats5.stride(2) != 1:
        raise ValueError("stats5's offset axis must be contiguous")
    for name, t, dtype in (("w32", dtabs.w32, torch.float32),
                           ("diff32", dtabs.diff32, torch.float32)):
        if t.device != stats5.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"dtabs.{name} must be contiguous {dtype} on "
                             f"{stats5.device}")
    if isinstance(noff, torch.Tensor) and (
            noff.device != stats5.device or noff.dtype != torch.int32
            or tuple(noff.shape) != (b,) or not noff.is_contiguous()):
        raise ValueError(f"noff must be an int or a contiguous ({b},) int32 "
                         f"tensor on {stats5.device}")
    return b, np_


def epilogue_pack(stats5: torch.Tensor, dtabs: DeviceTables, noff, l2p: int,
                  k: int = TOPK, g0: int = 0) -> torch.Tensor:
    """(B, 6k+2) int32 pack of B stats5 rows (see the module docstring).

    stats5: (B, 5, NP) int32, the offset axis contiguous (rows at any
    stride); noff: the real offset count, an int or a (B,) int32 tensor on
    stats5's device; l2p: the padded Seq2 length that sets the band's eps;
    g0: the global offset of column 0 (a mesh shard's first).  CUDA tensors
    go through the kernel, CPU tensors through `epilogue_pack_plain`."""
    global launches, cuda_launches
    dev = stats5.device
    if dev.type == "cpu":
        return epilogue_pack_plain(stats5, dtabs, noff, l2p, k, g0)
    if dev.type != "cuda":
        raise ValueError(f"no epilogue for device {dev}")
    b, np_ = _check(stats5, dtabs, noff, k)
    lib = sw.build_library()
    out = torch.empty((b, 6 * k + 2), dtype=torch.int32, device=dev)
    words = lib.psa_epilogue_scratch_words(b, np_, k)
    scratch = (torch.empty(words, dtype=torch.int32, device=dev) if words
               else None)
    per_row = isinstance(noff, torch.Tensor)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.psa_epilogue_launch(
            stats5.data_ptr(), stats5.stride(0), stats5.stride(1), b, np_,
            dtabs.w32.data_ptr(), dtabs.diff32.data_ptr(),
            dtabs.diff32.shape[0], noff.data_ptr() if per_row else None,
            0 if per_row else int(noff), dtabs.eps(l2p), int(dtabs.is_max),
            int(g0), k, out.data_ptr(),
            scratch.data_ptr() if words else None, words, stream)
    if err != 0:
        raise RuntimeError("psa_epilogue_launch failed: "
                           + lib.psa_error_string(err).decode())
    launches += 1
    cuda_launches += 2 if words else 1   # scratch only for the two-launch form
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_mismatch(a, b, stats5, noff, dtabs: DeviceTables, g0: int = 0,
                  k: int = TOPK) -> str | None:
    """The first way pack `b` differs from pack `a` of the same stats5 rows
    (B, 5, NP), or None when they agree: best's bits, near, the multiset of
    f32 keys at topi (equal keys may come in any order), every stats_k
    column against stats5 at its index, and k distinct in-range indices
    (topi - g0 in [0, NP)) in each."""
    a, b, st = _host(a), _host(b), _host(stats5)
    if a.shape != b.shape or a.shape != (st.shape[0], 6 * k + 2):
        return f"shapes {a.shape} and {b.shape} for {st.shape[0]} rows"
    nf = _host(noff) if isinstance(noff, torch.Tensor) else noff
    keyed = keyed_f32_totals_ops(
        torch.from_numpy(st[:, :4]), torch.from_numpy(st[:, 4]),
        dtabs.w32.cpu(), dtabs.diff32.cpu(), dtabs.is_max,
        torch.from_numpy(np.asarray(nf)) if np.ndim(nf) else int(nf))[0].numpy()
    for r in range(st.shape[0]):
        if a[r, 6 * k + 1] != b[r, 6 * k + 1]:
            return f"row {r}: best bits {a[r, 6 * k + 1]:#x} != {b[r, 6 * k + 1]:#x}"
        if a[r, 6 * k] != b[r, 6 * k]:
            return f"row {r}: near {a[r, 6 * k]} != {b[r, 6 * k]}"
        keys = []
        for name, p in (("a", a), ("b", b)):
            cols = p[r, :k].astype(np.int64) - g0
            if cols.min() < 0 or cols.max() >= st.shape[2]:
                return f"row {r}: pack {name} has an index out of range"
            if np.unique(cols).size != k:
                return f"row {r}: pack {name} repeats an index"
            if not np.array_equal(p[r, k:6 * k].reshape(5, k), st[r][:, cols]):
                return f"row {r}: pack {name} has a stats_k column of another offset"
            keys.append(np.sort(keyed[r, cols]))
        if not np.array_equal(keys[0], keys[1]):
            return f"row {r}: the keys at topi differ"
    return None


def same_pack(a, b, stats5, noff, dtabs: DeviceTables, g0: int = 0,
              k: int = TOPK) -> bool:
    """True when packs `a` and `b` agree (`pack_mismatch`)."""
    return pack_mismatch(a, b, stats5, noff, dtabs, g0, k) is None
