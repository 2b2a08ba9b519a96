"""The top-k epilogue and its pack: the CUDA kernel's wrapper, its plain
PyTorch version and the comparator the tests and the smoke share.

`epilogue_pack` turns B rows of stats5 (rows 0-3 the class counts, row 4
the maxrank) into the (B, 6k+2) int32 pack that one fetch brings to the
host: [topi (k, global offsets) | stats5 at topi (5 x k) | near | best as
f32 bits] (`unpack_epilogue_outputs` reads it on the host).  CUDA tensors
go through the hand-written kernel (csrc/epilogue.cu: one launch at every
shape, no host synchronisation); CPU tensors through `epilogue_pack_plain`,
the torch composition (`exact_topk_epilogue_rows` and
`pack_epilogue_outputs`; models/batch re-exports the three).  A failed
build or launch raises; a CUDA tensor never reaches the plain version.

The kernel replaces XLA code of the JAX package, not a Pallas kernel: its
runners fuse psa_tpu/models/batch.py:643 `exact_topk_epilogue_rows_ops`
and :703 `pack_epilogue_outputs` into one executable.  Both versions rank
as lax.top_k does (equal keys lowest offset first), so the kernel's pack,
the plain version's and the JAX package's are equal word for word;
`pack_mismatch` names the first way two packs differ.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from psa_torch.core.tables import DeviceTables
from psa_torch.ops import sweep as sw
from psa_torch.ops.common import keyed_f32_totals_ops

TOPK = 32
MAX_K = 64             # csrc/epilogue.cu kMaxK
EPILOGUE_COLS = 2048   # the widest row the kernel takes as one block (kRowCols)
NARROW_COLS = 1024     # the narrower width of a wide row's blocks (kNarrowCols)
MAX_ROWS = 65535       # rows of one call (the grid's y extent)

# Epilogue calls that launched the kernel, and the CUDA launches they made
# (one each): plain integers a caller can zero and read.
launches = 0
cuda_launches = 0

# The kernel's arguments as one int64 block (csrc/epilogue.cu enum Param),
# one block a thread.
PARAMS = 20
_params = threading.local()

# device index -> its streaming multiprocessors
_sms: dict = {}

# (device index, stream) -> [tickets, data]: the kernel's scratch on each
# stream.  The tickets (one int32 a row, zeroed once) count a wide row's
# finished blocks; the row's last block resets its ticket to 0, so no call
# clears them.  The data buffer grows to the largest call's need.  Stream
# order keeps two calls from sharing either at once.
_scratch: dict = {}


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving int32 key of f32 values, and back: a larger
    float has a larger key, and +0.0 ranks above -0.0, as lax.top_k and
    jnp.max order them (csrc/epilogue.cu's `order_key`, on signed words).
    Given the keys (int32), returns the f32 values: the map is its own
    inverse on the bits."""
    bits = x.view(torch.int32)
    out = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return out if x.dtype == torch.float32 else out.view(torch.float32)


def rank_keys(keyed: torch.Tensor, k: int):
    """(topi (..., k) int64, best (...,) f32) of f32 keys (..., N): the k
    largest by a stable descending sort of their `order_keys`, so equal keys
    come lowest index first and +0.0 above -0.0, as lax.top_k ranks them;
    best the largest key's float (+0.0 where both zeros occur, as jnp.max
    gives it)."""
    okey = order_keys(keyed)
    best = order_keys(okey.amax(dim=-1))
    return torch.sort(okey, dim=-1, descending=True, stable=True).indices[..., :k], best


def exact_topk_epilogue_rows(stats5: torch.Tensor, dtabs: DeviceTables,
                             noff: int, l2p: int, k: int = TOPK):
    """Rows-layout checkable-exact epilogue.

    stats5: (..., 5, NP) int32 — rows 0-3 class counts, row 4 maxrank;
    noff: the real offset count, an int or a per-row (...,) tensor.
    Returns (topi (..., k) int32, stats_k (..., 5, k), near (...,),
    best (...,) f32), word for word the JAX package's (`rank_keys`)."""
    keyed, _ = keyed_f32_totals_ops(stats5[..., :4, :], stats5[..., 4, :],
                                    dtabs.w32, dtabs.diff32, dtabs.is_max,
                                    noff)
    topi, best = rank_keys(keyed, k)
    near = (keyed >= (best - dtabs.eps(l2p)).unsqueeze(-1)).sum(-1)
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


def block_cols(np_: int, sms: int) -> int:
    """Offsets per block of a row wider than EPILOGUE_COLS on a card of
    `sms` streaming multiprocessors: NARROW_COLS while the row's blocks fit
    two a multiprocessor (one wave: the north star's 88 on 132), else
    EPILOGUE_COLS (fewer blocks, one wave longer: 1M x 2,048's 488)."""
    return NARROW_COLS if -(-np_ // NARROW_COLS) <= 2 * sms else EPILOGUE_COLS


def scratch_words(b: int, np_: int, k: int, cols: int) -> int:
    """int32 words of data scratch one call of B rows of NP offsets needs,
    a wide row cut into blocks of `cols` (csrc/epilogue.cu
    psa_epilogue_scratch_words): none for rows that fit one block, else per
    block its top 32 (k <= 32) or 64 64-bit candidates and its band
    count."""
    if np_ <= EPILOGUE_COLS:
        return 0
    return b * -(-np_ // cols) * (2 * (32 if k <= 32 else 64) + 1)


def _scratch_for(dev: torch.device, stream: int, words: int):
    """(tickets, data) of the cached scratch of `stream` on `dev`, the data
    grown to at least `words` int32 words (None while no call needed any)."""
    s = _scratch.get((dev.index, stream))
    if s is None:
        s = _scratch[dev.index, stream] = [
            torch.zeros(MAX_ROWS, dtype=torch.int32, device=dev), None]
    if words and (s[1] is None or s[1].numel() < words):
        s[1] = torch.empty(words, dtype=torch.int32, device=dev)
    return s


def _check(stats5: torch.Tensor, noff, k: int):
    """Shapes, types and devices the kernel takes -> (b, np)."""
    if stats5.dtype != torch.int32 or stats5.dim() != 3 or stats5.shape[1] != 5:
        raise ValueError("expected stats5 (B, 5, NP) int32, got "
                         f"{tuple(stats5.shape)} {stats5.dtype}")
    b, _, np_ = stats5.shape
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"the epilogue takes 1 to {MAX_ROWS} rows, got {b}")
    if not 1 <= k <= min(np_, MAX_K):
        raise ValueError(f"k = {k} needs 1 <= k <= min(NP = {np_}, {MAX_K})")
    if stats5.stride(2) != 1:
        raise ValueError("stats5's offset axis must be contiguous")
    if isinstance(noff, torch.Tensor) and (
            noff.device != stats5.device or noff.dtype != torch.int32
            or tuple(noff.shape) != (b,) or not noff.is_contiguous()):
        raise ValueError(f"noff must be an int or a contiguous ({b},) int32 "
                         f"tensor on {stats5.device}")
    return b, np_


def _table_args(dtabs: DeviceTables, dev: torch.device, l2p: int) -> tuple:
    """(w32, diff32, n_diff, eps as f32 bits, is_max) as the kernel takes
    them, checked and kept on `dtabs` at their first call (its tensors
    never change)."""
    got = dtabs._memo.get(("epilogue", l2p))
    if got is None:
        for name, t in (("w32", dtabs.w32), ("diff32", dtabs.diff32)):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != dtabs.w32.device):
                raise ValueError(f"dtabs.{name} must be contiguous float32 on "
                                 f"{dtabs.w32.device}")
        if dtabs.diff32.shape[0] > 64:
            raise ValueError("the kernel takes at most 64 diff32 entries")
        eps_bits = int(np.float32(dtabs.eps(l2p)).view(np.int32))
        got = dtabs._memo["epilogue", l2p] = (dtabs.w32.device, (
            dtabs.w32.data_ptr(), dtabs.diff32.data_ptr(), dtabs.diff32.shape[0],
            eps_bits, int(dtabs.is_max)))
    if got[0] != dev:
        raise ValueError(f"dtabs must lie on {dev}, not {got[0]}")
    return got[1]


def epilogue_pack(stats5: torch.Tensor, dtabs: DeviceTables, noff, l2p: int,
                  k: int = TOPK, g0: int = 0) -> torch.Tensor:
    """(B, 6k+2) int32 pack of B stats5 rows (see the module docstring).

    stats5: (B, 5, NP) int32, the offset axis contiguous (rows at any
    stride); noff: the real offset count, an int or a (B,) int32 tensor on
    stats5's device; l2p: the padded Seq2 length that sets the band's eps;
    g0: the global offset of column 0 (a mesh shard's first).  CUDA tensors
    go through the kernel, one launch on the device's current stream; CPU
    tensors through `epilogue_pack_plain`."""
    global launches, cuda_launches
    dev = stats5.device
    if dev.type == "cpu":
        return epilogue_pack_plain(stats5, dtabs, noff, l2p, k, g0)
    if dev.type != "cuda":
        raise ValueError(f"no epilogue for device {dev}")
    b, np_ = _check(stats5, noff, k)
    w32, diff32, n_diff, eps_bits, is_max = _table_args(dtabs, dev, l2p)
    lib = sw.build_library()
    out = torch.empty((b, 6 * k + 2), dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    cols = block_cols(np_, sms)
    words = scratch_words(b, np_, k, cols)
    tickets, data = _scratch_for(dev, stream, words)
    per_row = isinstance(noff, torch.Tensor)
    p = getattr(_params, "block", None)
    if p is None:
        p = _params.block = (ctypes.c_longlong * PARAMS)()
    p[:] = (stats5.data_ptr(), stats5.stride(0), stats5.stride(1), b, np_, w32, diff32,
            n_diff, noff.data_ptr() if per_row else 0, 0 if per_row else int(noff),
            eps_bits, is_max, int(g0), k, out.data_ptr(), data.data_ptr() if words else 0,
            words, tickets.data_ptr(), stream, cols)
    if dev.index == torch.cuda.current_device():
        err = lib.psa_epilogue_launch(p)
    else:
        with torch.cuda.device(dev):
            err = lib.psa_epilogue_launch(p)
    if err != 0:
        raise RuntimeError("psa_epilogue_launch failed: "
                           + lib.psa_error_string(err).decode())
    launches += 1
    cuda_launches += 1
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_mismatch(a, b, stats5, noff, dtabs: DeviceTables, g0: int = 0,
                  k: int = TOPK) -> str | None:
    """The first way pack `b` differs from pack `a` of the same stats5 rows
    (B, 5, NP), or None when they are equal word for word.  Checked in
    order, per row: best's bits, near, k distinct in-range indices (topi -
    g0 in [0, NP)) whose stats_k columns are stats5's at each, the same
    multiset of f32 keys at topi, and last the words themselves (the same
    keys in another order)."""
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
        if not np.array_equal(a[r], b[r]):
            j = int(np.flatnonzero(a[r] != b[r])[0])
            return (f"row {r}: word {j} is {a[r, j]} against {b[r, j]} (the same "
                    "keys at topi in another order)")
    return None


def same_pack(a, b, stats5, noff, dtabs: DeviceTables, g0: int = 0,
              k: int = TOPK) -> bool:
    """True when packs `a` and `b` are equal word for word (`pack_mismatch`
    finds no difference)."""
    return pack_mismatch(a, b, stats5, noff, dtabs, g0, k) is None
