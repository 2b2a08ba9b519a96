"""The offset sweeps: the CUDA kernels' wrappers, their plain PyTorch
versions, shape planning, and `offset_stats`.

For each offset o of Seq2 under Seq1 the sweep reads the fused code
CODE[s1[o+i], s2[i]] at every position i and returns, per offset, the exact
counts of the four sign classes and the largest fused code (which encodes
the best substitution rank).  The TPU kernel
(psa_tpu/ops/pallas_sweep.py::_sweep_kernel) writes (8, noff_pad) int32,
rows 0-3 the class counts, row 4 the max code (0 = no substitution
anywhere), rows 5-7 zero (`sweep_rows_plain`, the layout the kernel lab's
sweeps keep); `maxrank_from_maxcode` follows it.  `sweep` returns what the
epilogue reads, stats5 (5, noff_pad) int32: rows 0-3 the class counts, row
4 the maxrank.

`sweep` launches the hand-written Hopper kernel (csrc/sweep.cu: an even
split of the (tile, 32-position) units over persistent workers, see
`sweep_plan`) for CUDA tensors and runs `sweep_plain` — the blocked gather
of the JAX package's engine_xla, in torch — for CPU tensors.
`sweep_batched` and `sweep_batched_shared` do the same for B queries at once
and return stats5 (B, 5, noff_pad) (csrc/sweep_batched.cu: the same split
over (tile, query) items, see `batched_split_plan`; plain versions
`sweep_batched_plain` and `sweep_batched_shared_plain`).  Both kernels'
offsets pad to whole TILE_O (`plan_shapes`, `plan_bucket`); their warp
tiles are WARP_TILE offsets, a word of 32 a lane, and a last tile may
reach past noff_pad.
The kernel lab's tensor-core sweeps (csrc/sweep_mma.cu, csrc/sweep_mma_v3.cu)
have their wrappers in ops/_sweep_v2.py and ops/_sweep_v3.py and are built
into the same library.  A failed build or launch raises; nothing falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections.abc import Sequence
from pathlib import Path

import numpy as np
import torch

from psa_torch.core.alphabet import PAD_CODE
from psa_torch.core.tables import ScoringTables
from psa_torch.ops.common import round_up
from psa_torch.utils import spans

TILE_O = 256     # offsets pad to this (csrc/sweep_core.cuh kPad)
WARP_TILE = 1024 # offsets per warp tile (csrc/sweep_core.cuh kGranule)
L2_ALIGN = 32    # Seq2 padding granularity (csrc/sweep_core.cuh kFlush)
SEG = 1024       # Seq2 positions per step of a worker (csrc/sweep_core.cuh kSegB)
BUCKET_O = 1024  # offset granularity of search_batch's bucket keys
MMA_TILE = 256   # offsets per block of the lab's sweeps (csrc/sweep_mma.cuh kTile)
MMA_CHUNK = 64   # Seq2 positions per band (csrc/sweep_mma.cuh kChunk)

# Kernel launches made by each wrapper: plain integers a caller can zero and
# read to show that a path went through the kernel.
launches = 0                  # sweep (csrc/sweep.cu)
launches_batched = 0          # sweep_batched (csrc/sweep_batched.cu)
launches_batched_shared = 0   # sweep_batched_shared (csrc/sweep_batched.cu)

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]
_lib = None


def plan_shapes(n1: int, n2: int):
    """(noff, noff_pad, l2p, l1k) for a (n1, n2) query: Seq2 pads to the
    kernel's flush granularity, the offsets to whole TILE_O, and Seq1
    to cover every padded offset's full window."""
    noff = n1 - n2 + 1
    if noff <= 0:
        raise ValueError("seq2 longer than seq1")
    l2p = round_up(max(n2, 1), L2_ALIGN)
    noff_pad = round_up(noff, TILE_O)
    return noff, noff_pad, l2p, noff_pad + l2p


def bucket_shape(n1: int, n2: int):
    """(l1k, l2p) that keys a (n1, n2) query's bucket in `search_batch`:
    the offsets rounded up to whole BUCKET_O, coarser than the tiles, so
    that queries of nearby lengths share a bucket and a launch; each bucket
    is encoded at `plan_bucket`'s tighter padding."""
    noff, _, l2p, _ = plan_shapes(n1, n2)
    return round_up(noff, BUCKET_O) + l2p, l2p


def plan_bucket(noffs, l2p: int):
    """(noff_pad, l1k) of a bucket for the batched sweeps: the offsets pad
    to the bucket's longest query in whole TILE_O, Seq1 to
    cover every padded offset's full window."""
    noff_pad = round_up(int(np.max(noffs)), TILE_O)
    return noff_pad, noff_pad + l2p


def upload_codes(device, *seqs) -> tuple[torch.Tensor, ...]:
    """Upload (codes, length) sequences, each padded with PAD_CODE to its
    length, as views of one uint8 buffer on `device`: the padding happens on
    the host, so the upload is one copy.  On the card the host buffer is
    pinned and the copy asynchronous (the caching host allocator holds the
    buffer until the stream has run it).  A view starts at the sum of the
    lengths before it: with Seq1 padded to l1k, a multiple of L2_ALIGN on
    every path, Seq2 keeps the sweeps' 16-byte alignment."""
    with spans.span("upload") as sp:
        device = torch.device(device)
        seqs = [(np.asarray(codes), length) for codes, length in seqs]
        for codes, length in seqs:
            if codes.shape[0] > length:
                raise ValueError(f"sequence length {codes.shape[0]} exceeds "
                                 f"padded length {length}")
        ends = np.cumsum([length for _, length in seqs]).tolist()
        starts = [0, *ends[:-1]]
        sp.set(bytes=int(ends[-1]))
        host = torch.empty(ends[-1], dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        buf = host.numpy()
        buf.fill(PAD_CODE)
        for (codes, _), at in zip(seqs, starts):
            buf[at: at + codes.shape[0]] = codes
        dev = (host if device.type == "cpu"
               else host.to(device, non_blocking=True))
        return tuple(dev[a:b] for a, b in zip(starts, ends))


def _build_tag() -> str:
    """Hash of every kernel source and header, so an edit to any rebuilds."""
    h = hashlib.sha256()
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> ctypes.CDLL:
    """Compile every csrc/*.cu with nvcc for sm_90a (one nvcc per source,
    all started together), link them into one plain-C shared library under
    psa_torch/_build named by the sources' hash, and load it.  The
    compilers' output, register and spill counts included, is kept beside
    it as a .log file."""
    global _lib
    if _lib is not None:
        return _lib
    with spans.span("build_library", built=0) as sp:
        _lib = _build_and_load(sp)
    return _lib


def _build_and_load(sp) -> ctypes.CDLL:
    """`build_library`'s work past its cache: the hash, nvcc when the
    library is missing (`sp`'s `built` set to 1), the load and the checks."""
    tag = _build_tag()
    so = _BUILD_DIR / f"libpsa_sweep_{tag}.so"
    if not so.exists():
        sp.set(built=1)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA sweep kernels cannot be built")
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        jobs = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            log.append(f"== {src.name}\n{proc.communicate()[0]}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                                   *(str(obj) for _, obj, _ in jobs)],
                                  capture_output=True, text=True)
            log.append(f"== link\n{proc.stdout}{proc.stderr}")
            if proc.returncode != 0:
                failed.append("link")
        so.with_suffix(".log").write_text("\n".join(log))
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.psa_sweep_v2_launch, lib.psa_sweep_v3_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.psa_sweep_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.psa_sweep_launch.restype = ctypes.c_int
    for fn in (lib.psa_sweep_batched_launch,
               lib.psa_sweep_batched_shared_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.psa_sweep_batched_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.psa_sweep_plan, lib.psa_sweep_v2_plan, lib.psa_sweep_v3_plan):
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.psa_sweep_tile, lib.psa_sweep_warp_tile,
               lib.psa_sweep_align, lib.psa_sweep_seg,
               lib.psa_sweep_mma_tile, lib.psa_sweep_mma_chunk,
               lib.psa_sweep_batched_plan, lib.psa_sweep_plan,
               lib.psa_sweep_v2_plan, lib.psa_sweep_v3_plan,
               lib.psa_epilogue_cols, lib.psa_epilogue_narrow_cols,
               lib.psa_epilogue_params):
        fn.restype = ctypes.c_int
    lib.psa_epilogue_launch.argtypes = [ctypes.c_void_p]   # one int64 block
    lib.psa_epilogue_launch.restype = ctypes.c_int
    lib.psa_epilogue_scratch_words.argtypes = [ctypes.c_int] * 4
    lib.psa_epilogue_scratch_words.restype = ctypes.c_longlong
    lib.psa_error_string.argtypes = [ctypes.c_int]
    lib.psa_error_string.restype = ctypes.c_char_p
    if ((lib.psa_sweep_tile(), lib.psa_sweep_warp_tile(), lib.psa_sweep_align(),
         lib.psa_sweep_seg(), lib.psa_sweep_mma_tile(), lib.psa_sweep_mma_chunk())
            != (TILE_O, WARP_TILE, L2_ALIGN, SEG, MMA_TILE, MMA_CHUNK)):
        raise RuntimeError("csrc tile constants disagree with ops/sweep.py")
    return lib


def _check_operands(**named):
    """Types, contiguity and one device for the sweep's operands."""
    device = None
    for name, (t, dtype) in named.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        device = t.device


def _check_lengths(l1k: int, l2p: int, tile: int = TILE_O,
                   align: int = L2_ALIGN) -> int:
    """noff_pad for Seq1 length l1k and padded Seq2 length l2p, for a kernel
    of `tile` offsets per block and Seq2 padded to `align`."""
    noff_pad = l1k - l2p
    if l2p == 0 or l2p % align or noff_pad <= 0 or noff_pad % tile:
        raise ValueError(f"bad sweep shapes: l1k={l1k}, l2p={l2p} "
                         f"(need l2p % {align} == 0 and "
                         f"(l1k - l2p) % {tile} == 0)")
    return noff_pad


def check_single(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
                 tile: int = TILE_O, align: int = L2_ALIGN):
    """Validate a one-query sweep's operands for a kernel of `tile` offsets
    per block and Seq2 padded to `align`; returns (noff_pad, l2p)."""
    _check_operands(c1=(c1, torch.uint8), c2=(c2, torch.uint8),
                    code=(code, torch.int8))
    if c1.dim() != 1 or c2.dim() != 1 or tuple(code.shape) != (32, 32):
        raise ValueError("expected c1 (l1k,), c2 (l2p,) and code (32, 32)")
    return _check_lengths(c1.shape[0], c2.shape[0], tile, align), c2.shape[0]


def _check_batched(c1: torch.Tensor, c2b: torch.Tensor, code: torch.Tensor,
                   shared: bool):
    """Validate a batched sweep's operands; returns (b, noff_pad)."""
    _check_operands(c1=(c1, torch.uint8), c2b=(c2b, torch.uint8),
                    code=(code, torch.int8))
    want_c1 = 1 if shared else 2
    if (c1.dim() != want_c1 or c2b.dim() != 2 or c2b.shape[0] == 0
            or (not shared and c1.shape[0] != c2b.shape[0])
            or tuple(code.shape) != (32, 32)):
        raise ValueError("expected c1 " + ("(l1k,)" if shared else "(B, l1k)")
                         + ", c2b (B, l2p) with B > 0 and code (32, 32)")
    return c2b.shape[0], _check_lengths(c1.shape[-1], c2b.shape[1])


def _check_aligned(**named):
    """The sweep kernels copy codes with 16-byte bulk copies: every operand
    must start on a 16-byte boundary."""
    for name, t in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the sweep "
                             f"kernels (data_ptr % 16 = {t.data_ptr() % 16})")


class _Walks(Sequence):
    """Per worker of an even split, its steps, each worker's list made when
    it is read, so that a split of millions of steps is never held whole.
    Worker w of W takes the units [w U // W, (w + 1) U // W) of U = items x
    upi units of `unit` positions of Seq2, the units of an item contiguous,
    and walks them in steps of at most SEG positions within one item; a
    step is (item, first position, positions, atomic: the worker does not
    own every unit of the item, first: its first step in the item)."""

    def __init__(self, items: int, upi: int, unit: int, workers: int):
        self.upi, self.unit, self.workers = upi, unit, workers
        self.units = items * upi

    def __len__(self) -> int:
        return self.workers

    def __getitem__(self, w: int) -> list:
        if not 0 <= w < self.workers:
            raise IndexError(w)
        upi, unit = self.upi, self.unit
        begin = w * self.units // self.workers
        end = (w + 1) * self.units // self.workers
        mine, u = [], begin
        while u < end:
            i0 = u - u % upi
            stop = min(end, i0 + upi, u + max(1, SEG // unit))
            mine.append((u // upi, (u - i0) * unit, (stop - u) * unit,
                         not (begin <= i0 and i0 + upi <= end), u in (begin, i0)))
            u = stop
        return mine


def _even_split(items: int, upi: int, unit: int, workers: int,
                split_key: str) -> dict:
    """units, per_worker (the most units one worker takes), `split_key`
    (items with a worker boundary strictly inside them, whose rows their
    workers add atomically) and steps (`_Walks`) of an even split."""
    units = items * upi
    split = {b // upi for b in (w * units // workers for w in range(1, workers))
             if b % upi}
    return {"units": units, "per_worker": -(-units // workers),
            split_key: len(split), "steps": _Walks(items, upi, unit, workers)}


def sweep_plan(noff_pad: int, l2p: int, workers: int) -> dict:
    """The even split of one `sweep` over `workers` workers, as
    csrc/sweep.cu takes it.  The work is U = ceil(noff_pad / WARP_TILE) *
    l2p / L2_ALIGN units of (warp tile, L2_ALIGN positions of Seq2),
    tile-major (a last tile may reach past noff_pad);
    worker w takes the units [w U // W, (w + 1) U // W) and walks them in
    steps of at most SEG positions within one tile.  Returns units,
    per_worker (the most units one worker takes), split_tiles (tiles shared
    between workers, whose rows they add atomically) and steps: per worker
    (made as it is read), its steps as (tile, first position, positions,
    atomic, first step of the worker in the tile)."""
    return _even_split(-(-noff_pad // WARP_TILE), l2p // L2_ALIGN, L2_ALIGN,
                       workers, "split_tiles")


def batched_split_plan(b: int, noff_pad: int, l2p: int, workers: int) -> dict:
    """The even split of one batched launch (`sweep_batched`,
    `sweep_batched_shared`) over `workers` workers, as
    csrc/sweep_batched.cu takes it.  An item is one (warp tile, query),
    item i being query i % b of tile i // b (ceil(noff_pad / WARP_TILE)
    tiles, the last one may reach past noff_pad); an item is one unit where
    Seq2 fits one step (l2p <= SEG: the items are the units, and a range
    of them sweeps one Seq1 window in the shared kernel), else l2p /
    L2_ALIGN units of L2_ALIGN positions.  Worker w takes the units [w U //
    W, (w + 1) U // W) and walks them in steps of at most SEG positions
    within one item.  Returns items, units, per_worker (the most units one
    worker takes), split_items (items shared between workers, whose rows
    they add atomically into an output set to 0 and -1 first) and steps:
    per worker (made as it is read), its steps as (item, first position,
    positions, atomic, first step of the worker in the item)."""
    upi = 1 if l2p <= SEG else l2p // L2_ALIGN
    items = -(-noff_pad // WARP_TILE) * b
    return dict(_even_split(items, upi, l2p // upi, workers, "split_items"),
                items=items)


def sweep_launch_plan(l2p: int, noff_pad: int) -> dict:
    """The split a `sweep` launch of these shapes takes on the current CUDA
    device (csrc/sweep.cu psa_sweep_plan): resident blocks per SM, warp
    workers, units, the most units one worker takes, tiles shared between
    workers, shared bytes per block.  `sweep_plan` with its workers gives
    the same units, per_worker and split_tiles."""
    lib = build_library()
    plan = (ctypes.c_longlong * 6)()
    err = lib.psa_sweep_plan(l2p, noff_pad, plan)
    if err != 0:
        raise RuntimeError("psa_sweep_plan failed: "
                           + lib.psa_error_string(err).decode())
    return dict(zip(("blocks_per_sm", "workers", "units", "per_worker",
                     "split_tiles", "smem_bytes"), plan))


def batched_plan(l2p: int, noff_pad: int, b: int, shared: bool) -> dict:
    """The split a batched launch of these shapes takes on the current CUDA
    device (csrc/sweep_batched.cu psa_sweep_batched_plan): resident blocks
    per SM, blocks, workers (a block each), items ((tile, query) pairs),
    units, the
    most units one worker takes, items shared between workers (> 0: the
    output is set first and their rows added atomically), shared bytes per
    block.  `batched_split_plan` with its workers gives the same items,
    units, per_worker and split_items."""
    lib = build_library()
    plan = (ctypes.c_longlong * 8)()
    err = lib.psa_sweep_batched_plan(l2p, noff_pad, b, int(shared), plan)
    if err != 0:
        raise RuntimeError("psa_sweep_batched_plan failed: "
                           + lib.psa_error_string(err).decode())
    return dict(zip(("blocks_per_sm", "blocks", "workers", "items", "units",
                     "per_worker", "split_items", "smem_bytes"), plan))


def launch(entry: str, c1: torch.Tensor, c2: torch.Tensor,
           code: torch.Tensor, out_shape: tuple, *extra):
    """Run the kernel behind C entry point `entry` on c1's device and
    current stream into a new int32 `out_shape` tensor; `extra` are the
    entry point's arguments between the output's width and the stream (the
    batched sweeps' B, the offset sweeps' counters pointer)."""
    lib = build_library()
    out = torch.empty(out_shape, dtype=torch.int32, device=c1.device)
    with torch.cuda.device(c1.device):
        stream = torch.cuda.current_stream(c1.device).cuda_stream
        err = getattr(lib, entry)(c1.data_ptr(), c1.shape[-1], c2.data_ptr(),
                                  c2.shape[-1], code.data_ptr(),
                                  out.data_ptr(), out_shape[-1], *extra,
                                  stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.psa_error_string(err).decode())
    return out


def rank_counters(device) -> torch.Tensor | None:
    """A zeroed (2,) int64 buffer on `device` that a sweep launch given it
    as `counters` adds [threshold passes, steps] to (each worker once,
    at its end): passes over steps is 1 where every offset of a tile met
    the table's top rank in every step.  None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.zeros(2, dtype=torch.int64, device=device)


def _pointer(t: torch.Tensor | None):
    """A tensor's device address for a C entry point; None (null) for no
    tensor."""
    return None if t is None else t.data_ptr()


def rank_passes_pm(counts) -> int | None:
    """1000 x threshold passes a step from a fetched `rank_counters`
    buffer ([passes, steps]); None before any step."""
    passes, steps = (int(x) for x in counts)
    return round(1000 * passes / steps) if steps else None


def sweep(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
          counters: torch.Tensor | None = None) -> torch.Tensor:
    """(5, noff_pad) int32 stats5 of one query: rows 0-3 the class counts,
    row 4 the maxrank.

    c1: (noff_pad + l2p,) uint8 codes; c2: (l2p,) uint8 codes; code: (32, 32)
    int8 fused table; noff_pad a multiple of TILE_O.  CUDA tensors go
    through the Hopper kernel (replacing _sweep_kernel and the maxrank
    conversion), which needs 16-byte aligned operands and adds its
    threshold passes and steps to `counters` (`rank_counters`) when given;
    CPU tensors through `sweep_plain`."""
    global launches
    noff_pad, _ = check_single(c1, c2, code)
    if c1.device.type == "cpu":
        return sweep_plain(c1, c2, code)
    if c1.device.type != "cuda":
        raise ValueError(f"no sweep for device {c1.device}")
    _check_aligned(c1=c1, c2=c2)
    out = launch("psa_sweep_launch", c1, c2, code, (5, noff_pad),
                 _pointer(counters))
    launches += 1
    return out


def sweep_batched(c1b: torch.Tensor, c2b: torch.Tensor,
                  code: torch.Tensor,
                  counters: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 5, noff_pad) int32 stats5 of B queries, each with its own Seq1
    row: rows 0-3 the class counts, row 4 the maxrank.  c1b (B, noff_pad +
    l2p) and c2b (B, l2p) uint8, PAD_CODE past each sequence; noff_pad a
    multiple of TILE_O.  CUDA tensors go through the Hopper kernel
    (replacing _sweep_kernel_batched and the maxrank conversion), which
    needs 16-byte aligned operands (`counters` as in `sweep`); CPU tensors
    through `sweep_batched_plain`."""
    global launches_batched
    b, noff_pad = _check_batched(c1b, c2b, code, shared=False)
    if c1b.device.type == "cpu":
        return sweep_batched_plain(c1b, c2b, code)
    if c1b.device.type != "cuda":
        raise ValueError(f"no sweep for device {c1b.device}")
    _check_aligned(c1b=c1b, c2b=c2b)
    out = launch("psa_sweep_batched_launch", c1b, c2b, code,
                 (b, 5, noff_pad), b, _pointer(counters))
    launches_batched += 1
    return out


def sweep_batched_shared(c1: torch.Tensor, c2b: torch.Tensor,
                         code: torch.Tensor,
                         counters: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 5, noff_pad) int32: `sweep_batched` for B queries that share the
    one Seq1 row c1 (noff_pad + l2p,); equal to `sweep_batched` on B
    broadcast copies of it.  CUDA tensors go through the Hopper kernel
    (replacing _sweep_kernel_batched_shared and the maxrank conversion),
    CPU tensors through `sweep_batched_shared_plain`."""
    global launches_batched_shared
    b, noff_pad = _check_batched(c1, c2b, code, shared=True)
    if c1.device.type == "cpu":
        return sweep_batched_shared_plain(c1, c2b, code)
    if c1.device.type != "cuda":
        raise ValueError(f"no sweep for device {c1.device}")
    _check_aligned(c1=c1, c2b=c2b)
    out = launch("psa_sweep_batched_shared_launch", c1, c2b, code,
                 (b, 5, noff_pad), b, _pointer(counters))
    launches_batched_shared += 1
    return out


def _stats_from_codevals(codeval: torch.Tensor):
    """Fused code values (..., n2) -> (counts (..., 4) int32, max code
    (...,) int32); 0 = inert.  engine_xla.stats_from_codevals with the max
    kept as a code, the kernel's row 4."""
    valid = codeval > 0
    cls = torch.where(valid, (codeval - 1) & 3, torch.full_like(codeval, -1))
    counts = torch.stack([(cls == k).sum(-1, dtype=torch.int32)
                          for k in range(4)], dim=-1)
    return counts, codeval.amax(-1).to(torch.int32)


def sweep_rows_plain(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
                     max_elems: int = 1 << 22, tile: int = TILE_O,
                     align: int = L2_ALIGN) -> torch.Tensor:
    """The TPU kernel's (8, noff_pad) rows in plain PyTorch, on any device:
    gather each block of offsets' Seq1 windows, look the pairs up in the
    table, decode.  `max_elems` bounds one block's (offsets x l2p) gather;
    `tile` and `align` are the padding of the kernel it stands for."""
    noff_pad, l2p = check_single(c1, c2, code, tile, align)
    dev = c1.device
    code_flat = code.reshape(-1).to(torch.int32)
    c1l = c1.long()
    c2l = c2.long()
    pos = torch.arange(l2p, device=dev)
    rows = max(1, max_elems // l2p)
    out = torch.zeros((8, noff_pad), dtype=torch.int32, device=dev)
    for o in range(0, noff_pad, rows):
        offs = torch.arange(o, min(o + rows, noff_pad), device=dev)
        win = c1l[offs[:, None] + pos[None, :]]
        counts, maxcode = _stats_from_codevals(code_flat[win * 32 + c2l[None, :]])
        out[:4, o: o + offs.shape[0]] = counts.T
        out[4, o: o + offs.shape[0]] = maxcode
    return out


def sweep_plain(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
                max_elems: int = 1 << 22) -> torch.Tensor:
    """The plain PyTorch version of `sweep`, on any device:
    `stats5_from_sweep` of `sweep_rows_plain`."""
    return stats5_from_sweep(sweep_rows_plain(c1, c2, code, max_elems))


def sweep_batched_plain(c1b: torch.Tensor, c2b: torch.Tensor,
                        code: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `sweep_batched`: `stats5_from_sweep` of
    `sweep_rows_plain` row by row."""
    _check_batched(c1b, c2b, code, shared=False)
    return stats5_from_sweep(torch.stack(
        [sweep_rows_plain(c1b[q], c2b[q], code) for q in range(c2b.shape[0])]))


def sweep_batched_shared_plain(c1: torch.Tensor, c2b: torch.Tensor,
                               code: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `sweep_batched_shared`:
    `stats5_from_sweep` of `sweep_rows_plain` of the one Seq1 row against
    each Seq2 row."""
    _check_batched(c1, c2b, code, shared=True)
    return stats5_from_sweep(torch.stack(
        [sweep_rows_plain(c1, c2b[q], code) for q in range(c2b.shape[0])]))


def maxrank_from_maxcode(maxcode):
    """rank = ((code-1) >> 2) - 1, clamped to -1 for 'no substitution'."""
    if isinstance(maxcode, np.ndarray):
        return np.maximum(((maxcode - 1) >> 2) - 1, -1)
    return torch.clamp(((maxcode - 1) >> 2) - 1, min=-1)


def stats5_from_sweep(out: torch.Tensor) -> torch.Tensor:
    """(..., 8, noff_pad) sweep output -> (..., 5, noff_pad) int32 stats:
    rows 0-3 class counts, row 4 maxrank."""
    return torch.cat([out[..., :4, :], maxrank_from_maxcode(out[..., 4:5, :])],
                     dim=-2)


def stats_via(sweep_fn, plan, codes1: np.ndarray, codes2: np.ndarray,
              tables: ScoringTables, device):
    """(counts (noff, 4) int32, maxrank (noff,) int32) on the host from the
    stats5 that `sweep_fn` returns on `device` for the codes padded as
    `plan(n1, n2)` says."""
    codes1 = np.asarray(codes1)
    codes2 = np.asarray(codes2)
    noff, _, l2p, l1k = plan(codes1.shape[0], codes2.shape[0])
    code = torch.from_numpy(np.ascontiguousarray(tables.code)).to(device)
    out = sweep_fn(*upload_codes(device, (codes1, l1k), (codes2, l2p)), code)
    st = out[:, :noff].cpu().numpy()
    return st[:4].T.copy(), st[4].copy()


def offset_stats(codes1: np.ndarray, codes2: np.ndarray,
                 tables: ScoringTables, device):
    """Per-offset (counts (noff, 4) int32, maxrank (noff,) int32) on the
    host, computed on `device` — offset_stats_pallas' counterpart.  Any Seq1
    length takes the same kernel."""
    return stats_via(sweep, plan_shapes, codes1, codes2, tables, device)
