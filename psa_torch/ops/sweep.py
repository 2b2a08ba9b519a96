"""The offset sweep: the CUDA kernel's wrapper, its plain PyTorch version,
shape planning, and `offset_stats`.

For each offset o of Seq2 under Seq1 the sweep reads the fused code
CODE[s1[o+i], s2[i]] at every position i and returns, per offset, the exact
counts of the four sign classes and the largest fused code (which encodes
the best substitution rank).  Output layout, shared with the TPU kernel
(psa_tpu/ops/pallas_sweep.py::_sweep_kernel): (8, noff_pad) int32, rows 0-3
the class counts, row 4 the max code (0 = no substitution anywhere), rows
5-7 zero.

`sweep` launches the hand-written Hopper kernel (csrc/sweep.cu) for CUDA
tensors and runs `sweep_plain` — the blocked gather of the JAX package's
engine_xla, in torch — for CPU tensors.  A failed build or launch raises;
nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from psa_torch.core.alphabet import PAD_CODE
from psa_torch.core.tables import ScoringTables
from psa_torch.ops.common import round_up

TILE_O = 1024    # offsets per thread block (csrc/sweep.cu kTile)
L2_ALIGN = 32    # Seq2 padding granularity (csrc/sweep.cu kFlush)

# Kernel launches made by `sweep`: a plain integer a caller can zero and read
# to show that a path went through the kernel.
launches = 0

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "sweep.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib = None


def plan_shapes(n1: int, n2: int):
    """(noff, noff_pad, l2p, l1k) for a (n1, n2) query: Seq2 pads to the
    kernel's flush granularity, the offsets to whole thread-block tiles, and
    Seq1 to cover every padded offset's full window."""
    noff = n1 - n2 + 1
    if noff <= 0:
        raise ValueError("seq2 longer than seq1")
    l2p = round_up(max(n2, 1), L2_ALIGN)
    noff_pad = round_up(noff, TILE_O)
    return noff, noff_pad, l2p, noff_pad + l2p


def upload_codes(codes: np.ndarray, length: int, device) -> torch.Tensor:
    """Codes padded with PAD_CODE to `length` as a uint8 tensor on `device`:
    the padding happens on the host, so the upload is one copy."""
    codes = np.asarray(codes)
    if codes.shape[0] > length:
        raise ValueError(f"sequence length {codes.shape[0]} exceeds padded length {length}")
    buf = np.full(length, PAD_CODE, np.uint8)
    buf[: codes.shape[0]] = codes
    return torch.from_numpy(buf).to(device)


def build_library() -> ctypes.CDLL:
    """Compile csrc/sweep.cu with nvcc for sm_90a into a plain-C shared
    library under psa_torch/_build (named by the source's hash, so an edit
    rebuilds) and load it.  The compiler's output, register and spill counts
    included, is kept beside it as a .log file."""
    global _lib
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"libpsa_sweep_{tag}.so"
    if not so.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA sweep kernel cannot be built")
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.psa_sweep_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.psa_sweep_launch.restype = ctypes.c_int
    lib.psa_sweep_tile.restype = ctypes.c_int
    lib.psa_sweep_align.restype = ctypes.c_int
    lib.psa_error_string.argtypes = [ctypes.c_int]
    lib.psa_error_string.restype = ctypes.c_char_p
    if (lib.psa_sweep_tile(), lib.psa_sweep_align()) != (TILE_O, L2_ALIGN):
        raise RuntimeError("csrc/sweep.cu tile constants disagree with ops/sweep.py")
    _lib = lib
    return lib


def _check(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor):
    """Validate the sweep's operands; returns (noff_pad, l2p)."""
    for name, t, dtype in (("c1", c1, torch.uint8), ("c2", c2, torch.uint8),
                           ("code", code, torch.int8)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != c1.device:
            raise ValueError(f"{name} is on {t.device}, c1 on {c1.device}")
    if c1.dim() != 1 or c2.dim() != 1 or tuple(code.shape) != (32, 32):
        raise ValueError("expected c1 (l1k,), c2 (l2p,) and code (32, 32)")
    l2p = c2.shape[0]
    noff_pad = c1.shape[0] - l2p
    if l2p == 0 or l2p % L2_ALIGN or noff_pad <= 0 or noff_pad % TILE_O:
        raise ValueError(f"bad sweep shapes: l1k={c1.shape[0]}, l2p={l2p} "
                         f"(need l2p % {L2_ALIGN} == 0 and "
                         f"(l1k - l2p) % {TILE_O} == 0)")
    return noff_pad, l2p


def sweep(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """(8, noff_pad) int32 sweep statistics (see the module docstring).

    c1: (noff_pad + l2p,) uint8 codes; c2: (l2p,) uint8 codes; code: (32, 32)
    int8 fused table.  Codes must be < 32.  CUDA tensors go through the
    Hopper kernel, CPU tensors through `sweep_plain`."""
    global launches
    noff_pad, l2p = _check(c1, c2, code)
    if c1.device.type == "cpu":
        return sweep_plain(c1, c2, code)
    if c1.device.type != "cuda":
        raise ValueError(f"no sweep for device {c1.device}")
    lib = build_library()
    out = torch.empty((8, noff_pad), dtype=torch.int32, device=c1.device)
    with torch.cuda.device(c1.device):
        stream = torch.cuda.current_stream(c1.device).cuda_stream
        err = lib.psa_sweep_launch(c1.data_ptr(), c1.shape[0], c2.data_ptr(),
                                   l2p, code.data_ptr(), out.data_ptr(),
                                   noff_pad, stream)
    if err != 0:
        raise RuntimeError("sweep kernel launch failed: "
                           + lib.psa_error_string(err).decode())
    launches += 1
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


def sweep_plain(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor,
                max_elems: int = 1 << 22) -> torch.Tensor:
    """The plain PyTorch version of `sweep`, on any device: gather each
    block of offsets' Seq1 windows, look the pairs up in the table, decode.
    `max_elems` bounds one block's (offsets x l2p) gather."""
    noff_pad, l2p = _check(c1, c2, code)
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


def maxrank_from_maxcode(maxcode):
    """rank = ((code-1) >> 2) - 1, clamped to -1 for 'no substitution'."""
    if isinstance(maxcode, np.ndarray):
        return np.maximum(((maxcode - 1) >> 2) - 1, -1)
    return torch.clamp(((maxcode - 1) >> 2) - 1, min=-1)


def stats5_from_sweep(out: torch.Tensor) -> torch.Tensor:
    """(8, noff_pad) sweep output -> (5, noff_pad) int32 stats: rows 0-3
    class counts, row 4 maxrank."""
    return torch.cat([out[:4], maxrank_from_maxcode(out[4:5])], dim=0)


def offset_stats(codes1: np.ndarray, codes2: np.ndarray,
                 tables: ScoringTables, device):
    """Per-offset (counts (noff, 4) int32, maxrank (noff,) int32) on the
    host, computed on `device` — offset_stats_pallas' counterpart.  Any Seq1
    length takes the same kernel."""
    codes1 = np.asarray(codes1)
    codes2 = np.asarray(codes2)
    noff, _, l2p, l1k = plan_shapes(codes1.shape[0], codes2.shape[0])
    code = torch.from_numpy(np.ascontiguousarray(tables.code)).to(device)
    out = sweep(upload_codes(codes1, l1k, device),
                upload_codes(codes2, l2p, device), code)
    st = stats5_from_sweep(out)[:, :noff].cpu().numpy()
    return st[:4].T.copy(), st[4].copy()
