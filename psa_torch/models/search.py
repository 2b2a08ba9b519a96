"""The single-query alignment search engine.

Replaces the reference's orchestration stack (main.c:13-56 ->
cpu_funcs.c:25-218): compute per-offset integer statistics, select the exact
winner on the host.

Backends (all share the same output contract — see ops/select.py):

* ``torch``  — the device path: the CUDA sweep kernel, the top-k epilogue on
               the device, one fetch, exact host selection (models/batch.py).
               Runs on the card; `device="cpu"` runs the same path with the
               kernel's plain PyTorch version.  The default.
* ``numpy``  — vectorized host oracle (core/oracle.py); exact, runs anywhere.
* ``native`` — the C++/OpenMP host engine (psa_torch/native), the
               reference's semantics at native speed; needs no device, and
               raises when the library cannot be built.
* ``auto``   — per query: `native` below `CONFIG.auto_threshold` pair-evals
               (when the library builds), else `torch` — the reference's
               CPU/GPU crossover (cpu_funcs.c:135-142).  Its device is
               resolved like `torch`'s: without a card it raises rather than
               turning to the host.
* ``hybrid`` — one query split between the two: the device takes the first
               `device_share` % of offsets, the native engine the rest at
               the same time, and the winners merge under the canonical
               tie-break — the reference's cuda_percentage split
               (cpu_funcs.c:144-150).
* ``xla``    — the chunked gather engine (ops/engine_xla.py): plain torch
               indexing on the device, the full stats fetched, then exact
               host selection; the differential reference of ``torch``.
* ``conv``   — the one-hot convolution engine (ops/engine_conv.py): one
               f32 conv1d on the device, checked exact, then the same
               selection.
Both take their device as ``torch`` does: the card unless
`device="cpu"`.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from psa_torch import native
from psa_torch.config import CONFIG
from psa_torch.core.alphabet import encode_checked
from psa_torch.core.oracle import offset_stats_numpy
from psa_torch.core.result import NoMutationFound, SearchResult
from psa_torch.core.tables import (ScoringTables, build_tables_cached,
                                   device_tables)
from psa_torch.ops.select import select_best
from psa_torch.utils import spans

_BACKENDS = ("torch", "numpy", "native", "auto", "hybrid", "xla", "conv")
# the backends that run on a device (the rest run on the host)
DEVICE_BACKENDS = ("torch", "auto", "hybrid", "xla", "conv")


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  With no GPU present this raises: an entry
    point runs on the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the host")
        device = "cuda"
    return torch.device(device)


def native_available() -> bool:
    """True when the C++ host engine builds (g++ present) and self-tests."""
    return native.available()


def pair_evals(n1: int, n2: int) -> int:
    """(offset, position) pairs a query of these lengths sweeps."""
    return max(n1 - n2 + 1, 0) * n2


def resolve_auto(n1: int, n2: int) -> str:
    """The backend `auto` takes for one query: `native` below
    `CONFIG.auto_threshold` pair-evals when the library builds, else
    `torch`.  Unlike the JAX package's, it never picks the host because no
    accelerator is present: `auto`'s device is resolved, and checked, when
    the engine is made."""
    if pair_evals(n1, n2) < CONFIG.auto_threshold and native_available():
        return "native"
    return "torch"


class AlignmentSearchEngine:
    """Searches every (offset, position, substitution) triple for the best
    single-character mutation of seq2 aligned under seq1."""

    def __init__(self, weights: Sequence[float], is_max: bool,
                 backend: str = "torch", strict_alphabet: bool = True,
                 device=None, nthreads: int = 0,
                 device_share: float | None = None):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {_BACKENDS}")
        self.tables: ScoringTables = build_tables_cached(
            np.asarray(weights, np.float64), is_max)
        self.backend = backend
        self.strict_alphabet = strict_alphabet
        self.device = (resolve_device(device) if backend in DEVICE_BACKENDS
                       else None)
        if backend == "native":
            native.get_lib()        # raises when the library cannot be built
        # native-engine thread count; 0 = all cores, 1 = the reference's
        # sequential oracle mode (`make runseq`)
        self.nthreads = nthreads
        # hybrid: percentage of offsets the device takes (main.c:30-42
        # cuda_percentage); None = all-device at or above the auto
        # threshold, all-host below it
        self.device_share = device_share
        self._dtabs = None

    def _device_tables(self):
        if self._dtabs is None:
            self._dtabs = device_tables(self.tables, self.device)
        return self._dtabs

    def _resolve_backend(self, codes1: np.ndarray, codes2: np.ndarray) -> str:
        if self.backend != "auto":
            return self.backend
        return resolve_auto(codes1.shape[0], codes2.shape[0])

    def offset_stats(self, codes1: np.ndarray, codes2: np.ndarray):
        """Per-offset (counts (noff,4) int32, maxrank (noff,) int32)."""
        backend = self._resolve_backend(codes1, codes2)
        if backend == "hybrid":
            # stats cover the whole range; the split shapes only the winner
            # search, so the host engine serves them
            backend = "native" if native_available() else "numpy"
        if backend == "numpy":
            return offset_stats_numpy(codes1, codes2, self.tables)
        if backend == "native":
            return native.offset_stats_native(codes1, codes2, self.tables)
        if backend == "xla":
            from psa_torch.ops.engine_xla import offset_stats_xla

            return offset_stats_xla(codes1, codes2, self.tables, self.device)
        if backend == "conv":
            from psa_torch.ops.engine_conv import offset_stats_conv

            return offset_stats_conv(codes1, codes2, self.tables, self.device)
        from psa_torch.ops.sweep import offset_stats

        return offset_stats(codes1, codes2, self.tables, self.device)

    def search_codes(self, codes1: np.ndarray, codes2: np.ndarray) -> SearchResult:
        """Search encoded sequences: int32 codes (`encode`) or the kernels'
        uint8 (`encode_checked`), which the device path uploads as they
        are."""
        codes1, codes2 = np.asarray(codes1), np.asarray(codes2)
        if codes2.shape[0] > codes1.shape[0]:
            raise ValueError("seq2 must not be longer than seq1")
        backend = self._resolve_backend(codes1, codes2)
        if backend == "torch":
            return self._device_exact(codes1, codes2)
        # the host engines and the differential ones read int32 codes
        codes1 = codes1.astype(np.int32, copy=False)
        codes2 = codes2.astype(np.int32, copy=False)
        if backend == "native":
            # the native engine applies the reference's sequential semantics
            # directly: no separate selection pass
            return native.search_native(codes1, codes2, self.tables,
                                        nthreads=self.nthreads)
        if backend == "hybrid":
            return self._search_hybrid(codes1, codes2)
        counts, maxrank = self.offset_stats(codes1, codes2)
        noff = codes1.shape[0] - codes2.shape[0] + 1
        return select_best(np.asarray(counts), np.asarray(maxrank),
                           self.tables, codes1, codes2, noff=noff)

    def _device_exact(self, codes1: np.ndarray, codes2: np.ndarray) -> SearchResult:
        """Device search via the checkable-exact top-k epilogue: one upload
        per sequence, one fetch of ~800 bytes, host selection over <= k
        candidates.  Any Seq1 length takes the same kernel."""
        from psa_torch.models.batch import search_exact

        res = search_exact(codes1, codes2, self._device_tables())
        if res is None:
            raise NoMutationFound("no offset admits a legal substitution")
        return res

    def _search_hybrid(self, codes1: np.ndarray, codes2: np.ndarray) -> SearchResult:
        """One query split between the device and the host at the same time
        (cpu_funcs.c:144-150): the device takes offsets [0, split), the
        native engine [split, noff) in a thread (the ctypes call releases
        the GIL), and the two winners merge under is_swapable
        (cuda_funcs.cu:290-307): the better score, else the lower offset,
        which the device block always holds.  Both sides produce
        sequentially re-scored f64 totals, so the merge compares exact
        values."""
        n2 = codes2.shape[0]
        noff = codes1.shape[0] - n2 + 1
        share = self.device_share
        if share is None:
            share = (100.0 if pair_evals(codes1.shape[0], n2) >= CONFIG.auto_threshold
                     else 0.0)
        split = min(max(int(round(noff * share / 100.0)), 0), noff)
        if split < noff and not native_available():
            raise RuntimeError(
                "the hybrid backend needs the native host engine (g++) for "
                "its host block; use backend='torch' or device_share=100")
        if split == 0:
            return native.search_native(codes1, codes2, self.tables,
                                        nthreads=self.nthreads)

        host_out: list = [None, None]          # [result, exception]

        def host_block():
            try:
                host_out[0] = native.search_native(
                    codes1, codes2, self.tables, nthreads=self.nthreads,
                    first_offset=split, last_offset=noff)
            except NoMutationFound:
                pass
            except Exception as e:  # noqa: BLE001 - re-raised below
                host_out[1] = e

        thread = None
        if split < noff:
            thread = threading.Thread(target=host_block, daemon=True)
            thread.start()
        try:
            # the device block needs only the Seq1 prefix of offsets
            # [0, split), whose offsets are the global ones
            dev = self._device_exact(codes1[: split + n2 - 1], codes2)
        except NoMutationFound:
            dev = None
        finally:
            if thread is not None:
                thread.join()
        if host_out[1] is not None:
            raise host_out[1]
        host = host_out[0]
        if dev is None and host is None:
            raise NoMutationFound("no offset admits a legal substitution")
        if host is None:
            return dev
        if dev is None:
            return host
        host_better = (host.score > dev.score if self.tables.is_max
                       else host.score < dev.score)
        return host if host_better else dev

    def search(self, seq1: str, seq2: str) -> SearchResult:
        """Each string is encoded once (`encode_checked`); in strict mode
        the alphabet check reads that pass's flags."""
        strict = self.strict_alphabet
        with spans.span("search"):
            with spans.span("encode", checked=int(strict)):
                codes1, ok1 = encode_checked(seq1)
                codes2, ok2 = encode_checked(seq2)
            if strict:
                with spans.span("validate"):
                    if not (ok1 and ok2):
                        raise ValueError(
                            "sequences must contain only A-Z and '-' "
                            "(pass strict_alphabet=False to accept "
                            "reference-UB inputs)")
            return self.search_codes(codes1, codes2)


def search(seq1: str, seq2: str, weights: Sequence[float], is_max: bool,
           backend: str = "torch", device=None) -> SearchResult:
    """One-shot convenience wrapper."""
    return AlignmentSearchEngine(weights, is_max, backend=backend,
                                 device=device).search(seq1, seq2)
