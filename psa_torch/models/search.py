"""The single-query alignment search engine.

Replaces the reference's orchestration stack (main.c:13-56 ->
cpu_funcs.c:25-218): compute per-offset integer statistics, select the exact
winner on the host.

Backends (both share the same output contract — see ops/select.py):

* ``torch`` — the device path: the CUDA sweep kernel, the top-k epilogue on
              the device, one fetch, exact host selection (models/batch.py).
              Runs on the card; `device="cpu"` runs the same path with the
              kernel's plain PyTorch version.
* ``numpy`` — vectorized host oracle (core/oracle.py); exact, runs anywhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from psa_torch.core.alphabet import encode, validate
from psa_torch.core.oracle import offset_stats_numpy
from psa_torch.core.result import NoMutationFound, SearchResult
from psa_torch.core.tables import (ScoringTables, build_tables_cached,
                                   device_tables)
from psa_torch.ops.select import select_best

_BACKENDS = ("torch", "numpy")


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  With no GPU present this raises: an entry
    point runs on the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the host")
        device = "cuda"
    return torch.device(device)


class AlignmentSearchEngine:
    """Searches every (offset, position, substitution) triple for the best
    single-character mutation of seq2 aligned under seq1."""

    def __init__(self, weights: Sequence[float], is_max: bool,
                 backend: str = "torch", strict_alphabet: bool = True,
                 device=None):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {_BACKENDS}")
        self.tables: ScoringTables = build_tables_cached(
            np.asarray(weights, np.float64), is_max)
        self.backend = backend
        self.strict_alphabet = strict_alphabet
        self.device = resolve_device(device) if backend == "torch" else None
        self._dtabs = None

    def _device_tables(self):
        if self._dtabs is None:
            self._dtabs = device_tables(self.tables, self.device)
        return self._dtabs

    def offset_stats(self, codes1: np.ndarray, codes2: np.ndarray):
        """Per-offset (counts (noff,4) int32, maxrank (noff,) int32)."""
        if self.backend == "numpy":
            return offset_stats_numpy(codes1, codes2, self.tables)
        from psa_torch.ops.sweep import offset_stats

        return offset_stats(codes1, codes2, self.tables, self.device)

    def search_codes(self, codes1: np.ndarray, codes2: np.ndarray) -> SearchResult:
        codes1 = np.asarray(codes1, dtype=np.int32)
        codes2 = np.asarray(codes2, dtype=np.int32)
        if codes2.shape[0] > codes1.shape[0]:
            raise ValueError("seq2 must not be longer than seq1")
        if self.backend == "torch":
            return self._device_exact(codes1, codes2)
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

    def search(self, seq1: str, seq2: str) -> SearchResult:
        if self.strict_alphabet and not (validate(seq1) and validate(seq2)):
            raise ValueError(
                "sequences must contain only A-Z and '-' "
                "(pass strict_alphabet=False to accept reference-UB inputs)"
            )
        return self.search_codes(encode(seq1), encode(seq2))


def search(seq1: str, seq2: str, weights: Sequence[float], is_max: bool,
           backend: str = "torch", device=None) -> SearchResult:
    """One-shot convenience wrapper."""
    return AlignmentSearchEngine(weights, is_max, backend=backend,
                                 device=device).search(seq1, seq2)
