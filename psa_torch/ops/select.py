"""Exact winner selection from per-offset integer statistics.

The sweep returns, per offset, exact integer sign-class counts and the best
substitution rank.  This module reconstructs exact f64 totals on the host
and applies the reference's canonical tie-break (cuda_funcs.cu:290-307):

    best score -> lowest offset -> lowest char position -> alphabetically
    first substitute (the last two are baked into rank construction and the
    winner-offset rescan).

The reference accumulates its per-offset f64 score *sequentially*
(cpu_funcs.c:278), while these totals come from grouped integer counts; the
two f64 roundings of the same exact sum differ by at most a bound
proportional to n2*ulp (see `candidate_epsilon`).  Every offset within that
bound of the grouped best is re-scored in the reference's sequential order
(the native library's `rescore_batch_native` when it builds, else the numpy
`rescore_candidates`, vectorized over candidates; the two agree bit for
bit), so the final winner and the printed score are bit-identical to the
reference.
"""

from __future__ import annotations

import sys

import numpy as np

from psa_torch import native
from psa_torch.config import CONFIG
from psa_torch.core.oracle import rescore_candidates
from psa_torch.core.result import NoMutationFound, SearchResult
from psa_torch.core.tables import ScoringTables
from psa_torch.utils import spans


def candidate_epsilon(tables: ScoringTables, n2):
    """Sound bound on |sequential f64 total - grouped f64 total|.

    Both totals round the same exact rational value; a sequential sum of n2
    terms each bounded by max|w| (plus one substitution delta bounded by
    max|diff|) carries error <= n2 * eps_m * S where S bounds the running
    absolute sum; the grouped side adds a handful of ulps.  The factor 4 is
    headroom.  An offset outside this band of the grouped best cannot win
    under sequential semantics, so the candidate set is provably complete.
    """
    max_w = float(np.max(np.abs(tables.w_signed))) if np.any(n2) else 0.0
    max_d = float(np.max(np.abs(tables.diff_vals))) if tables.diff_vals.size else 0.0
    n2 = np.asarray(n2, np.float64)
    s_bound = n2 * max_w + max_d
    return 4.0 * (n2 + 8) * np.finfo(np.float64).eps * np.maximum(s_bound, 1.0)


def totals_from_stats(counts: np.ndarray, maxrank: np.ndarray,
                      tables: ScoringTables) -> np.ndarray:
    """Exact f64 post-substitution totals per offset (+-inf where no sub)."""
    score = tables.score_from_counts(counts)
    bad = -np.inf if tables.is_max else np.inf
    diffv = np.where(maxrank >= 0, tables.diff_vals[np.clip(maxrank, 0, None)], bad)
    return score + diffv


def select_best(counts: np.ndarray, maxrank: np.ndarray, tables: ScoringTables,
                codes1: np.ndarray, codes2: np.ndarray,
                noff: int | None = None) -> SearchResult:
    """Pick the winning (offset, char_offset, substitute) triple.

    `counts`/`maxrank` may be padded beyond the true offset count; pass `noff`
    to mask the padding.
    """
    counts = np.asarray(counts)
    maxrank = np.asarray(maxrank)
    n_rows = maxrank.shape[0]
    if noff is None:
        noff = n_rows
    valid = np.zeros(n_rows, dtype=bool)
    valid[:noff] = maxrank[:noff] >= 0
    if not valid.any():
        raise NoMutationFound("no offset admits a legal substitution")

    totals = totals_from_stats(counts, maxrank, tables)
    totals = np.where(valid, totals, -np.inf if tables.is_max else np.inf)

    best = totals.max() if tables.is_max else totals.min()
    eps = candidate_epsilon(tables, int(codes2.shape[0]))
    cand = np.nonzero(np.abs(totals - best) <= eps)[0]
    if cand.shape[0] > CONFIG.max_candidates:
        print(f"psa: note: {cand.shape[0]} near-tied offsets re-scored "
              "sequentially for exact tie-breaking", file=sys.stderr)

    return pick_from_candidates(codes1, codes2, tables, cand)


def pick_from_candidates(codes1: np.ndarray, codes2: np.ndarray,
                         tables: ScoringTables,
                         cand: np.ndarray) -> SearchResult:
    """Exact winner among candidate offsets (ascending order required).

    Re-scores every candidate with the reference's sequential f64 semantics
    (cpu_funcs.c:257-300); the first bit-equal best total is the is_swapable
    winner (cuda_funcs.cu:290-307: strictly better, else lowest offset).
    The native re-scorer makes one call for the whole list; the numpy one
    takes n2 vectorised steps (~20 us each of interpreter overhead).
    """
    rescore = (native.rescore_batch_native if native.available()
               else rescore_candidates)
    with spans.span("rescore", candidates=int(len(cand))):
        seq_totals, coffs, subs = rescore(codes1, codes2, tables, cand)
    ok = coffs >= 0
    seq_totals = np.where(ok, seq_totals, -np.inf if tables.is_max else np.inf)
    if not ok.any():
        raise NoMutationFound("no offset admits a legal substitution")
    best_total = seq_totals.max() if tables.is_max else seq_totals.min()
    w = int(np.nonzero(seq_totals == best_total)[0][0])
    return SearchResult(offset=int(cand[w]), char_offset=int(coffs[w]),
                        sub_code=int(subs[w]), score=float(best_total))
