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
bound of the grouped best is re-scored in the reference's sequential order,
so the final winner and the printed score are bit-identical to the
reference.

Every path selects in the same two steps: `band_candidates` (rows of
fetched statistics -> the candidates in the band, grouped by row, offsets
ascending) and `pick_rows` (one re-score of every candidate -> each row's
winner).  The single query's `host_select` and the batch's `_host_select`
(models/batch.py), the sharded merge `_select_from_shard_topk`
(parallel/mesh.py) and `select_best` (every offset's statistics, one row)
differ only in the rows they hand over.
"""

from __future__ import annotations

import sys

import numpy as np

from psa_torch import native
from psa_torch.config import CONFIG
from psa_torch.core.oracle import rescore_multi
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


def band_candidates(offsets: np.ndarray, stats: np.ndarray, noffs, n2s,
                    tables: ScoringTables):
    """The candidates of R rows of fetched statistics -> (rows, offsets).

    offsets (R, m) and stats (R, m, 5) hold m (offset, counts, maxrank)
    entries a row; an entry counts only inside its row's noffs and with a
    legal substitution.  It is a candidate when its exact f64 total lies
    within `candidate_epsilon` (at the row's n2s) of the row's best.  The
    candidates come back grouped by row, offsets ascending within a row:
    the order in which `pick_rows` takes the first bit-equal best."""
    offsets = np.asarray(offsets)
    stats = np.asarray(stats)
    valid = (offsets < np.asarray(noffs)[:, None]) & (stats[..., 4] >= 0)
    totals = np.where(valid, totals_from_stats(stats[..., :4], stats[..., 4],
                                               tables),
                      -np.inf if tables.is_max else np.inf)
    best = totals.max(axis=1) if tables.is_max else totals.min(axis=1)
    eps = candidate_epsilon(tables, np.asarray(n2s))
    with np.errstate(invalid="ignore"):     # inf - inf: a row with no entry
        near = np.abs(totals - best[:, None]) <= eps[:, None]
    ri, ci = np.nonzero(valid & near)
    offs = offsets[ri, ci].astype(np.int64)
    order = np.lexsort((offs, ri))
    return ri[order], offs[order]


def pick_rows(c1b: np.ndarray, c2b: np.ndarray, n2s, tables: ScoringTables,
              rows: np.ndarray, offsets: np.ndarray, n_rows: int) -> list:
    """Exact winners of `band_candidates`' output -> a list of n_rows
    SearchResult | None (None: no candidate of the row has a legal
    substitution).

    Candidate j is offset offsets[j] of query rows[j], whose codes are row
    rows[j] of c1b / c2b and whose Seq2 length is n2s[rows[j]].  Every
    candidate is re-scored in one call with the reference's sequential f64
    semantics (cpu_funcs.c:257-300): the native `rescore_multi_native` when
    the library builds, else the numpy `rescore_multi`; the two agree bit
    for bit.  A row's winner is its first bit-equal best total in ascending
    offset order, the is_swapable winner (cuda_funcs.cu:290-307: strictly
    better, else lowest offset)."""
    results: list = [None] * n_rows
    if rows.shape[0] == 0:
        return results
    rescore = (native.rescore_multi_native if native.available()
               else rescore_multi)
    with spans.span("rescore", candidates=int(offsets.shape[0])):
        totals, coffs, subs = rescore(c1b, c2b, n2s, tables, rows, offsets)
    totals = np.where(coffs >= 0, totals, -np.inf if tables.is_max else np.inf)
    # each row's best, then the first candidate of the row that equals it
    n = rows.shape[0]
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    red = np.maximum if tables.is_max else np.minimum
    gbest = red.reduceat(totals, starts)
    hit = np.where(totals == np.repeat(gbest, np.diff(np.r_[starts, n])),
                   np.arange(n), n)
    for g, w in enumerate(np.minimum.reduceat(hit, starts)):
        if np.isfinite(gbest[g]):
            results[int(rows[w])] = SearchResult(
                offset=int(offsets[w]), char_offset=int(coffs[w]),
                sub_code=int(subs[w]), score=float(totals[w]))
    return results


def select_best(counts: np.ndarray, maxrank: np.ndarray, tables: ScoringTables,
                codes1: np.ndarray, codes2: np.ndarray,
                noff: int | None = None) -> SearchResult:
    """Pick the winning (offset, char_offset, substitute) triple from every
    offset's statistics, banded as one row and picked by `pick_rows`.

    `counts`/`maxrank` may be padded beyond the true offset count; pass `noff`
    to mask the padding.
    """
    maxrank = np.asarray(maxrank)
    n = maxrank.shape[0]
    n2s = np.array([np.asarray(codes2).shape[0]], np.int32)
    stats = np.concatenate([np.asarray(counts), maxrank[:, None]], axis=1)
    rows, cand = band_candidates(np.arange(n)[None], stats[None],
                                 [n if noff is None else noff], n2s, tables)
    if cand.shape[0] > CONFIG.max_candidates:
        print(f"psa: note: {cand.shape[0]} near-tied offsets re-scored "
              "sequentially for exact tie-breaking", file=sys.stderr)
    res = pick_rows(np.asarray(codes1)[None], np.asarray(codes2)[None], n2s,
                    tables, rows, cand, 1)[0]
    if res is None:
        raise NoMutationFound("no offset admits a legal substitution")
    return res
