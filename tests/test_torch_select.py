"""One exact selection (psa_torch/ops/select.py: `band_candidates` and
`pick_rows`) behind every device path: the single query's `search_exact`,
`search_batch` on the CPU, and the sharded searches on 1-D and 2-D CPU
meshes, each held against the JAX package's numpy engine (its native engine
for an empty Seq2, where the numpy engine raises).  A winner is compared as
(offset, char_offset, sub_code, the score's bits).  Then the band and the
pick directly against the JAX package's vectorized host selection, on rows
with entries past their offsets and entries with no legal substitution."""

import numpy as np
import pytest
import torch

from psa_tpu.core.result import NoMutationFound as JaxNoMutationFound
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models import batch as jbatch
from psa_tpu.models.search import AlignmentSearchEngine as JaxEngine

from psa_torch.core.alphabet import PAD_CODE, encode
from psa_torch.core.result import NoMutationFound
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.ops import select
from psa_torch.ops import sweep as sw
from psa_torch.parallel import mesh
from psa_torch.utils import spans
from psa_torch.utils.io import Query

from conftest import random_seq

W = (1.0, 3.0, 4.0, 2.0)
NEAR_TIE_W = (1.0, 1.0 + 2.0 ** -9, 1.0, 1.0)


def _input(kind: str):
    """(weights, seq1, seq2) of one kind of query."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random":
        return W, random_seq(rng, 2400), random_seq(rng, 300)
    if kind == "all_a":                     # every offset ties: near > k
        return W, "A" * 1500, "A" * 100
    if kind == "near_ties":
        return NEAR_TIE_W, random_seq(rng, 2000, 0.0), random_seq(rng, 250, 0.0)
    if kind == "noff_20":                   # 20 offsets: padding in the top k
        return W, random_seq(rng, 319), random_seq(rng, 300)
    return W, random_seq(rng, 400), ""      # empty Seq2: no mutation


def _key(r):
    return None if r is None else (r.offset, r.char_offset, r.sub_code,
                                   float(r.score).hex())


def _reference(w, is_max, c1, c2):
    backend = "numpy" if c2.shape[0] else "native"
    try:
        return _key(JaxEngine(w, is_max, backend=backend).search_codes(c1, c2))
    except JaxNoMutationFound:
        return None


def _run(path: str, w, is_max, s1: str, s2: str):
    c1, c2 = encode(s1), encode(s2)
    t = build_tables(np.array(w), is_max)
    if path == "search_exact":
        return _key(batch.search_exact(c1, c2, device_tables(t, "cpu")))
    if path == "search_batch":
        return _key(batch.search_batch([Query(np.array(w), s1, s2, is_max)],
                                       device="cpu")[0])
    try:
        if path == "sharded_2x2":
            return _key(mesh.search_sharded_2d(
                c1, c2, t, mesh.make_mesh_2d(["cpu"] * 4, 2, 2)))
        return _key(mesh.search_sharded(c1, c2, t,
                                        ["cpu"] * int(path[-1])))
    except NoMutationFound:
        return None


@pytest.fixture
def recorded():
    was = spans.enable(True)
    spans.clear()
    mesh.fallbacks = 0
    yield
    spans.enable(was)
    spans.clear()


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("kind", ["random", "all_a", "near_ties", "noff_20",
                                  "empty_seq2"])
@pytest.mark.parametrize("path", ["search_exact", "search_batch", "sharded_1",
                                  "sharded_4", "sharded_2x2"])
def test_path_winner_matches_jax_numpy(path, kind, is_max, recorded):
    w, s1, s2 = _input(kind)
    got = _run(path, w, is_max, s1, s2)
    assert got == _reference(w, is_max, encode(s1), encode(s2))
    assert (got is None) == (kind == "empty_seq2")
    names = [s.name for s in spans.records()]
    fell_back = ("near_fallback" in names if path.startswith("search")
                 else mesh.fallbacks > 0)
    assert fell_back == (kind == "all_a")
    if kind != "empty_seq2":
        assert "rescore" in names


def _fetched_rows(rng, is_max):
    """Six queries of one bucket with their own Seq1 and Seq2 lengths, through
    the batch path's device half on the CPU -> (codes, noffs, n2s, topi,
    stats_k (6, k, 5), tables)."""
    lens = [(700, 120), (650, 120), (900, 64), (333, 300), (700, 1), (520, 97)]
    s1s = [random_seq(rng, n1) for n1, _ in lens]
    s2s = [random_seq(rng, n2) for _, n2 in lens]
    n2s = np.array([n2 for _, n2 in lens], np.int32)
    noffs = np.array([n1 - n2 + 1 for n1, n2 in lens], np.int32)
    l2p = sw.round_up(int(n2s.max()), sw.L2_ALIGN)
    _, l1k = sw.plan_bucket(noffs, l2p)
    c1b = np.full((6, l1k), PAD_CODE, np.uint8)
    c2b = np.full((6, l2p), PAD_CODE, np.uint8)
    for r, (a, b) in enumerate(zip(s1s, s2s)):
        c1b[r, : len(a)], c2b[r, : len(b)] = encode(a), encode(b)
    t = build_tables(np.array(W), is_max)
    packed = batch.run_exact_batch(torch.from_numpy(c1b), torch.from_numpy(c2b),
                                   torch.from_numpy(noffs),
                                   device_tables(t, "cpu")).numpy()
    topi, stats_k, _, _ = batch.unpack_epilogue_outputs(packed, batch.TOPK)
    return c1b, c2b, noffs, n2s, topi, np.swapaxes(stats_k, 1, 2), t


@pytest.mark.parametrize("is_max", [False, True])
def test_band_and_pick_match_jax_rows(is_max):
    """Each row's best entry is copied past its offsets (idx >= noff), and in
    two rows the best loses its legal substitution (maxrank = -1): the band
    must drop both, as the JAX package's selection does."""
    rng = np.random.default_rng(70 + is_max)
    c1b, c2b, noffs, n2s, topi, stats_k, t = _fetched_rows(rng, is_max)
    topi, stats_k = topi.copy(), stats_k.copy()
    for r in range(6):
        topi[r, -1] = noffs[r] + r          # the best's stats, out of range
        stats_k[r, -1] = stats_k[r, 0]
    stats_k[1, 0, 4] = stats_k[4, 0, 4] = -1
    rows, offs = select.band_candidates(topi, stats_k, noffs, n2s, t)
    assert (np.diff(rows) >= 0).all() and (offs < noffs[rows]).all()
    same_row = rows[1:] == rows[:-1]
    assert (np.diff(offs)[same_row] > 0).all()
    got = select.pick_rows(c1b, c2b, n2s, t, rows, offs, 6)
    want = [None] * 6
    jbatch._select_rows_vectorized(want, np.arange(6), c1b.astype(np.int32),
                                   c2b.astype(np.int32), noffs, n2s,
                                   jax_build_tables(np.array(W), is_max), topi,
                                   stats_k)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert all(r is not None for r in got)
