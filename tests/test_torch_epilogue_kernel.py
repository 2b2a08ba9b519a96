"""The port's top-k epilogue and pack (psa_torch.ops.epilogue) on the CPU,
where `epilogue_pack` runs its plain version: against the JAX package's
`exact_topk_epilogue_rows` + `pack_epilogue_outputs(compact=False)` on the
same stats5, word for word (tolerance 0, ties at the k-th key included),
the ranking against `jax.lax.top_k` index for index, the cached band eps,
the comparator itself, the paths that route through `epilogue_pack`, the
kernel's scratch cache, the one-buffer upload and the dispatch.  The CUDA
kernel itself runs only on the card (tests/test_torch_gpu.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models import batch as jbatch

from psa_torch.core.alphabet import PAD_CODE
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.ops import epilogue as ep
from psa_torch.ops.common import keyed_f32_totals_ops
from psa_torch.ops import sweep as sw
from psa_torch.parallel import mesh

K = ep.TOPK
W_INT = (1.0, 3.0, 4.0, 2.0)
W_IRR = (np.pi / 4, np.e / 7, np.sqrt(2) / 3, 1 / 3)
ROOT = Path(__file__).resolve().parent.parent


def stats_rows(rng, tables, b, np_len, hi):
    """(b, 5, np_len) int32: class counts in [0, hi), maxranks in [-1,
    num_ranks)."""
    counts = rng.integers(0, hi, (b, 4, np_len))
    maxrank = rng.integers(-1, tables.num_ranks, (b, 1, np_len))
    return np.concatenate([counts, maxrank], axis=1).astype(np.int32)


def case_inputs(case, is_max):
    """(weights, stats5 (B, 5, NP), noff: int or (B,) array, l2p, g0)."""
    rng = np.random.default_rng(2 * CASES.index(case) + is_max)
    w = W_IRR if case == "irrational" else W_INT
    tables = build_tables(np.array(w), is_max)
    l2p, g0 = 512, 0
    if case == "ties_at_kth":
        # counts in [0, 3) under 1 3 4 2: ~40 distinct totals over 3000
        # offsets, so the k-th key is shared by many offsets
        st, noff = stats_rows(rng, tables, 2, 3000, 3), 2900
    elif case == "near_gt_k":
        # 200 offsets copy the best column: the band holds > k offsets
        st, noff = stats_rows(rng, tables, 1, 2048, 100), 2000
        best = int(np.argmax(keys_of(tables, st, noff)[0]))
        st[0, :, 100:300] = st[0, :, best:best + 1]
    elif case == "noff_lt_k":
        st, noff = stats_rows(rng, tables, 1, 256, 100), 10
    elif case == "no_valid_offset":
        st, noff = stats_rows(rng, tables, 2, 512, 100), 500
        st[1, 4] = -1
    elif case == "per_row_noff":
        st = stats_rows(rng, tables, 5, 1792, 128)
        noff = np.array([1537, 1, 31, 1792, 900], np.int32)
    elif case == "shard_g0":
        st, noff, g0 = stats_rows(rng, tables, 1, 768, 200), 700, 22_528
    else:
        st, noff = stats_rows(rng, tables, 3, 4100, 2500), 4097
    return w, tables, st, noff, l2p, g0


def keys_of(tables, st, noff):
    """The f32 keys of stats5 rows (B, 5, NP), as the plain version ranks
    them."""
    dtabs = device_tables(tables, "cpu")
    nf = torch.from_numpy(noff) if isinstance(noff, np.ndarray) else noff
    return keyed_f32_totals_ops(torch.from_numpy(st[:, :4]),
                                torch.from_numpy(st[:, 4]), dtabs.w32,
                                dtabs.diff32, tables.is_max, nf)[0].numpy()


CASES = ["ties_at_kth", "near_gt_k", "noff_lt_k", "no_valid_offset",
         "per_row_noff", "shard_g0", "irrational"]


def jax_pack(w, is_max, st, noff, l2p, g0):
    jt = jax_build_tables(np.array(w), is_max)
    topi, stats_k, near, best = jbatch.exact_topk_epilogue_rows(
        jnp.asarray(st), jt, jnp.asarray(noff), l2p, K)
    return np.asarray(jbatch.pack_epilogue_outputs(
        topi + g0, stats_k, near, best, compact=False))


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_epilogue_pack_matches_jax(case, is_max):
    w, tables, st, noff, l2p, g0 = case_inputs(case, is_max)
    dtabs = device_tables(tables, "cpu")
    tnoff = torch.from_numpy(noff) if isinstance(noff, np.ndarray) else noff
    before = ep.launches
    got = ep.epilogue_pack(torch.from_numpy(st), dtabs, tnoff, l2p, K, g0)
    assert ep.launches == before, "a CPU tensor launched the kernel"
    want = jax_pack(w, is_max, st, noff, l2p, g0)
    assert got.shape == (st.shape[0], 6 * K + 2) and got.dtype == torch.int32
    assert ep.pack_mismatch(want, got, st, noff, dtabs, g0) is None
    assert np.array_equal(got.numpy(), want)
    near = got[:, 6 * K].numpy()
    best = got[:, 6 * K + 1].numpy().view(np.float32)
    if case == "near_gt_k":
        assert near[0] > K
    if case == "noff_lt_k":
        assert np.isfinite(best[0]) and near[0] <= 10
    if case == "no_valid_offset":
        assert np.isneginf(best[1]) and near[1] == st.shape[2]
    if case == "per_row_noff":
        assert (near[:4] >= 1).all()


def test_ties_at_kth_really_tie():
    """The case above is what it says: the k-th and (k+1)-th keys are
    equal, so the JAX package and the port may pick different offsets."""
    _, tables, st, noff, _, _ = case_inputs("ties_at_kth", False)
    srt = -np.sort(-keys_of(tables, st, noff), axis=1)
    assert (srt[:, K - 1] == srt[:, K]).all()


def tie_heavy_keys(rng, rows, n):
    """(rows, n) f32 keys drawn from a few values, -inf, +0.0 and -0.0."""
    pool = np.array([-np.inf, 0.0, -0.0, 1.5, -1.5, 2.0, 7.25, -3.0],
                    np.float32)
    return pool[rng.integers(0, pool.size, (rows, n))]


RANK_CASES = [(1, 40, 1), (3, 100, 7), (2, 257, 32), (4, 300, 33), (2, 1000, 64),
              (5, 64, 64)]


@pytest.mark.parametrize("rows,n,k", RANK_CASES)
def test_ranking_matches_lax_top_k(rows, n, k):
    """The port's ranking (`rank_keys`, the kernel's order) holds random
    f32 keys with ties, -inf and both zeros in lax.top_k's order, index for
    index, and best equals jnp.max bit for bit."""
    rng = np.random.default_rng(rows * 1000 + n + k)
    keys = tie_heavy_keys(rng, rows, n)
    if rows > 1:
        keys[1, ::3] = rng.standard_normal(keys[1, ::3].shape).astype(np.float32)
    topi, best = ep.rank_keys(torch.from_numpy(keys), k)
    _, want = jax.lax.top_k(jnp.asarray(keys), k)
    assert np.array_equal(topi.numpy(), np.asarray(want))
    jbest = np.asarray(jnp.max(jnp.asarray(keys), axis=-1))
    assert np.array_equal(best.numpy().view(np.uint32), jbest.view(np.uint32))


def test_ranking_puts_positive_zero_first():
    keys = torch.tensor([[-0.0, 0.0, -0.0, 0.0, float("-inf")]])
    topi, best = ep.rank_keys(keys, 5)
    assert topi.tolist() == [[1, 3, 0, 2, 4]]
    assert best.numpy().view(np.uint32)[0] == 0


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("w", [W_INT, W_IRR, (0.5, 0.0, 2.5, 100.0)])
def test_cached_eps_is_the_band_epsilon(w, is_max):
    """`DeviceTables.eps` computes once per l2p and gives the f32 bits of
    the JAX package's `f32_band_epsilon`, on the first call and after."""
    dtabs = device_tables(build_tables(np.array(w), is_max), "cpu")
    jt = jax_build_tables(np.array(w), is_max)
    for l2p in (1, 64, 512, 10_016, 250_016):
        want = np.float32(jbatch.f32_band_epsilon(jt, l2p)).view(np.uint32)
        for _ in range(2):
            assert np.float32(dtabs.eps(l2p)).view(np.uint32) == want
    assert sorted(l2p for key, l2p in dtabs._memo if key == "eps") == [1, 64, 512, 10_016,
                                                                      250_016]


def test_scratch_is_cached_and_grows():
    """The kernel's scratch: one zeroed ticket buffer per (device, stream),
    kept across calls, and a data buffer that grows to the largest need and
    is never cut back."""
    dev = torch.device("cpu")
    ep._scratch.pop((dev.index, 7), None)
    tickets, data = ep._scratch_for(dev, 7, 0)
    assert data is None and tickets.numel() == ep.MAX_ROWS and not tickets.any()
    big = ep.scratch_words(3, 5 * ep.EPILOGUE_COLS + 1, K, ep.EPILOGUE_COLS)
    t2, d2 = ep._scratch_for(dev, 7, big)
    assert t2 is tickets and d2.numel() == big
    t3, d3 = ep._scratch_for(dev, 7, ep.scratch_words(1, ep.EPILOGUE_COLS + 1, K,
                                                       ep.NARROW_COLS))
    assert t3 is tickets and d3 is d2
    assert ep._scratch_for(dev, 8, 0)[0] is not tickets
    ep._scratch.pop((dev.index, 7))
    ep._scratch.pop((dev.index, 8))


@pytest.mark.parametrize("cols", [1024, 2048])
def test_scratch_words(cols):
    """No scratch for rows of one block; per block of a wider row its top
    32 (k <= 32) or 64 candidates of two words and its band count."""
    assert ep.scratch_words(1024, ep.EPILOGUE_COLS, K, cols) == 0
    nblk = -(-90_112 // cols)
    assert ep.scratch_words(1, 90_112, 32, cols) == nblk * 65
    assert ep.scratch_words(2, 90_112, 7, cols) == 2 * nblk * 65
    assert ep.scratch_words(3, 90_112, 33, cols) == 3 * nblk * 129


@pytest.mark.parametrize("np_len,sms,want", [
    (90_112, 132, 1024), (998_144, 132, 2048), (198_144, 132, 1024), (350_208, 132, 2048),
    (270_336, 132, 1024), (270_337, 132, 2048), (90_112, 40, 2048), (22_528, 1, 2048)])
def test_block_cols_fit_two_blocks_a_multiprocessor(np_len, sms, want):
    """A wide row's blocks are 1,024 offsets while they fit two a
    multiprocessor, else 2,048: the north star's 88 on an H100's 132."""
    assert ep.block_cols(np_len, sms) == want


@pytest.mark.parametrize("is_max", [False, True])
def test_shard_pack_keeps_its_old_result(is_max):
    """`mesh._shard_pack` now runs `epilogue_pack` with g0 inside it: the
    same pack as its old composition, the rows epilogue on the shard's
    local noff, packed with topi + g0."""
    rng = np.random.default_rng(5 + is_max)
    tables = build_tables(np.array(W_IRR), is_max)
    dtabs = device_tables(tables, "cpu")
    width, g0, noff, l2p = 512, 1024, 1300, 1024
    st = torch.from_numpy(stats_rows(rng, tables, 1, width, 300)[0])
    got = mesh._shard_pack(st, dtabs, noff, g0, width, l2p)
    topi, stats_k, near, best = batch.exact_topk_epilogue_rows(
        st[None], dtabs, noff - g0, l2p)
    old = batch.pack_epilogue_outputs(topi + g0, stats_k, near, best)
    assert torch.equal(got, old)
    assert ep.same_pack(old, got, st[None], noff - g0, dtabs, g0)


CORRUPTIONS = ["wrong_index", "duplicate_index", "wrong_near", "wrong_best_bit",
               "stats_of_another_offset", "index_out_of_range"]


@pytest.mark.parametrize("corruption", CORRUPTIONS)
def test_same_pack_rejects(corruption):
    w, tables, st, noff, l2p, g0 = case_inputs("irrational", False)
    dtabs = device_tables(tables, "cpu")
    good = ep.epilogue_pack(torch.from_numpy(st), dtabs, noff, l2p).numpy()
    assert ep.same_pack(good, good.copy(), st, noff, dtabs)
    bad = good.copy()
    r, topi = 1, good[1, :K]
    # offsets outside the top k without a substitution: their key, -inf,
    # is none of the top k's
    outside = [c for c in range(st.shape[2])
               if c not in set(topi.tolist()) and st[r, 4, c] < 0]
    if corruption == "wrong_index":
        # another offset, with its own stats: only the keys can tell
        bad[r, 0] = outside[0]
        bad[r, K:6 * K].reshape(5, K)[:, 0] = st[r, :, outside[0]]
    elif corruption == "duplicate_index":
        bad[r, 1] = bad[r, 0]
        bad[r, K:6 * K].reshape(5, K)[:, 1] = bad[r, K:6 * K].reshape(5, K)[:, 0]
    elif corruption == "wrong_near":
        bad[r, 6 * K] += 1
    elif corruption == "wrong_best_bit":
        bad[r, 6 * K + 1] ^= 1
    elif corruption == "stats_of_another_offset":
        bad[r, K:6 * K].reshape(5, K)[:, 0] = st[r, :, outside[0]]
    else:
        bad[r, 0] = st.shape[2]
    assert not np.array_equal(bad, good)
    assert not ep.same_pack(good, bad, st, noff, dtabs)
    assert ep.pack_mismatch(good, bad, st, noff, dtabs).startswith(f"row {r}:")


def test_run_paths_route_through_epilogue_pack(monkeypatch):
    """`run_exact`, `run_exact_batch` and `mesh._shard_pack` each call
    `epilogue_pack` once per call, with the shard's g0 passed in."""
    calls = []
    real = ep.epilogue_pack

    def spy(stats5, dtabs, noff, l2p, k=K, g0=0):
        calls.append((tuple(stats5.shape), g0))
        return real(stats5, dtabs, noff, l2p, k, g0)

    monkeypatch.setattr(batch, "epilogue_pack", spy)
    monkeypatch.setattr(mesh, "epilogue_pack", spy)
    tables = build_tables(np.array(W_INT), False)
    dtabs = device_tables(tables, "cpu")
    rng = np.random.default_rng(2)
    c1 = rng.integers(0, 26, 700)
    c2 = rng.integers(0, 26, 60)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(700, 60)
    d1, d2 = sw.upload_codes("cpu", (c1, l1k), (c2, l2p))
    packed, stats5 = batch.run_exact(d1, d2, noff, dtabs)
    assert calls == [((1, 5, noff_pad), 0)]
    c1b = torch.stack([d1, d1])
    c2b = torch.stack([d2, d2])
    batch.run_exact_batch(c1b, c2b, torch.tensor([noff, noff], dtype=torch.int32),
                          dtabs)
    assert calls[-1] == ((2, 5, noff_pad), 0)
    mesh._shard_pack(stats5[:, 256:512], dtabs, noff, 256, 256, l2p)
    assert calls[-1] == ((1, 5, 256), 256)
    assert len(calls) == 3
    assert torch.equal(packed, ep.epilogue_pack_plain(stats5[None], dtabs, noff, l2p))


@pytest.mark.parametrize("n1,n2", [(700, 60), (1000, 1), (300, 300), (5000, 2047)])
def test_upload_pair_views_equal_upload_codes(n1, n2):
    """One buffer [Seq1 padded to l1k | Seq2 padded to l2p]: its two views
    equal each sequence uploaded alone and padded by hand, and Seq2 starts
    on a 16-byte boundary of the same buffer."""
    rng = np.random.default_rng(n1 + n2)
    c1 = rng.integers(0, 28, n1).astype(np.int32)
    c2 = rng.integers(0, 28, n2).astype(np.int32)
    _, _, l2p, l1k = sw.plan_shapes(n1, n2)
    d1, d2 = sw.upload_codes("cpu", (c1, l1k), (c2, l2p))
    for view, codes, length in ((d1, c1, l1k), (d2, c2, l2p)):
        (alone,) = sw.upload_codes("cpu", (codes, length))
        assert torch.equal(view, alone)
        want = np.full(length, PAD_CODE, np.uint8)
        want[: codes.shape[0]] = codes
        assert np.array_equal(view.numpy(), want)
    assert d1.dtype == d2.dtype == torch.uint8
    assert d2.data_ptr() - d1.data_ptr() == l1k and l1k % 16 == 0
    assert d1.untyped_storage().data_ptr() == d2.untyped_storage().data_ptr()
    with pytest.raises(ValueError):
        sw.upload_codes("cpu", (c1, n1 - 1), (c2, l2p))


def test_search_paths_upload_one_buffer(monkeypatch):
    """`search_exact` and the mesh's `_place` take one `upload_codes` of
    both sequences per query (per distinct device), not one per sequence."""
    pairs = []
    real = sw.upload_codes

    def spy(device, *seqs):
        pairs.append((str(device), len(seqs)))
        return real(device, *seqs)

    monkeypatch.setattr(batch, "upload_codes", spy)
    monkeypatch.setattr(mesh, "upload_codes", spy)
    tables = build_tables(np.array(W_INT), False)
    rng = np.random.default_rng(9)
    c1 = rng.integers(0, 26, 3000).astype(np.int32)
    c2 = rng.integers(0, 26, 200).astype(np.int32)
    r = batch.search_exact(c1, c2, device_tables(tables, "cpu"))
    s = mesh.search_sharded(c1, c2, tables, ["cpu"] * 4)
    assert (r.offset, r.score) == (s.offset, s.score)
    assert pairs == [("cpu", 2), ("cpu", 2)]


def test_dispatch_raises_off_cpu_and_cuda():
    tables = build_tables(np.array(W_INT), False)
    dtabs = device_tables(tables, "cpu")
    meta = torch.empty((1, 5, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no epilogue for device meta"):
        ep.epilogue_pack(meta, dtabs, 200, 64)


def test_source_constants_match_the_wrapper():
    """csrc/epilogue.cu's block widths and k limit are the wrapper's, and the
    library build compiles it with the sweeps."""
    src = (ROOT / "psa_torch" / "csrc" / "epilogue.cu").read_text()
    assert int(re.search(r"kRowCols = (\d+);", src).group(1)) == ep.EPILOGUE_COLS
    assert int(re.search(r"kNarrowCols = (\d+);", src).group(1)) == ep.NARROW_COLS
    assert int(re.search(r"kMaxK = (\d+);", src).group(1)) == ep.MAX_K >= ep.TOPK
    params = [p.strip() for p in re.search(r"enum Param \{([^}]*)\}", src).group(1).split(",")]
    assert params.index("kParams") == ep.PARAMS
    assert "epilogue.cu" in {f.name for f in sw._CSRC.glob("*.cu")}
    assert "__fmul_rn" in src and "__fadd_rn" in src and "__fsub_rn" in src
