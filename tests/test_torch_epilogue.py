"""The port's device epilogue (psa_torch.models.batch) against the JAX
package's `exact_topk_epilogue_rows` on the same integer stats, and the
near > k fallback end to end."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psa_tpu.core.oracle import offset_stats_numpy
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models import batch as jbatch
from psa_tpu.ops.select import select_best as jax_select_best

from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops.common import keyed_f32_totals_ops
from psa_torch.ops import sweep as sw

IRRATIONAL = (np.pi / 4, np.e / 7, np.sqrt(2) / 3, 1 / 3)


def synthetic_stats5(rng, tables, np_len, noff, l2p):
    """(5, np_len) int32 stats with random counts and maxranks; offsets past
    noff hold junk the epilogue must mask."""
    counts = rng.integers(0, l2p // 4, (4, np_len)).astype(np.int32)
    maxrank = rng.integers(-1, tables.num_ranks, np_len).astype(np.int32)
    stats5 = np.concatenate([counts, maxrank[None]], axis=0)
    stats5[:4, noff:] = rng.integers(0, 50, (4, np_len - noff))
    return stats5


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("weights", [IRRATIONAL, (1.0, 3.0, 4.0, 2.0)])
def test_epilogue_matches_jax(weights, is_max):
    rng = np.random.default_rng(11 + is_max)
    np_len, noff, l2p, k = 2048, 1900, 512, batch.TOPK
    tables = build_tables(np.array(weights), is_max)
    stats5 = synthetic_stats5(rng, tables, np_len, noff, l2p)
    if weights != IRRATIONAL:
        # integer weights make exact key ties: give the first 512 offsets
        # distinct keys and none to the rest, so the top-k set is defined
        stats5[:, :noff] = 0
        stats5[0, :512] = np.arange(512)
        stats5[4, 512:noff] = -1
    dtabs = device_tables(tables, "cpu")
    topi, stats_k, near, best = batch.exact_topk_epilogue_rows(
        torch.from_numpy(stats5), dtabs, noff, l2p, k)
    jt = jax_build_tables(np.array(weights), is_max)
    jtopi, jstats_k, jnear, jbest = (np.asarray(a) for a in
                                     jbatch.exact_topk_epilogue_rows(
                                         jnp.asarray(stats5), jt, noff, l2p, k))
    eps = jbatch.f32_band_epsilon(jt, l2p)
    assert batch.f32_band_epsilon(tables, l2p) == eps
    assert abs(float(best) - float(jbest)) <= eps

    keyed = keyed_f32_totals_ops(
        torch.from_numpy(stats5[:4]), torch.from_numpy(stats5[4]),
        dtabs.w32, dtabs.diff32, is_max, noff)[0].numpy()
    edge = np.abs(keyed - (float(best) - dtabs.eps(l2p)))
    assert edge.min() > 1e-3 * eps, "a key lies at the band's edge"
    assert int(near) == int(jnear)

    srt = np.sort(keyed)[::-1]
    assert srt[k - 1] > srt[k], "tied keys at the top-k boundary"
    assert set(topi.tolist()) == set(jtopi.tolist())
    order = np.argsort(topi.numpy())
    jorder = np.argsort(jtopi)
    np.testing.assert_array_equal(stats_k.numpy()[:, order], jstats_k[:, jorder])


def test_pack_layout_matches_jax():
    rng = np.random.default_rng(3)
    b, k = 1, batch.TOPK
    topi = rng.integers(0, 1 << 20, (b, k)).astype(np.int32)
    stats_k = rng.integers(-1, 1 << 15, (b, 5, k)).astype(np.int32)
    near = rng.integers(0, 1 << 20, b).astype(np.int32)
    best = rng.standard_normal(b).astype(np.float32)
    got = batch.pack_epilogue_outputs(torch.from_numpy(topi),
                                      torch.from_numpy(stats_k),
                                      torch.from_numpy(near),
                                      torch.from_numpy(best)).numpy()
    want = np.asarray(jbatch.pack_epilogue_outputs(
        jnp.asarray(topi), jnp.asarray(stats_k), jnp.asarray(near),
        jnp.asarray(best), compact=False))
    np.testing.assert_array_equal(got, want)
    for a, e in zip(batch.unpack_epilogue_outputs(got, k),
                    jbatch.unpack_epilogue_outputs(want, k, compact=False)):
        np.testing.assert_array_equal(a, e)


def test_massive_tie_fallback_matches_jax():
    """A periodic Seq1 ties ~1900 offsets inside the f32 band (near > k):
    the host must fall back to the full stats and still find the JAX
    package's exact winner."""
    w = np.asarray(IRRATIONAL)
    c1 = np.tile(np.array([0, 1], np.int32), 1000)
    c2 = np.tile(np.array([0, 1], np.int32), 64)
    tables = build_tables(w, False)
    noff, _, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
    stats5 = sw.sweep(*sw.upload_codes("cpu", (c1, l1k), (c2, l2p)),
                      torch.from_numpy(tables.code))
    _, _, near, _ = batch.exact_topk_epilogue_rows(
        stats5[None], device_tables(tables, "cpu"), noff, l2p)
    assert int(near[0]) > batch.TOPK

    got = AlignmentSearchEngine(w, False, device="cpu").search_codes(c1, c2)
    jt = jax_build_tables(w, False)
    counts, maxrank = offset_stats_numpy(c1, c2, jt)
    want = jax_select_best(counts, maxrank, jt, c1, c2)
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        want.offset, want.char_offset, want.sub_code, want.score)
