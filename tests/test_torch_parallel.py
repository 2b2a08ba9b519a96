"""The port's sharded search (psa_torch.parallel.mesh) against the JAX
package's on its 8-device virtual CPU mesh.  The port's meshes are lists of
CPU devices (`["cpu"] * n`), where the sweep runs its plain version; the
same numpy inputs from one seed go through both.  Every compared value is
an exact integer or an f64 score compared bit for bit: winners and the
`[:noff]` stats, never the packs (the port pads offsets to 256 and Seq2 to
32, the JAX package to 512 and 128)."""

import jax
import numpy as np
import pytest
import torch

from psa_tpu.core.oracle import offset_stats_numpy
from psa_tpu.core.result import NoMutationFound as JaxNoMutationFound
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models.search import AlignmentSearchEngine as JaxEngine
from psa_tpu.parallel import mesh as jmesh

from psa_torch.core.alphabet import encode
from psa_torch.core.result import NoMutationFound
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models.batch import TOPK, unpack_epilogue_outputs
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops.common import keyed_f32_totals_ops
from psa_torch.parallel import mesh

from conftest import random_codes

W = [1.0, 3.0, 4.0, 2.0]
SHAPES_2D = [(1, 1), (1, 2), (2, 2), (1, 4), (4, 2), (2, 4), (1, 8)]


def tup(r):
    return (r.offset, r.char_offset, r.sub_code, r.score)


def numpy_ref(w, is_max, c1, c2):
    return tup(JaxEngine(w, is_max, backend="numpy").search_codes(c1, c2))


def cpu(n):
    return ["cpu"] * n


@pytest.fixture(autouse=True)
def no_mesh_override(monkeypatch):
    monkeypatch.delenv("PSA_MESH_SHAPE", raising=False)


@pytest.fixture
def count_fallbacks():
    mesh.fallbacks = 0
    yield lambda: mesh.fallbacks


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("is_max", [False, True])
def test_sharded_matches_jax(n, is_max, count_fallbacks):
    rng = np.random.default_rng(7 + is_max)
    w = [2.0, 1.0, 3.0, 0.5] if is_max else W
    c1, c2 = random_codes(rng, 4200), random_codes(rng, 150)
    got = tup(mesh.search_sharded(c1, c2, build_tables(np.array(w), is_max),
                                  cpu(n)))
    want = tup(jmesh.search_sharded(c1, c2, jax_build_tables(np.array(w), is_max),
                                    jmesh.make_mesh(jax.devices()[:n])))
    assert got == want == numpy_ref(w, is_max, c1, c2)
    assert count_fallbacks() == 0


@pytest.mark.parametrize("is_max", [True, False])
def test_sharded_offset_stats_match_jax(is_max):
    rng = np.random.default_rng(13 + is_max)
    w = np.array([2.0, 1.0, 3.0, 0.5])
    c1, c2 = random_codes(rng, 2500), random_codes(rng, 300)
    c1p, c2p, noff = mesh.pad_for_mesh(c1, c2, 8)
    got = mesh.sharded_offset_stats(c1p, c2p, build_tables(w, is_max), cpu(8))
    assert got.dtype == torch.int32 and got.shape == (c1p.shape[0] - c2p.shape[0], 5)
    j1, j2, jnoff = jmesh.pad_for_mesh(c1, c2, 8)
    want = np.asarray(jmesh.sharded_offset_stats(j1, j2, jax_build_tables(w, is_max),
                                                 jmesh.make_mesh()))
    counts, maxrank = offset_stats_numpy(c1, c2, jax_build_tables(w, is_max))
    assert noff == jnoff
    np.testing.assert_array_equal(got.numpy()[:noff], want[:noff])
    np.testing.assert_array_equal(got.numpy()[:noff, :4], counts)
    np.testing.assert_array_equal(got.numpy()[:noff, 4], maxrank)


@pytest.mark.parametrize("n_op,n_ch", SHAPES_2D)
def test_sharded_2d_matches_jax(n_op, n_ch, count_fallbacks):
    rng = np.random.default_rng(29)
    c1, c2 = random_codes(rng, 3000), random_codes(rng, 700)
    got = tup(mesh.search_sharded_2d(c1, c2, build_tables(np.array(W), False),
                                     mesh.make_mesh_2d(cpu(8), n_op, n_ch)))
    want = tup(jmesh.search_sharded_2d(c1, c2, jax_build_tables(np.array(W), False),
                                       jmesh.make_mesh_2d(jax.devices(), n_op, n_ch),
                                       kernel="xla"))
    assert got == want == numpy_ref(W, False, c1, c2)
    assert count_fallbacks() == 0


@pytest.mark.parametrize("n_op,n_ch", [(4, 2), (2, 4)])
def test_sharded_2d_max_mode(n_op, n_ch):
    rng = np.random.default_rng(31)
    w = [2.0, 1.0, 3.0, 0.5]
    c1, c2 = random_codes(rng, 4000), random_codes(rng, 400)
    got = tup(mesh.search_sharded_2d(c1, c2, build_tables(np.array(w), True),
                                     mesh.make_mesh_2d(cpu(8), n_op, n_ch)))
    assert got == numpy_ref(w, True, c1, c2)


def test_sharded_2d_two_weight_vectors_in_turn():
    rng = np.random.default_rng(41)
    c1, c2 = random_codes(rng, 2000), random_codes(rng, 400)
    grid = mesh.make_mesh_2d(cpu(4), 2, 2)
    for w in ([1.0, 3.0, 4.0, 2.0], [5.0, 0.5, 2.0, 9.0], [1.0, 3.0, 4.0, 2.0]):
        got = tup(mesh.search_sharded_2d(c1, c2, build_tables(np.array(w), False),
                                         grid))
        assert got == numpy_ref(w, False, c1, c2), w


@pytest.mark.parametrize("n", [2, 8])
def test_massive_ties_fall_back(n, count_fallbacks):
    """All 'A': every offset ties exactly, no shard's top k can certify the
    winner, and the full-stats fallback returns the lowest offset."""
    c1, c2 = np.zeros(4200, np.int32), np.zeros(150, np.int32)
    got = mesh.search_sharded(c1, c2, build_tables(np.array(W), False), cpu(n))
    want = jmesh.search_sharded(c1, c2, jax_build_tables(np.array(W), False),
                                jmesh.make_mesh(jax.devices()[:n]))
    assert tup(got) == tup(want) == numpy_ref(W, False, c1, c2)
    assert got.offset == 0
    assert count_fallbacks() == 1


def test_massive_ties_fall_back_2d(count_fallbacks):
    c1, c2 = np.zeros(4000, np.int32), np.zeros(600, np.int32)
    got = mesh.search_sharded_2d(c1, c2, build_tables(np.array(W), False),
                                 mesh.make_mesh_2d(cpu(8), 2, 4))
    assert tup(got) == numpy_ref(W, False, c1, c2)
    assert got.offset == 0
    assert count_fallbacks() == 1


@pytest.mark.parametrize("path", ["1d", "2d"])
def test_no_mutation_raises(path):
    """Out-of-range characters everywhere: no shard finds a legal
    substitution, on either mesh, as in the JAX package."""
    t = build_tables(np.array(W), True)
    c1, c2 = np.full(3000, 27, np.int32), np.full(300, 27, np.int32)
    with pytest.raises(NoMutationFound):
        if path == "1d":
            mesh.search_sharded(c1, c2, t, cpu(8))
        else:
            mesh.search_sharded_2d(c1, c2, t, mesh.make_mesh_2d(cpu(8), 2, 4))
    with pytest.raises(JaxNoMutationFound):
        jmesh.search_sharded(c1, c2, jax_build_tables(np.array(W), True),
                             jmesh.make_mesh())


@pytest.mark.parametrize("shape", [None, (1, 8), (2, 4)])
def test_all_padding_shards_are_ignored(shape, monkeypatch, count_fallbacks):
    """301 offsets over 8 shards of 256: shards that hold only padding have
    noff_local = 0, best = -inf and near = their width > k; the merge must
    ignore them and take no fallback."""
    rng = np.random.default_rng(5)
    c1, c2 = random_codes(rng, 450), random_codes(rng, 150)
    bufs = []
    real = mesh._select_from_shard_topk
    monkeypatch.setattr(mesh, "_select_from_shard_topk",
                        lambda buf, *a: bufs.append(buf) or real(buf, *a))
    t = build_tables(np.array(W), False)
    if shape is None:
        got = mesh.search_sharded(c1, c2, t, cpu(8))
    else:
        got = mesh.search_sharded_2d(c1, c2, t, mesh.make_mesh_2d(cpu(8), *shape))
    assert tup(got) == numpy_ref(W, False, c1, c2)
    assert count_fallbacks() == 0
    _, _, near, best = unpack_epilogue_outputs(bufs[0], TOPK)
    assert len(best) == 8
    assert np.isneginf(best[2:]).all() and np.isfinite(best[:2]).all()
    assert (near[2:] == 256).all()


def test_2d_band_uses_the_full_seq2_length(monkeypatch, count_fallbacks):
    """The "ch"-reduced stats are full-length sums, so each shard's f32 band
    is eps(l2p) of the FULL Seq2, not of its chunk.  Seq2 all 'N' under a
    Seq1 of 'N' with 1 % 'D' (colon) and 'W' (space) at w = (1, 1 + 2^-9,
    1, 1): offsets with the best colon-plus-space count sit 2^-9 apart in
    colons, inside eps(2048) = 3.9e-3 but outside the chunk's eps(256) =
    4.9e-4.  Every shard's near must be its count under the full band, and
    some shard's full band holds more than k offsets where the chunk's
    holds at most k (so a chunk band would skip the fallback it needs)."""
    w = np.array([1.0, 1.0 + 2.0 ** -9, 1.0, 1.0])
    t = build_tables(w, False)
    rng = np.random.default_rng(0)
    n_code, d_code, w_code = encode("NDW")
    r = rng.random(4000)
    c1 = np.where(r < 0.005, d_code, np.where(r < 0.01, w_code, n_code)).astype(np.int32)
    c2 = np.full(2000, n_code, np.int32)
    bufs = []
    real = mesh._select_from_shard_topk
    monkeypatch.setattr(mesh, "_select_from_shard_topk",
                        lambda buf, *a: bufs.append(buf) or real(buf, *a))
    got = mesh.search_sharded_2d(c1, c2, t, mesh.make_mesh_2d(cpu(8), 1, 8))
    assert tup(got) == numpy_ref(w, False, c1, c2)
    assert count_fallbacks() == 1
    c1p, c2p, noff = mesh.pad_for_mesh_2d(c1, c2, 1, 8)
    l2p = c2p.shape[0]
    blk = (c1p.shape[0] - l2p) // 8
    dt = device_tables(t, "cpu")
    counts, maxrank = offset_stats_numpy(c1, c2, jax_build_tables(w, False))
    keyed, _ = keyed_f32_totals_ops(torch.from_numpy(counts.T.copy()),
                                    torch.from_numpy(maxrank), dt.w32,
                                    dt.diff32, False, noff)
    near = unpack_epilogue_outputs(bufs[0], TOPK)[2]
    full, chunk = [], []
    for j in range(8):
        k = keyed[j * blk: min((j + 1) * blk, noff)]
        full.append(int((k >= k.max() - dt.eps(l2p)).sum()))
        chunk.append(int((k >= k.max() - dt.eps(l2p // 8)).sum()))
    assert near.tolist() == full
    assert any(c <= TOPK < f for c, f in zip(chunk, full))


def test_choose_mesh_shape_regimes():
    """The card's sweep does each padded (offset, position) pair once, with
    no window-overlap work, so a shard's sweep work is the same at every
    shape up to Seq2's padding and the "ch" reduction only adds bytes: the
    offset split wins in every regime.  This differs from the JAX package's
    TPU model, whose window overlap gives the north-star regime (8 devices,
    90001 x 10000) a char axis; here it stays (8, 1), and so does 600k x
    250k on 4.  The long-Seq1 regime and one device agree with the JAX
    package's, and a char split never leaves a chunk under 256 positions."""
    assert mesh.choose_mesh_shape(8, 90001, 500) == jmesh.choose_mesh_shape(8, 90001, 500) == (8, 1)
    assert mesh.choose_mesh_shape(1, 90001, 10000) == (1, 1)
    assert mesh.choose_mesh_shape(8, 90001, 10000) == (8, 1)
    assert jmesh.choose_mesh_shape(8, 90001, 10000)[1] > 1
    assert mesh.choose_mesh_shape(4, 350001, 250000) == (4, 1)
    for ndev in (1, 2, 4, 6, 8):
        n_op, n_ch = mesh.choose_mesh_shape(ndev, 7581, 2131)
        assert n_op * n_ch == ndev
    # the link term is what a char split pays: 20 bytes per owned offset
    # from each other chunk, at the card's measured pairs per NVLink byte
    assert mesh._PAIRS_PER_NVLINK_BYTE == pytest.approx(6.1e12 / 450e9, rel=0.01)


def test_search_sharded_auto_env_override(monkeypatch):
    rng = np.random.default_rng(37)
    c1, c2 = random_codes(rng, 2000), random_codes(rng, 400)
    t = build_tables(np.array(W), False)
    calls = []
    real = mesh.search_sharded_2d
    monkeypatch.setattr(mesh, "search_sharded_2d",
                        lambda *a, **k: calls.append(len(a[3])) or real(*a, **k))
    ref = numpy_ref(W, False, c1, c2)
    assert tup(mesh.search_sharded_auto(c1, c2, t, cpu(8))) == ref
    assert calls == []
    monkeypatch.setenv("PSA_MESH_SHAPE", "2,4")
    got = mesh.search_sharded_auto(c1, c2, t, cpu(8))
    want = jmesh.search_sharded_auto(c1, c2, jax_build_tables(np.array(W), False))
    assert tup(got) == tup(want) == ref
    assert calls == [2]
    monkeypatch.setenv("PSA_MESH_SHAPE", "3,2")
    with pytest.raises(ValueError):
        mesh.search_sharded_auto(c1, c2, t, cpu(8))


def test_mesh_construction():
    assert mesh.make_mesh(cpu(3)) == [torch.device("cpu")] * 3
    assert [len(r) for r in mesh.make_mesh_2d(cpu(8), 2, 4)] == [4, 4]
    with pytest.raises(ValueError):
        mesh.make_mesh_2d(cpu(4), 2, 4)
    with pytest.raises(ValueError):
        mesh.make_mesh([])
    c1p, c2p, noff = mesh.pad_for_mesh(np.zeros(1000, np.int32),
                                       np.zeros(100, np.int32), 4)
    assert (noff, c1p.shape[0] - c2p.shape[0], c2p.shape[0]) == (901, 1024, 128)
    c1p, c2p, noff = mesh.pad_for_mesh_2d(np.zeros(1000, np.int32),
                                          np.zeros(100, np.int32), 2, 4)
    assert (c1p.shape[0] - c2p.shape[0], c2p.shape[0]) == (2048, 128)
    with pytest.raises(ValueError):
        mesh.pad_for_mesh(np.zeros(10, np.int32), np.zeros(11, np.int32), 2)


def test_default_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mesh.make_mesh()
    with pytest.raises(RuntimeError):
        mesh.search_sharded_auto(np.zeros(100, np.int32), np.zeros(10, np.int32),
                                 build_tables(np.array(W), False))


def test_engine_and_sharded_agree_on_the_card_path_winner():
    """The 1-shard mesh is the engine's device path: the same winner as
    AlignmentSearchEngine(backend="torch") on the CPU."""
    rng = np.random.default_rng(11)
    c1, c2 = random_codes(rng, 6000), random_codes(rng, 150)
    t = build_tables(np.array(W), False)
    eng = AlignmentSearchEngine(W, False, device="cpu")
    assert tup(mesh.search_sharded(c1, c2, t, cpu(1))) == tup(eng.search_codes(c1, c2))
