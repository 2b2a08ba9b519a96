"""The port's differential engines (psa_torch.ops.engine_xla and
engine_conv) on the CPU against the JAX package's `xla` and `conv` engines
and its numpy oracle: the same numpy codes from one seed through each,
stats compared integer for integer (tolerance 0), winners and output bytes
exactly.  The cases follow tests/test_engines.py.  Also the sharded paths'
`kernel="xla"` against the JAX package's on its 8-device virtual mesh."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from psa_tpu.core.alphabet import OTHER_CODE
from psa_tpu.core.oracle import offset_stats_numpy as jax_oracle
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models import batch as jbatch
from psa_tpu.models.search import AlignmentSearchEngine as JaxEngine
from psa_tpu.ops.engine_conv import offset_stats_conv as jax_conv
from psa_tpu.ops.engine_xla import offset_stats_xla as jax_xla
from psa_tpu.parallel import mesh as jmesh
from psa_tpu.parallel import multihost as jmh
from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils.io import Query as JaxQuery

from psa_torch.core.tables import build_tables
from psa_torch.models import batch
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops import engine_conv, engine_xla
from psa_torch.parallel import mesh, multihost
from psa_torch.utils import cli, generator
from psa_torch.utils.generator import random_sequences, write_input_file
from psa_torch.utils.io import Query

from conftest import random_codes, random_seq

ENGINES = ["xla", "conv"]

WEIGHT_SETS = [
    (1.0, 3.0, 4.0, 2.0),   # golden weights
    (5.0, 1.0, 1.0, 1.0),   # ties between dot/space diffs
    (2.0, 2.0, 2.0, 2.0),   # everything ties
    (1.5, 0.25, 3.75, 0.5), # exact binary fractions
    (-1.0, 2.0, -3.0, 4.0), # negative weights (legal per fscanf %lf)
]


def port_stats(engine, tables):
    fn = {"xla": engine_xla.offset_stats_xla,
          "conv": engine_conv.offset_stats_conv}[engine]
    return lambda c1, c2: fn(c1, c2, tables, "cpu")


def jax_stats(engine, tables):
    fn = {"xla": jax_xla, "conv": jax_conv}[engine]
    return lambda c1, c2: fn(c1, c2, tables)


def assert_stats_equal(engine, w, is_max, c1, c2):
    """The port's engine against the JAX package's and the numpy oracle,
    integer for integer, and both outputs int32 of the oracle's shapes."""
    counts, maxrank = port_stats(engine, build_tables(np.array(w), is_max))(c1, c2)
    jt = jax_build_tables(np.array(w), is_max)
    jc, jm = jax_stats(engine, jt)(c1, c2)
    oc, om = jax_oracle(c1, c2, jt)
    assert counts.dtype == np.int32 and maxrank.dtype == np.int32
    np.testing.assert_array_equal(counts, oc)
    np.testing.assert_array_equal(maxrank, om)
    np.testing.assert_array_equal(counts, np.asarray(jc))
    np.testing.assert_array_equal(maxrank, np.asarray(jm))


def tup(r):
    return (r.offset, r.char_offset, r.sub_code, r.score)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("is_max", [True, False])
def test_stats_match_jax_and_oracle_random(engine, is_max):
    rng = np.random.default_rng(42 + is_max)
    for n1, n2 in [(300, 40), (845, 400), (513, 512)]:
        assert_stats_equal(engine, (1.0, 3.0, 4.0, 2.0), is_max,
                           random_codes(rng, n1), random_codes(rng, n2))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("weights", WEIGHT_SETS)
def test_stats_match_jax_over_weight_sets(engine, weights):
    rng = np.random.default_rng(hash(weights) % 2**32)
    for is_max in (True, False):
        assert_stats_equal(engine, weights, is_max, random_codes(rng, 1400),
                           random_codes(rng, 600))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("weights", WEIGHT_SETS)
def test_end_to_end_matches_jax_numpy(engine, weights):
    rng = np.random.default_rng(hash(weights) % 2**32)
    for is_max in (True, False):
        c1 = random_codes(rng, 700)
        c2 = random_codes(rng, 150)
        want = JaxEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
        got = AlignmentSearchEngine(weights, is_max, backend=engine,
                                    device="cpu").search_codes(c1, c2)
        assert tup(got) == tup(want)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("noff", [511, 512, 1025])
def test_stats_at_block_edges(engine, noff):
    """Unpadded sequences whose offsets end just before, at and just past a
    whole number of the gather engine's 512-offset blocks."""
    rng = np.random.default_rng(noff)
    for is_max in (False, True):
        c2 = random_codes(rng, 97)
        assert_stats_equal(engine, (1.0, 3.0, 4.0, 2.0), is_max,
                           random_codes(rng, noff + 96), c2)


@pytest.mark.parametrize("engine", ENGINES)
def test_degenerate_shapes(engine):
    """n2 == n1, a one-character Seq2, all hyphens."""
    cases = [
        (np.zeros(64, np.int32), np.zeros(64, np.int32)),
        (np.arange(26, dtype=np.int32).repeat(3), np.array([0], np.int32)),
        (np.full(100, 26, np.int32), np.full(30, 26, np.int32)),
        (np.arange(27, dtype=np.int32).repeat(20), np.arange(27, dtype=np.int32).repeat(20)),
    ]
    for is_max in (False, True):
        for c1, c2 in cases:
            assert_stats_equal(engine, (1.0, 3.0, 4.0, 2.0), is_max, c1, c2)


@pytest.mark.parametrize("engine", ENGINES)
def test_no_ranks_matches_jax(engine):
    """A table set with no substitution rank (num_ranks == 0): the conv
    engine answers from the numpy oracle, as the JAX package's does; the
    gather engine decodes the same codes."""
    rng = np.random.default_rng(5)
    c1, c2 = random_codes(rng, 400), random_codes(rng, 70)
    port = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    port = dataclasses.replace(port, diff_vals=np.zeros(0))
    jt = jax_build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    jt = dataclasses.replace(jt, diff_vals=np.zeros(0))
    assert port.num_ranks == jt.num_ranks == 0
    counts, maxrank = port_stats(engine, port)(c1, c2)
    jc, jm = jax_stats(engine, jt)(c1, c2)
    np.testing.assert_array_equal(counts, np.asarray(jc))
    np.testing.assert_array_equal(maxrank, np.asarray(jm))


@pytest.mark.parametrize("engine", ENGINES)
def test_lenient_other_chars(engine):
    """Out-of-alphabet codes weigh 0 and never substitute in either
    engine."""
    rng = np.random.default_rng(77)
    c1 = random_codes(rng, 500)
    c2 = random_codes(rng, 120)
    c1[::7] = OTHER_CODE
    c2[::11] = OTHER_CODE
    assert_stats_equal(engine, (1.0, 3.0, 4.0, 2.0), False, c1, c2)


def test_stats_from_codevals_matches_jax():
    from psa_tpu.ops.engine_xla import stats_from_codevals as jax_decode

    rng = np.random.default_rng(3)
    cv = rng.integers(0, 127, (7, 300)).astype(np.int32)
    cv[2] = 0
    counts, maxrank = engine_xla.stats_from_codevals(torch.from_numpy(cv))
    jc, jm = jax_decode(jax.numpy.asarray(cv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(maxrank.numpy(), np.asarray(jm))


def test_xla_blocks_past_one_block_and_ragged():
    """Widths past one 512-offset block, and a last block shorter than 512,
    equal the oracle (the sharded views take any width)."""
    rng = np.random.default_rng(11)
    tables = build_tables(np.array([2.0, 1.0, 3.0, 0.5]), True)
    c1, c2 = random_codes(rng, 1500), random_codes(rng, 90)
    want_c, want_m = jax_oracle(c1, c2, jax_build_tables(np.array([2.0, 1.0, 3.0, 0.5]),
                                                          True))
    for width in (1, 511, 513, 1300, 1411):
        st = engine_xla.stats5_xla(torch.from_numpy(c1.astype(np.uint8)),
                                   torch.from_numpy(c2.astype(np.uint8)),
                                   torch.from_numpy(tables.code), width).numpy()
        np.testing.assert_array_equal(st[:4].T, want_c[:width])
        np.testing.assert_array_equal(st[4], want_m[:width])
    with pytest.raises(ValueError):
        engine_xla.stats5_xla(torch.zeros(100, dtype=torch.uint8),
                              torch.zeros(50, dtype=torch.uint8),
                              torch.from_numpy(tables.code), 52)


def test_conv_integer_check_raises_and_never_runs_in_bf16():
    """A non-integer output raises rather than rounding it away; operands in
    a low precision are refused; a caller's bf16 autocast does not reach
    the conv."""
    with pytest.raises(RuntimeError, match="from an integer"):
        engine_conv.exact_int32(torch.tensor([[1.0, 2.0], [3.0, 4.3]]))
    np.testing.assert_array_equal(
        engine_conv.exact_int32(torch.tensor([2.9999999, -0.0000001, 7.0])).numpy(),
        [3, 0, 7])
    x = torch.zeros(1, 32, 40, dtype=torch.bfloat16)
    k = torch.zeros(5, 32, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        engine_conv.conv1d_f32(x, k)
    # 600 equal characters: counts of 600 are not exact in bf16 (> 256)
    c1 = np.zeros(1200, np.int32)
    c2 = np.zeros(600, np.int32)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    with torch.autocast(device_type="cpu", dtype=torch.bfloat16):
        counts, maxrank = engine_conv.offset_stats_conv(c1, c2, tables, "cpu")
    oc, om = jax_oracle(c1, c2, jax_build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False))
    np.testing.assert_array_equal(counts, oc)
    np.testing.assert_array_equal(maxrank, om)
    assert counts[:, 0].max() == 600


def test_grouped_conv_matches_per_query_stats():
    """The batched forms timed on the card (a grouped conv1d over B queries
    and one conv1d of B x F filters on a shared Seq1) decode to each
    query's stats5."""
    rng = np.random.default_rng(21)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    code = torch.from_numpy(tables.code)
    b, n1, n2 = 3, 500, 90
    c1b = torch.from_numpy(rng.integers(0, 27, (b, n1)).astype(np.uint8))
    c2b = torch.from_numpy(rng.integers(0, 27, (b, n2)).astype(np.uint8))
    k = engine_conv.indicator_filter(code, c2b, tables.num_ranks)   # (B, F, 32, n2)
    f = k.shape[1]
    x = engine_conv.onehot_seq1(c1b).reshape(1, b * 32, n1)
    grouped = engine_conv.stats5_from_conv(
        engine_conv.conv1d_f32(x, k.reshape(b * f, 32, n2), groups=b).reshape(b, f, -1))
    shared = engine_conv.stats5_from_conv(engine_conv.conv1d_f32(
        engine_conv.onehot_seq1(c1b[0])[None], k.reshape(b * f, 32, n2)).reshape(b, f, -1))
    jt = jax_build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    for q in range(b):
        oc, om = jax_oracle(c1b[q].numpy().astype(np.int32),
                            c2b[q].numpy().astype(np.int32), jt)
        np.testing.assert_array_equal(grouped[q, :4].T.numpy(), oc)
        np.testing.assert_array_equal(grouped[q, 4].numpy(), om)
        sc, sm = jax_oracle(c1b[0].numpy().astype(np.int32),
                            c2b[q].numpy().astype(np.int32), jt)
        np.testing.assert_array_equal(shared[q, :4].T.numpy(), sc)
        np.testing.assert_array_equal(shared[q, 4].numpy(), sm)


@pytest.mark.parametrize("engine", ENGINES)
def test_search_batch_matches_jax(engine):
    rng = np.random.default_rng(9)
    qs = []
    for i in range(5):
        qs.append(((1.0, 3.0, 4.0, 2.0), random_seq(rng, 600 + 40 * i),
                   random_seq(rng, 80 + 10 * i), bool(i % 2)))
    ref = random_seq(rng, 900)
    for n2 in (60, 50):
        qs.append(((2.0, 1.0, 5.0, 0.5), ref, random_seq(rng, n2), True))
    got = batch.search_batch([Query(np.asarray(w), a, b, m) for w, a, b, m in qs],
                             backend=engine, device="cpu")
    want = jbatch.search_batch([JaxQuery(np.asarray(w), a, b, m)
                                for w, a, b, m in qs], backend="numpy")
    assert [tup(r) for r in got] == [tup(r) for r in want]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("is_max", [False, True])
def test_cli_bytes_match_jax_numpy(engine, is_max, tmp_path, capsys):
    s1, s2 = random_sequences(2500, 300, seed=11 + is_max, hyphen_p=0.03)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), (1.0, 3.0, 4.0, 2.0), s1, s2, is_max)
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert cli.main([str(inp), "-o", str(a), "--backend", engine, "--device",
                     "cpu", "--quiet"]) == 0
    assert jax_cli.main([str(inp), "-o", str(b), "--backend", "numpy",
                         "--quiet"]) == 0
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("engine", ENGINES)
def test_cli_batch_bytes_match_jax_numpy(engine, tmp_path, capsys):
    from test_torch_batch import write_cases

    cases = tmp_path / "cases.txt"
    write_cases(cases, generator.main)
    rc = cli.main([str(cases), "--batch", "--backend", engine, "--device", "cpu",
                   "--lenient", "--json", "-o", str(tmp_path / "outs")])
    got = capsys.readouterr().out.splitlines()
    jrc = jax_cli.main([str(cases), "--batch", "--backend", "numpy",
                        "--lenient", "--json", "-o", str(tmp_path / "outs2")])
    want = capsys.readouterr().out.splitlines()
    assert rc == jrc == 1
    names = sorted(p.name for p in (tmp_path / "outs").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "outs2").iterdir())
    assert len(names) == 11
    for n in names:
        assert ((tmp_path / "outs" / n).read_bytes()
                == (tmp_path / "outs2" / n).read_bytes()), n

    def strip(lines):
        return [{k: v for k, v in json.loads(ln).items() if k != "time_s"}
                for ln in lines]

    assert strip(got) == strip(want)


def test_engines_need_a_card_unless_asked(monkeypatch, tmp_path, capsys):
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), (1.0, 3.0, 4.0, 2.0), "ABCDEFGH", "CDE", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ENGINES:
        with pytest.raises(RuntimeError):
            AlignmentSearchEngine((1, 3, 4, 2), False, backend=engine)
        with pytest.raises(RuntimeError):
            batch.search_batch([Query(np.array([1.0, 3, 4, 2]), "ABCDEFG", "ABC",
                                      False)], backend=engine)
        for extra in ([], ["--batch"], ["--sharded"]):
            assert cli.main([str(inp), "--backend", engine, "--quiet", "-o",
                             str(tmp_path / "out"), *extra]) == 2
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("is_max", [False, True])
def test_sharded_xla_matches_jax(n, is_max):
    rng = np.random.default_rng(70 + is_max)
    w = [2.0, 1.0, 3.0, 0.5] if is_max else [1.0, 3.0, 4.0, 2.0]
    c1, c2 = random_codes(rng, 4200), random_codes(rng, 150)
    mesh.fallbacks = 0
    got = tup(mesh.search_sharded(c1, c2, build_tables(np.array(w), is_max),
                                  ["cpu"] * n, kernel="xla"))
    want = tup(jmesh.search_sharded(c1, c2, jax_build_tables(np.array(w), is_max),
                                    jmesh.make_mesh(jax.devices()[:n]), kernel="xla"))
    assert got == want == tup(JaxEngine(w, is_max, backend="numpy").search_codes(c1, c2))
    assert mesh.fallbacks == 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (2, 4)])
def test_sharded_2d_xla_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = [1.0, 3.0, 4.0, 2.0]
    c1, c2 = random_codes(rng, 3000), random_codes(rng, 700)
    n_op, n_ch = shape
    got = tup(mesh.search_sharded_2d(c1, c2, build_tables(np.array(w), False),
                                     mesh.make_mesh_2d(["cpu"] * (n_op * n_ch), n_op, n_ch),
                                     kernel="xla"))
    jm = jmesh.make_mesh_2d(jax.devices()[: n_op * n_ch], n_op, n_ch)
    want = tup(jmesh.search_sharded_2d(c1, c2, jax_build_tables(np.array(w), False),
                                       jm, kernel="xla"))
    assert got == want


def test_sharded_offset_stats_xla_and_fallback():
    """kernel="xla" gives the sweep's stats5; the all-ties fallback runs on
    it too; an unknown kernel is refused."""
    rng = np.random.default_rng(4)
    tables = build_tables(np.array([2.0, 1.0, 3.0, 0.5]), True)
    c1, c2 = random_codes(rng, 2500), random_codes(rng, 300)
    c1p, c2p, _ = mesh.pad_for_mesh(c1, c2, 8)
    a = mesh.sharded_offset_stats(c1p, c2p, tables, ["cpu"] * 8, kernel="xla")
    b = mesh.sharded_offset_stats(c1p, c2p, tables, ["cpu"] * 8)
    assert torch.equal(a, b)
    ties1, ties2 = np.zeros(3000, np.int32), np.zeros(300, np.int32)
    w = [1.0, 3.0, 4.0, 2.0]
    mesh.fallbacks = 0
    got = tup(mesh.search_sharded(ties1, ties2, build_tables(np.array(w), False),
                                  ["cpu"] * 4, kernel="xla"))
    assert mesh.fallbacks == 1
    assert got == tup(JaxEngine(w, False, backend="numpy").search_codes(ties1, ties2))
    with pytest.raises(ValueError, match="shard kernel"):
        mesh.search_sharded(c1, c2, tables, ["cpu"], kernel="conv")


@pytest.mark.parametrize("is_max,seed", [(False, 3), (True, 4)])
def test_run_distributed_search_xla_matches_jax(tmp_path, capsys, is_max, seed):
    s1, s2 = random_sequences(1500, 300, seed=seed)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [2.0, 1.0, 0.5, 3.0], s1, s2, is_max)
    out, ref = tmp_path / "out.txt", tmp_path / "ref.txt"
    assert multihost.run_distributed_search(str(inp), str(out), backend_kernel="xla",
                                            mesh=["cpu"] * 4) == 0
    assert jmh.run_distributed_search(str(inp), str(ref), backend_kernel="xla") == 0
    assert out.read_bytes() == ref.read_bytes()
    sharded = tmp_path / "sharded.txt"
    assert cli.main([str(inp), "-o", str(sharded), "--sharded", "--backend", "xla",
                     "--device", "cpu", "--quiet"]) == 0
    assert sharded.read_bytes() == ref.read_bytes()
    assert "warning" not in capsys.readouterr().err


def test_sharded_cli_warns_for_backends_without_a_sharded_path(tmp_path, capsys):
    s1, s2 = random_sequences(900, 100, seed=8)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [1.0, 3.0, 4.0, 2.0], s1, s2, False)
    outs = {}
    for backend in ("conv", "numpy", "torch"):
        outs[backend] = tmp_path / f"{backend}.txt"
        assert cli.main([str(inp), "-o", str(outs[backend]), "--sharded",
                         "--backend", backend, "--device", "cpu", "--quiet"]) == 0
        err = capsys.readouterr().err
        assert ("has no sharded path" in err) == (backend != "torch")
    assert outs["conv"].read_bytes() == outs["torch"].read_bytes() == outs["numpy"].read_bytes()
