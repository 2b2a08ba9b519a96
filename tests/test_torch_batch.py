"""The port's batch path (psa_torch.models.batch, the batched sweeps of
psa_torch.ops.sweep, the `--batch` CLI and `psa-torch-gen`) against the JAX
package: the Pallas batched kernels in interpret mode, its exact batch
search, its native multi-query re-scorer and its CLI.  On the CPU the
batched wrappers run their plain PyTorch versions.  Sweep statistics are
exact integers and winners are exact (offset, char_offset, sub_code,
score) tuples, so every comparison is equality."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psa_tpu import native as jnative
from psa_tpu.core.alphabet import encode_batch_padded as jax_encode_batch_padded
from psa_tpu.core.alphabet import validate_batch as jax_validate_batch
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models import batch as jbatch
from psa_tpu.ops import pallas_sweep as ps
from psa_tpu.ops.common import keyed_f32_totals_ops as jax_keyed_ops
from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils import generator as jax_gen
from psa_tpu.utils.io import Query as JaxQuery

from psa_torch.core.alphabet import OTHER_CODE, PAD_CODE, encode_batch_checked, validate_batch
from psa_torch.core.oracle import rescore_multi
from psa_torch.core.result import NoMutationFound
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops import select
from psa_torch.ops import sweep as sw
from psa_torch.ops.common import keyed_f32_totals_ops
from psa_torch.utils import cli, generator
from psa_torch.utils.io import Query

from conftest import random_codes, random_seq

W = np.array([1.0, 3.0, 4.0, 2.0])
IRRATIONAL = np.array([np.pi / 4, np.e / 7, np.sqrt(2) / 3, 1 / 3])


def pad_rows(rows, length):
    out = np.full((len(rows), length), PAD_CODE, np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def rows_batch(rng, b, n1, n2, hyphen_p=0.05):
    return ([random_codes(rng, n1, hyphen_p) for _ in range(b)],
            [random_codes(rng, n2, hyphen_p) for _ in range(b)])


def port_shapes(c1s, c2s):
    """(noff_pad, l2p, l1k) of the port's bucket holding these rows: the
    offsets padded to the longest row in whole warp tiles."""
    l2p = sw.round_up(max(len(c) for c in c2s), sw.L2_ALIGN)
    noff = max(len(a) - len(b) + 1 for a, b in zip(c1s, c2s))
    noff_pad = sw.round_up(noff, sw.TILE_O)
    assert (noff_pad, noff_pad + l2p) == sw.plan_bucket(
        [len(a) - len(b) + 1 for a, b in zip(c1s, c2s)], l2p)
    return noff_pad, l2p, noff_pad + l2p


def stats5_of_pallas(out):
    """The TPU kernel's (B, 8, NP) output as stats5: rows 0-3, maxrank."""
    out = np.asarray(out)
    return np.concatenate([out[:, :4], ps.maxrank_from_maxcode(out[:, 4:5])],
                          axis=1)


def jax_shapes(c1s, c2s):
    l2p = ps.round_up(max(len(c) for c in c2s), 128)
    noff = max(len(a) - len(b) + 1 for a, b in zip(c1s, c2s))
    noff_pad = ps.round_up(noff, 512)
    return noff_pad, l2p, noff_pad + l2p


def code_tensor(tables):
    return torch.from_numpy(np.ascontiguousarray(tables.code))


# --- the batched sweeps against the Pallas kernels --------------------------

@pytest.mark.parametrize("b,n1,n2", [(6, 700, 120), (3, 4000, 300)])
def test_sweep_batched_matches_fused_stats5(b, n1, n2):
    rng = np.random.default_rng(b * 1000 + n2)
    c1s, c2s = rows_batch(rng, b, n1, n2)
    t = build_tables(W, False)
    _, l2p, l1k = port_shapes(c1s, c2s)
    got = batch.fused_stats5_from_codes(
        torch.from_numpy(pad_rows(c1s, l1k)),
        torch.from_numpy(pad_rows(c2s, l2p)), code_tensor(t)).numpy()
    _, jl2p, jl1k = jax_shapes(c1s, c2s)
    want = np.asarray(jbatch._fused_stats5_from_codes(
        jnp.asarray(pad_rows(c1s, jl1k)), jnp.asarray(pad_rows(c2s, jl2p)),
        jnp.asarray(jax_build_tables(W, False).code), b, jl1k, jl2p, True))
    noff = n1 - n2 + 1
    np.testing.assert_array_equal(got[:, :, :noff], want[:, :, :noff])


@pytest.mark.parametrize("resident", [True, False])
def test_sweep_batched_matches_pallas_resident_and_streaming(resident):
    """B = 3 of 4000x300 against both variants of the TPU kernel (the
    port has one)."""
    rng = np.random.default_rng(11)
    b, n1, n2 = 3, 4000, 300
    c1s, c2s = rows_batch(rng, b, n1, n2)
    t = build_tables(W, False)
    _, l2p, l1k = port_shapes(c1s, c2s)
    got = sw.sweep_batched(torch.from_numpy(pad_rows(c1s, l1k)),
                           torch.from_numpy(pad_rows(c2s, l2p)),
                           code_tensor(t)).numpy()
    jl2p, noff_pad = 512, 4096
    jl1k = noff_pad + jl2p
    c1b, c2b = pad_rows(c1s, jl1k), pad_rows(c2s, jl2p)
    chunk = ps.pick_chunk(jl2p)
    nck = jl2p // chunk
    pc = jnp.asarray(t.code).astype(jnp.int8)[:, jnp.asarray(c2b).astype(jnp.int32)]
    pc_all = (pc.transpose(1, 0, 2).reshape(b, 32, nck, chunk)
              .transpose(0, 2, 1, 3)[:, :, :, ::-1])
    s1c = jnp.broadcast_to(jnp.asarray(c1b).reshape(1, -1).astype(jnp.int8),
                           (4, b * jl1k))
    want = np.asarray(ps._sweep_pallas_batched(s1c, pc_all, b, noff_pad, jl2p,
                                               True, 2048, resident))
    noff = n1 - n2 + 1
    assert got.shape == (b, 5, l1k - l2p)
    np.testing.assert_array_equal(got[:, :, :noff],
                                  stats5_of_pallas(want)[:, :, :noff])


def test_sweep_batched_shared_matches_fused_stats5_shared():
    rng = np.random.default_rng(202)
    b, n1, n2 = 5, 700, 120
    c1 = random_codes(rng, n1, 0.05)
    c2s = [random_codes(rng, n2, 0.05) for _ in range(b)]
    c2s[2][:] = OTHER_CODE
    t = build_tables(W, False)
    _, l2p, l1k = port_shapes([c1], c2s)
    got = batch.fused_stats5_from_codes_shared(
        torch.from_numpy(pad_rows([c1], l1k)[0]),
        torch.from_numpy(pad_rows(c2s, l2p)), code_tensor(t)).numpy()
    _, jl2p, jl1k = jax_shapes([c1], c2s)
    want = np.asarray(jbatch._fused_stats5_from_codes_shared(
        jnp.asarray(pad_rows([c1], jl1k)[0]), jnp.asarray(pad_rows(c2s, jl2p)),
        jnp.asarray(t.code), b, jl1k, jl2p, True))
    noff = n1 - n2 + 1
    np.testing.assert_array_equal(got[:, :, :noff], want[:, :, :noff])


@pytest.mark.parametrize("tile", [512, 1024])
def test_sweep_batched_shared_multi_tile_matches_pallas(tile):
    """The multi-tile shape of the JAX package's shared-kernel test: 4
    queries of 2600x500, several offset tiles on both sides."""
    rng = np.random.default_rng(606)
    b, n1, n2 = 4, 2600, 500
    c1 = random_codes(rng, n1, 0.05)
    c2s = [random_codes(rng, n2, 0.05) for _ in range(b)]
    t = build_tables(W, False)
    noff_pad, l2p, l1k = port_shapes([c1], c2s)
    assert noff_pad // sw.TILE_O >= 2
    got = sw.sweep_batched_shared(torch.from_numpy(pad_rows([c1], l1k)[0]),
                                  torch.from_numpy(pad_rows(c2s, l2p)),
                                  code_tensor(t)).numpy()
    _, jnoff_pad, jl2p, jl1k = ps.plan_shapes(n1, n2)
    c2b = pad_rows(c2s, jl2p)
    chunk = ps.pick_chunk(jl2p)
    nck = jl2p // chunk
    pc = t.code.astype(np.int8)[:, c2b.astype(np.int32)]
    pc_all = (pc.transpose(1, 0, 2).reshape(b, 32, nck, chunk)
              .transpose(0, 2, 1, 3)[:, :, :, ::-1])
    s1c = np.broadcast_to(pad_rows([c1], jl1k).astype(np.int8), (4, jl1k))
    want = np.asarray(ps._sweep_pallas_batched_shared(
        jnp.asarray(s1c), jnp.asarray(pc_all), b, jnoff_pad, jl2p, True, tile))
    # the TPU kernel computes whole tiles only
    end = min(n1 - n2 + 1, jnoff_pad // tile * tile)
    np.testing.assert_array_equal(got[:, :, :end],
                                  stats5_of_pallas(want)[:, :, :end])


def test_shared_equals_per_row_on_broadcast_rows():
    rng = np.random.default_rng(5)
    c1 = random_codes(rng, 1500, 0.05)
    c2s = [random_codes(rng, n, 0.05) for n in (40, 64, 7, 64)]
    _, l2p, l1k = port_shapes([c1], c2s)
    c1r = torch.from_numpy(pad_rows([c1], l1k)[0])
    c2b = torch.from_numpy(pad_rows(c2s, l2p))
    code = code_tensor(build_tables(IRRATIONAL, True))
    shared = sw.sweep_batched_shared(c1r, c2b, code)
    per_row = sw.sweep_batched(c1r.expand(4, -1).contiguous(), c2b, code)
    assert torch.equal(shared, per_row)


def test_batched_operands_are_checked():
    code = code_tensor(build_tables(W, False))
    c1b = torch.full((2, 1024 + 64), PAD_CODE, dtype=torch.uint8)
    c2b = torch.full((2, 64), PAD_CODE, dtype=torch.uint8)
    assert sw.sweep_batched(c1b, c2b, code).shape == (2, 5, 1024)
    with pytest.raises(ValueError):
        sw.sweep_batched(c1b[:1], c2b, code)              # row counts differ
    with pytest.raises(ValueError):
        sw.sweep_batched_shared(c1b, c2b, code)           # shared takes one row
    with pytest.raises(ValueError):
        sw.sweep_batched(c1b[:, :1000], c2b, code)        # noff_pad not a tile
    with pytest.raises(TypeError):
        sw.sweep_batched(c1b.to(torch.int32), c2b, code)


# --- helpers of the batch path ---------------------------------------------

def test_keyed_totals_per_row_noff_matches_jax():
    rng = np.random.default_rng(3)
    t = build_tables(IRRATIONAL, False)
    b, np_len = 4, 1024
    counts = rng.integers(0, 30, (b, 4, np_len)).astype(np.int32)
    maxrank = rng.integers(-1, t.num_ranks, (b, np_len)).astype(np.int32)
    noffs = np.array([1, 300, 1024, 777], np.int32)
    dt = device_tables(t, "cpu")
    keyed, total = keyed_f32_totals_ops(torch.from_numpy(counts),
                                        torch.from_numpy(maxrank), dt.w32,
                                        dt.diff32, False,
                                        torch.from_numpy(noffs))
    jk, jt = jax_keyed_ops(counts, maxrank, dt.w32.numpy(), dt.diff32.numpy(),
                           False, noffs, counts_axis=-2)
    np.testing.assert_array_equal(keyed.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(total.numpy(), np.asarray(jt))


def test_encode_and_validate_batch_match_jax():
    seqs = ["ABC", "", "HELLO-WORLD", "abc", "Z" * 40, "A?B"]
    codes, ok = encode_batch_checked(seqs, 48)
    np.testing.assert_array_equal(codes, jax_encode_batch_padded(seqs, 48))
    np.testing.assert_array_equal(validate_batch(seqs), jax_validate_batch(seqs))
    np.testing.assert_array_equal(ok, jax_validate_batch(seqs))
    assert codes.dtype == np.uint8
    with pytest.raises(ValueError):
        encode_batch_checked(seqs, 39)


def test_microbatch_spans():
    assert batch.microbatch_spans(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert batch.microbatch_spans(4, 1024) == [(0, 4)]


@pytest.mark.parametrize("is_max", [False, True])
def test_rescore_multi_bit_equal_to_native(is_max):
    rng = np.random.default_rng(41 + is_max)
    t = build_tables(IRRATIONAL, is_max)
    b, l1, l2 = 7, 400, 96
    c1b = rng.integers(0, 29, (b, l1)).astype(np.int32)
    c2b = rng.integers(0, 28, (b, l2)).astype(np.int32)
    n2s = rng.integers(1, l2 + 1, b).astype(np.int32)
    n2s[3] = l2
    qidx = rng.integers(0, b, 200).astype(np.int32)
    offs = np.array([rng.integers(0, l1 - n2s[q] + 1) for q in qidx], np.int64)
    got = rescore_multi(c1b.astype(np.uint8), c2b.astype(np.uint8), n2s, t,
                        qidx, offs)
    want = jnative.rescore_multi_native(c1b, c2b, n2s, jax_build_tables(
        IRRATIONAL, is_max), qidx, offs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("is_max", [False, True])
def test_select_rows_vectorized_matches_jax(is_max):
    """The same fetched candidates through the port's band and pick
    (ops/select.py) and the JAX package's vectorized host selection."""
    rng = np.random.default_rng(9 + is_max)
    t = build_tables(W, is_max)
    b, n1, n2 = 6, 700, 120
    c1s, c2s = rows_batch(rng, b, n1, n2)
    _, l2p, l1k = port_shapes(c1s, c2s)
    c1b, c2b = pad_rows(c1s, l1k), pad_rows(c2s, l2p)
    noffs = np.full(b, n1 - n2 + 1, np.int32)
    n2s = np.full(b, n2, np.int32)
    dt = device_tables(t, "cpu")
    packed = batch.run_exact_batch(torch.from_numpy(c1b), torch.from_numpy(c2b),
                                   torch.from_numpy(noffs), dt).numpy()
    topi, stats_k, near, best = batch.unpack_epilogue_outputs(packed, batch.TOPK)
    stats_k = np.swapaxes(stats_k, 1, 2)
    rows = np.nonzero(near <= batch.TOPK)[0]
    ri, offs = select.band_candidates(topi[rows], stats_k[rows], noffs[rows],
                                      n2s[rows], t)
    got = select.pick_rows(c1b, c2b, n2s, t, rows[ri], offs, b)
    want = [None] * b
    jbatch._select_rows_vectorized(want, rows, c1b.astype(np.int32),
                                   c2b.astype(np.int32), noffs, n2s,
                                   jax_build_tables(W, is_max), topi, stats_k)
    assert len(rows) == b
    assert [astuple(r) for r in got] == [astuple(r) for r in want]


# --- batched_search_exact ---------------------------------------------------

def astuple(r):
    return None if r is None else (r.offset, r.char_offset, r.sub_code, r.score)


def mixed_rows():
    """A batch of one bucket: ordinary rows of varied lengths, a periodic
    Seq1 whose f32 near-tie band floods past k, and an all-OTHER row that
    has no mutation."""
    rng = np.random.default_rng(85)
    c1s = [random_codes(rng, n) for n in (600, 700, 650, 500)]
    c2s = [random_codes(rng, n) for n in (50, 64, 40, 64)]
    c1s.insert(1, np.tile(np.array([0, 1], np.int32), 350))
    c2s.insert(1, np.tile(np.array([0, 1], np.int32), 32))
    c1s.append(np.full(600, OTHER_CODE, np.int32))
    c2s.append(np.full(60, OTHER_CODE, np.int32))
    return c1s, c2s


def shared_rows():
    """One periodic Seq1 for every row: one Seq2 floods the band, one is
    all-OTHER (no mutation), the rest are random."""
    rng = np.random.default_rng(86)
    c1 = np.tile(np.array([0, 1], np.int32), 350)
    c2s = [random_codes(rng, n) for n in (50, 64, 37)]
    c2s.insert(1, np.tile(np.array([0, 1], np.int32), 32))
    c2s.append(np.full(64, OTHER_CODE, np.int32))
    return [c1] * len(c2s), c2s


_JAX_WINNERS: dict = {}


def jax_winners(kind, is_max):
    """psa_tpu's batched_search_exact (Pallas in interpret mode), once per
    (batch, mode)."""
    key = (kind, is_max)
    if key not in _JAX_WINNERS:
        c1s, c2s = mixed_rows() if kind == "mixed" else shared_rows()
        _, l2p, l1k = jax_shapes(c1s, c2s)
        rs = jbatch.batched_search_exact(
            pad_rows(c1s, l1k), pad_rows(c2s, l2p),
            np.array([len(a) - len(b) + 1 for a, b in zip(c1s, c2s)], np.int32),
            np.array([len(b) for b in c2s], np.int32),
            jax_build_tables(IRRATIONAL, is_max), interpret=True)
        _JAX_WINNERS[key] = [astuple(r) for r in rs]
    return _JAX_WINNERS[key]


_NUMPY_WINNERS: dict = {}


def numpy_winners(kind, is_max):
    """The port's numpy engine, query by query, once per (batch, mode)."""
    key = (kind, is_max)
    if key not in _NUMPY_WINNERS:
        c1s, c2s = mixed_rows() if kind == "mixed" else shared_rows()
        eng = AlignmentSearchEngine(IRRATIONAL, is_max, backend="numpy",
                                    strict_alphabet=False)
        want = []
        for c1, c2 in zip(c1s, c2s):
            try:
                want.append(astuple(eng.search_codes(c1, c2)))
            except NoMutationFound:
                want.append(None)
        _NUMPY_WINNERS[key] = want
    return _NUMPY_WINNERS[key]


def port_search(kind, is_max, **kw):
    c1s, c2s = mixed_rows() if kind == "mixed" else shared_rows()
    _, l2p, l1k = port_shapes(c1s, c2s)
    rs = batch.batched_search_exact(
        pad_rows(c1s, l1k), pad_rows(c2s, l2p),
        np.array([len(a) - len(b) + 1 for a, b in zip(c1s, c2s)], np.int32),
        np.array([len(b) for b in c2s], np.int32),
        device_tables(build_tables(IRRATIONAL, is_max), "cpu"), **kw)
    return [astuple(r) for r in rs]


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("kind,fused,shared_s1", [
    ("mixed", True, None), ("mixed", False, None), ("mixed", True, False),
    ("shared", True, None), ("shared", True, True), ("shared", True, False),
    ("shared", False, None)])
def test_batched_search_exact_matches_jax_and_numpy(kind, fused, shared_s1,
                                                    is_max):
    want = jax_winners(kind, is_max)
    got = port_search(kind, is_max, fused=fused, shared_s1=shared_s1,
                      micro_b=2)
    assert got == want
    assert want[-1] is None and all(w is not None for w in want[:-1])
    assert got == numpy_winners(kind, is_max)


def test_flooded_row_takes_the_full_stats_path(monkeypatch):
    """The periodic row's band holds more than k offsets: it must be swept
    again alone (the only single-query sweep of the batch)."""
    calls = []
    real = batch.offset_stats
    monkeypatch.setattr(batch, "offset_stats",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    got = port_search("mixed", False)
    assert calls == [(700,)]
    assert got == jax_winners("mixed", False)


def test_shared_bucket_goes_through_the_shared_sweep(monkeypatch):
    seen = []
    real_shared, real_rows = sw.sweep_batched_shared, sw.sweep_batched
    monkeypatch.setattr(batch, "sweep_batched_shared",
                        lambda *a: seen.append("shared") or real_shared(*a))
    monkeypatch.setattr(batch, "sweep_batched",
                        lambda *a: seen.append("rows") or real_rows(*a))
    port_search("shared", False, micro_b=2)
    assert seen == ["shared"] * 3
    seen.clear()
    port_search("mixed", False, micro_b=4)
    assert seen == ["rows"] * 2


# --- search_batch, the CLI and the generator --------------------------------

def mixed_queries():
    rng = np.random.default_rng(77)
    qs = []
    for n1, n2, w, is_max in [(300, 40, W, False), (300, 40, W, True),
                              (900, 200, IRRATIONAL, False), (1501, 77, W, False),
                              (300, 40, W, False), (900, 200, IRRATIONAL, False)]:
        qs.append((w, random_seq(rng, n1), random_seq(rng, n2), is_max))
    ref = random_seq(rng, 1200)
    for n2 in (60, 50, 64):                     # a shared-Seq1 bucket
        qs.append((W, ref, random_seq(rng, n2), True))
    return qs


@pytest.mark.parametrize("backend", ["torch", "numpy", "native", "auto"])
def test_search_batch_matches_jax(backend):
    qs = mixed_queries()
    got = batch.search_batch([Query(np.asarray(w), a, b, m) for w, a, b, m in qs],
                             backend=backend, device="cpu")
    want = jbatch.search_batch([JaxQuery(np.asarray(w), a, b, m)
                                for w, a, b, m in qs], backend="numpy")
    assert [astuple(r) for r in got] == [astuple(r) for r in want]


def test_search_batch_strict_alphabet():
    qs = [Query(W, "ABCDEFG", "ABC", False), Query(W, "ABCDE?G", "ABC", False)]
    with pytest.raises(ValueError, match="case 1"):
        batch.search_batch(qs, device="cpu")
    got = batch.search_batch(qs, strict_alphabet=False, device="cpu")
    assert all(r is not None for r in got)


def write_cases(path, gen_main):
    """A generator-made file of mixed sizes: three buckets, both modes, one
    lenient no-mutation case and one shared-Seq1 bucket."""
    parts = []
    for i, args in enumerate([["700", "120", "--cases", "3", "--seed", "4"],
                              ["900", "130", "--cases", "2", "--mode", "maximum",
                               "--hyphen-rate", "0.05", "--weights", "2,1,5,0.5"],
                              ["300", "40", "--cases", "2", "--seed", "9"]]):
        part = path.parent / f"part{i}.txt"
        assert gen_main([*args, "-o", str(part)]) == 0
        parts.append(part.read_text())
    rng = np.random.default_rng(1)
    ref = random_seq(rng, 1100)
    shared = "".join(f"1 3 4 2\n{ref}\n{random_seq(rng, n)}\nminimum\n"
                     for n in (64, 50, 33))
    nomut = "1 3 4 2\n" + "?" * 500 + "\n" + "!" * 40 + "\nmaximum\n"
    path.write_text("".join(parts) + shared + nomut)


def test_cli_batch_matches_jax(tmp_path, capsys):
    cases = tmp_path / "cases.txt"
    write_cases(cases, generator.main)
    rc = cli.main([str(cases), "--batch", "--device", "cpu", "--lenient",
                   "--json", "-o", str(tmp_path / "outs")])
    got_json = capsys.readouterr().out.splitlines()
    jrc = jax_cli.main([str(cases), "--batch", "--backend", "numpy",
                        "--lenient", "--json", "-o", str(tmp_path / "outs2")])
    want_json = capsys.readouterr().out.splitlines()
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

    assert strip(got_json) == strip(want_json)
    assert sum(not o["mutation_found"] for o in strip(got_json)) == 1


def test_cli_batch_numpy_backend_and_strict_alphabet(tmp_path, capsys):
    cases = tmp_path / "cases.txt"
    write_cases(cases, generator.main)
    assert cli.main([str(cases), "--batch", "--backend", "numpy", "--lenient",
                     "--quiet", "-o", str(tmp_path / "a.txt")]) == 1
    assert (tmp_path / "a" / "out_0010.txt").read_text().startswith("!" * 40)
    # the no-mutation case is out of the alphabet: strict mode refuses it
    assert cli.main([str(cases), "--batch", "--device", "cpu",
                     "-o", str(tmp_path / "b")]) == 2
    assert "case 10" in capsys.readouterr().err


@pytest.mark.parametrize("args", [
    ["2000", "500", "--cases", "3"],
    ["700", "120", "--cases", "2", "--seed", "5", "--hyphen-rate", "0.1",
     "--weights", "1,2,3,4", "--mode", "maximum"],
    ["50", "60"], ["10", "5", "--weights", "1 2"]])
def test_generator_matches_psa_gen(tmp_path, args):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    rc = generator.main([*args, "-o", str(a)])
    assert rc == jax_gen.main([*args, "-o", str(b)])
    assert a.exists() == b.exists()
    if rc == 0:
        assert a.read_bytes() == b.read_bytes()


# --- no hidden fallback -----------------------------------------------------

def test_search_batch_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qs = [Query(W, "ABCDEFGH", "CDE", False)]
    with pytest.raises(RuntimeError):
        batch.search_batch(qs)
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2 ABCDEFGH CDE minimum\n")
    assert cli.main([str(inp), "--batch", "--quiet", "-o", str(tmp_path / "o")]) == 2
    assert not (tmp_path / "o" / "out_0000.txt").exists()
    assert batch.search_batch(qs, backend="numpy")[0] is not None


def test_a_failing_sweep_is_not_answered_from_the_host(monkeypatch):
    def broken(*a):
        raise RuntimeError("sweep failed")

    monkeypatch.setattr(sw, "sweep_batched_plain", broken)
    monkeypatch.setattr(sw, "sweep_batched_shared_plain", broken)
    rng = np.random.default_rng(2)
    qs = [Query(W, random_seq(rng, 400), random_seq(rng, 60), False)
          for _ in range(3)]
    with pytest.raises(RuntimeError, match="sweep failed"):
        batch.search_batch(qs, device="cpu")
    qs = [Query(W, qs[0].seq1, q.seq2, False) for q in qs]   # shared Seq1
    with pytest.raises(RuntimeError, match="sweep failed"):
        batch.search_batch(qs, device="cpu")
