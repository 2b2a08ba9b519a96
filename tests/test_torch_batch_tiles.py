"""The batched sweeps' stats5 contract and their bucket-tight padding against
the JAX package: `sweep_batched[_shared]` (the plain versions on the CPU)
against `_fused_stats5_from_codes[_shared]` with the Pallas kernels in
interpret mode, over the real offsets, with tolerance 0 (exact integers);
the padding of `plan_bucket` at, below and above multiples of the warp tile
and of 1024; the `fused=False` cross-check at that padding; and
`search_batch` / `--batch` on a mixed file whose buckets are those of
`bucket_shape`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.models import batch as jbatch
from psa_tpu.ops import pallas_sweep as ps
from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils.io import Query as JaxQuery

from psa_torch.core.alphabet import OTHER_CODE, PAD_CODE
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.ops import sweep as sw
from psa_torch.utils import cli
from psa_torch.utils.io import Query

from conftest import random_codes, random_seq

W = np.array([1.0, 3.0, 4.0, 2.0])
G = sw.TILE_O


def pad_rows(rows, length):
    out = np.full((len(rows), length), PAD_CODE, np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def noffs_of(c1s, c2s):
    return np.array([len(a) - len(b) + 1 for a, b in zip(c1s, c2s)], np.int32)


def port_stats5(c1s, c2s, tables, shared):
    """The port's stats5 at the bucket-tight padding, and that padding."""
    l2p = sw.round_up(max(len(c) for c in c2s), sw.L2_ALIGN)
    noff_pad, l1k = sw.plan_bucket(noffs_of(c1s, c2s), l2p)
    code = torch.from_numpy(np.ascontiguousarray(tables.code))
    c2b = torch.from_numpy(pad_rows(c2s, l2p))
    if shared:
        got = sw.sweep_batched_shared(torch.from_numpy(pad_rows(c1s[:1], l1k)[0]),
                                      c2b, code)
    else:
        got = sw.sweep_batched(torch.from_numpy(pad_rows(c1s, l1k)), c2b, code)
    assert got.dtype == torch.int32 and got.shape == (len(c2s), 5, noff_pad)
    return got.numpy(), noff_pad


def jax_stats5(c1s, c2s, is_max, shared):
    """psa_tpu's fused stats5 at its own padding (512-offset tiles, Seq2 to
    128), the Pallas kernels in interpret mode."""
    l2p = ps.round_up(max(len(c) for c in c2s), 128)
    l1k = ps.round_up(int(noffs_of(c1s, c2s).max()), 512) + l2p
    code = jnp.asarray(jax_build_tables(W, is_max).code)
    c2b = jnp.asarray(pad_rows(c2s, l2p))
    if shared:
        out = jbatch._fused_stats5_from_codes_shared(
            jnp.asarray(pad_rows(c1s[:1], l1k)[0]), c2b, code, len(c2s), l1k,
            l2p, True)
    else:
        out = jbatch._fused_stats5_from_codes(
            jnp.asarray(pad_rows(c1s, l1k)), c2b, code, len(c2s), l1k, l2p, True)
    return np.asarray(out)


def assert_real_offsets_equal(got, want, c1s, c2s):
    for q, noff in enumerate(noffs_of(c1s, c2s)):
        np.testing.assert_array_equal(got[q, :, :noff], want[q, :, :noff])


# --- the stats5 layout -------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("b,n1,n2,is_max", [(4, 900, 200, False),
                                            (3, 1400, 64, True),
                                            (2, 2600, 500, False)])
def test_stats5_matches_fused_stats5(shared, b, n1, n2, is_max):
    rng = np.random.default_rng(b * 7 + n1 + shared)
    c2s = [random_codes(rng, n2) for _ in range(b)]
    c1s = [random_codes(rng, n1)] * b if shared else [random_codes(rng, n1)
                                                      for _ in range(b)]
    got, _ = port_stats5(c1s, c2s, build_tables(W, is_max), shared)
    assert_real_offsets_equal(got, jax_stats5(c1s, c2s, is_max, shared),
                              c1s, c2s)


def test_stats5_rows_are_counts_and_maxrank():
    """Row 4 is the maxrank, -1 where no position substitutes; rows 0-3
    sum to the real Seq2 length at every real offset."""
    rng = np.random.default_rng(4)
    c1s = [random_codes(rng, 700), np.full(500, OTHER_CODE, np.int32)]
    c2s = [random_codes(rng, 90), np.full(90, OTHER_CODE, np.int32)]
    t = build_tables(W, False)
    got, _ = port_stats5(c1s, c2s, t, False)
    assert got[0, 4, :611].min() >= 0 and got[0, 4].max() < t.num_ranks
    assert (got[1, 4] == -1).all()
    np.testing.assert_array_equal(got[0, :4, :611].sum(0), 90)


# --- bucket-tight padding ----------------------------------------------------

@pytest.mark.parametrize("noff", [1, G - 1, G, G + 1, 1023, 1024, 1025])
def test_plan_bucket_pads_to_whole_warp_tiles(noff):
    noff_pad, l1k = sw.plan_bucket([noff, max(1, noff // 2)], 96)
    assert noff_pad % G == 0 and noff_pad - G < noff <= noff_pad
    assert l1k == noff_pad + 96
    # the buckets stay those of bucket_shape; only the padding tightens
    assert l1k <= sw.bucket_shape(noff + 95, 96)[0]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("noff", [G - 1, G, G + 1, 1023, 1024, 1025])
def test_tight_padding_matches_fused_stats5(shared, noff):
    """Real offset counts just below, at and above a multiple of the warp
    tile and of 1024, against psa_tpu's fused stats5."""
    rng = np.random.default_rng(noff + 10 * shared)
    n2 = 70
    c2s = [random_codes(rng, n2), random_codes(rng, n2 - 9)]
    n1s = [noff + n2 - 1, noff + n2 - 1 - 9 - 5]
    c1s = ([random_codes(rng, n1s[0])] * 2 if shared
           else [random_codes(rng, n) for n in n1s])
    got, noff_pad = port_stats5(c1s, c2s, build_tables(W, True), shared)
    assert noff_pad == sw.round_up(max(noffs_of(c1s, c2s)), G)
    assert_real_offsets_equal(got, jax_stats5(c1s, c2s, True, shared),
                              c1s, c2s)


def test_ragged_lenient_bucket_matches_fused_stats5():
    """Rows of different lengths with OTHER_CODE and hyphens, a row of
    nothing but OTHER_CODE, one bucket."""
    rng = np.random.default_rng(31)
    c1s, c2s = [], []
    for n1, n2 in [(1200, 300), (900, 280), (1300, 33), (700, 300)]:
        a, b = random_codes(rng, n1, 0.1), random_codes(rng, n2, 0.1)
        a[rng.random(n1) < 0.05] = OTHER_CODE
        b[rng.random(n2) < 0.05] = OTHER_CODE
        c1s.append(a)
        c2s.append(b)
    c1s.append(np.full(800, OTHER_CODE, np.int32))
    c2s.append(np.full(120, OTHER_CODE, np.int32))
    got, noff_pad = port_stats5(c1s, c2s, build_tables(W, False), False)
    assert noff_pad == 1280
    assert_real_offsets_equal(got, jax_stats5(c1s, c2s, False, False), c1s, c2s)


# --- the batch path at the tight padding -------------------------------------

def astuple(r):
    return None if r is None else (r.offset, r.char_offset, r.sub_code, r.score)


@pytest.mark.parametrize("is_max", [False, True])
def test_unfused_cross_check_at_tight_padding(is_max):
    """`fused=False` sweeps each row with the single-query kernel at the
    bucket's own padding, which is not a whole BUCKET_O: it gives the fused
    path's winners and psa_tpu's."""
    rng = np.random.default_rng(8 + is_max)
    c1s = [random_codes(rng, n) for n in (1400, 1380, 1100)]
    c2s = [random_codes(rng, n) for n in (100, 64, 90)]
    l2p = sw.round_up(100, sw.L2_ALIGN)
    noffs = noffs_of(c1s, c2s)
    noff_pad, l1k = sw.plan_bucket(noffs, l2p)
    assert noff_pad == 1536 and noff_pad % sw.BUCKET_O
    n2s = np.array([len(c) for c in c2s], np.int32)
    dt = device_tables(build_tables(W, is_max), "cpu")
    args = (pad_rows(c1s, l1k), pad_rows(c2s, l2p), noffs, n2s, dt)
    unfused = [astuple(r) for r in batch.batched_search_exact(*args, fused=False)]
    assert unfused == [astuple(r) for r in batch.batched_search_exact(*args)]
    jl2p = 128
    jl1k = 1536 + jl2p
    want = jbatch.batched_search_exact(
        pad_rows(c1s, jl1k), pad_rows(c2s, jl2p), noffs, n2s,
        jax_build_tables(W, is_max), interpret=True)
    assert unfused == [astuple(r) for r in want]


def mixed_queries():
    rng = np.random.default_rng(12)
    qs = []
    for n1, n2, is_max in [(300, 40, False), (310, 41, False), (1500, 100, True),
                           (1200, 100, True), (300, 40, True), (2100, 500, False)]:
        qs.append(Query(W, random_seq(rng, n1), random_seq(rng, n2), is_max))
    ref = random_seq(rng, 1300)
    qs += [Query(W, ref, random_seq(rng, n), False) for n in (70, 66, 90)]
    return qs


def test_search_batch_keeps_the_buckets_of_plan_shapes(monkeypatch):
    """One batched launch per bucket of (weights, mode, l1k, l2p) from
    `bucket_shape` (the 1024-offset keys `plan_shapes` gave before its tiles
    shrank), each encoded at its own tight padding; the winners are
    psa_tpu's."""
    qs = mixed_queries()
    buckets = {}
    for q in qs:
        l1k, l2p = sw.bucket_shape(len(q.seq1), len(q.seq2))
        assert l1k - l2p == sw.round_up(len(q.seq1) - len(q.seq2) + 1, 1024)
        buckets.setdefault((q.is_max, l1k, l2p), []).append(q)
    want_pads = sorted(sw.plan_bucket([len(q.seq1) - len(q.seq2) + 1 for q in v],
                                      key[2])[0] for key, v in buckets.items())
    seen = []
    real_rows, real_shared = batch.sweep_batched, batch.sweep_batched_shared
    monkeypatch.setattr(batch, "sweep_batched", lambda c1, c2, code, counters=None: seen.append(
        c1.shape[-1] - c2.shape[1]) or real_rows(c1, c2, code, counters))
    monkeypatch.setattr(batch, "sweep_batched_shared", lambda c1, c2, code, counters=None: seen.append(
        c1.shape[-1] - c2.shape[1]) or real_shared(c1, c2, code, counters))
    got = batch.search_batch(qs, device="cpu")
    assert sorted(seen) == want_pads and len(seen) == len(buckets) == 5
    assert any(p % sw.BUCKET_O for p in seen)
    want = jbatch.search_batch([JaxQuery(q.weights, q.seq1, q.seq2, q.is_max)
                                for q in qs], backend="numpy")
    assert [astuple(r) for r in got] == [astuple(r) for r in want]


def test_cli_batch_matches_jax_on_a_mixed_file(tmp_path):
    qs = mixed_queries()
    cases = tmp_path / "cases.txt"
    cases.write_text("".join(
        f"1 3 4 2\n{q.seq1}\n{q.seq2}\n{'maximum' if q.is_max else 'minimum'}\n"
        for q in qs))
    assert cli.main([str(cases), "--batch", "--device", "cpu", "--quiet",
                     "-o", str(tmp_path / "a")]) == 0
    assert jax_cli.main([str(cases), "--batch", "--backend", "numpy", "--quiet",
                         "-o", str(tmp_path / "b")]) == 0
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert len(names) == len(qs)
    assert names == sorted(p.name for p in (tmp_path / "b").iterdir())
    for n in names:
        assert (tmp_path / "a" / n).read_bytes() == (tmp_path / "b" / n).read_bytes()
