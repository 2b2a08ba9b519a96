"""Tests of the port that need the card: the CUDA sweep kernels and the
top-k epilogue kernel against their plain PyTorch versions, the engine, the batch path, the TCP serving
tier, the serve warm start and the kernel lab on the card against the host oracle.
They skip without a CUDA device.  This file imports neither JAX nor psa_tpu,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import socket
import threading

import numpy as np
import pytest
import torch

from psa_torch import native
from psa_torch.core.alphabet import OTHER_CODE, PAD_CODE, encode_batch_checked
from psa_torch.core.oracle import rescore_multi
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops import _sweep_v2 as v2
from psa_torch.ops import _sweep_v3 as v3
from psa_torch.ops import epilogue as ep
from psa_torch.ops import sweep as sw
from psa_torch.parallel import mesh
from psa_torch.utils import kernel_lab
from psa_torch.utils import server
from psa_torch.utils.generator import random_sequences
from psa_torch.utils.io import Query

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def codes(rng, n, other):
    c = rng.integers(0, 27, n).astype(np.int32)
    if other:
        c[::7] = OTHER_CODE
    return c


@pytest.mark.parametrize("n1,n2,other", [(1000, 137, False), (131072, 8192, False),
                                         (400_000, 2048, False), (50_000, 3000, True)])
def test_kernel_matches_plain(cuda, n1, n2, other):
    """All 5 rows of stats5 integer-equal to the plain version on the
    card."""
    rng = np.random.default_rng(n1 + n2)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
    d1, d2 = sw.upload_codes(cuda, (codes(rng, n1, other), l1k),
                             (codes(rng, n2, other), l2p))
    code = torch.from_numpy(tables.code).to(cuda)
    before = sw.launches
    got = sw.sweep(d1, d2, code)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    assert got.shape == (5, noff_pad)
    assert torch.equal(got, sw.sweep_plain(d1, d2, code))


# (n1, n2) at the even split's edges on the card's own worker count
SPLIT_EDGES = {"ranges_of_whole_tiles": (2_000_000, 20),
               "few_units": (1000, 137), "noff_1": (300, 300),
               "whole_tiles_ragged_step": (2_000_000, 1500),
               "tile_over_90_workers": (40_000, 30_000),
               "seq1_1M": (1_000_000, 2048)}


@pytest.mark.parametrize("case", sorted(SPLIT_EDGES))
def test_sweep_at_split_edges(cuda, case):
    """The kernel equals its plain version where ranges hold several whole
    tiles, where units are fewer than workers, at noff = 1, with a ragged
    last step of a whole tile, with one tile split over ~90 workers and at
    1M x 2048; codes include hyphens, OTHER_CODE and PAD_CODE.  The card's
    plan agrees with `sweep_plan`."""
    n1, n2 = SPLIT_EDGES[case]
    rng = np.random.default_rng(len(case))
    c1 = rng.integers(0, PAD_CODE + 1, n1).astype(np.int32)
    c2 = rng.integers(0, PAD_CODE + 1, n2).astype(np.int32)
    c1[::29] = OTHER_CODE
    noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
    card = sw.sweep_launch_plan(l2p, noff_pad)
    model = sw.sweep_plan(noff_pad, l2p, card["workers"])
    assert {k: card[k] for k in ("units", "per_worker", "split_tiles")} == {
        k: model[k] for k in ("units", "per_worker", "split_tiles")}
    if case in ("few_units", "noff_1"):
        assert card["units"] <= card["workers"] < card["units"] + 4
    code = torch.from_numpy(build_tables(np.array([2.0, 1.0, 5.0, 0.5]),
                                         True).code).to(cuda)
    d1, d2 = sw.upload_codes(cuda, (c1, l1k), (c2, l2p))
    got = sw.sweep(d1, d2, code)
    torch.cuda.synchronize()
    assert torch.equal(got, sw.sweep_plain(d1, d2, code))


def test_sweep_refuses_misaligned_operands(cuda):
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         False).code).to(cuda)
    flat = torch.full((1 + 256 + 64,), PAD_CODE, dtype=torch.uint8, device=cuda)
    c2 = torch.full((64,), PAD_CODE, dtype=torch.uint8, device=cuda)
    before = sw.launches
    with pytest.raises(ValueError, match="aligned"):
        sw.sweep(flat[1:], c2, code)
    with pytest.raises(ValueError, match="aligned"):
        sw.sweep(flat[:-1], flat[1: 65], code)
    assert sw.launches == before
    assert sw.sweep(flat[:-1], c2, code).shape == (5, 256)


# The lab kernels' cases: (variant, n1, n2, other) on random codes, and the
# edges of the kernels' Seq2 splits by name (v3's edges run v2 as the
# control, and v2's run v3 where their inputs are clean).
LAB_CASES = [("v2", 1000, 137, True), ("v2", 131072, 8192, False),
             ("v2", 50_000, 3000, True), ("v3", 1000, 137, False),
             ("v3", 100_000, 10_000, False), ("v3", 400_000, 2048, False)]
LAB_EDGES = {  # name: (n1, n2, the variants that run it)
    # l2p = MAX_N2 over 128 tiles, so that v3's segments hold LANE_CHUNKS
    # chunks: every pair in class 2 (both slot bits: every byte lane
    # counts), and every pair at the largest code the contract allows (126,
    # also v2's DPX max)
    "max_n2_one_class": (v3.MAX_N2 + 128 * 256 - 1, v3.MAX_N2, ("v2", "v3")),
    "max_n2_max_code": (v3.MAX_N2 + 128 * 256 - 1, v3.MAX_N2, ("v2", "v3")),
    "one_tile_one_chunk": (300, 64, ("v2", "v3")),    # noff_pad 256, l2p 64
    "segments_uneven": (1_000_000, 2000, ("v2", "v3")),   # v3: 32 chunks over 3 segments
    "one_segment_per_tile": (1_000_000, 500, ("v2", "v3")),   # 8 chunks, tiles >= 2 x slots
    # v2: 157 chunks (a prime) over more than one segment
    "v2_segments_uneven": (100_000, 10_000, ("v2", "v3")),
    # v2 on lenient codes (hyphens, OTHER_CODE) over more than one segment:
    # row 3 goes through the atomics
    "v2_lenient_segments": (200_000, 3000, ("v2",)),
}
# What each edge must be in its variant's split (the card's plan); an edge
# that a variant runs only as the control has no entry.
EDGE_HOLDS = {
    ("v3", "max_n2_one_class"): lambda p: p["most_chunks"] == v3.LANE_CHUNKS,
    ("v3", "max_n2_max_code"): lambda p: p["most_chunks"] == v3.LANE_CHUNKS,
    ("v2", "max_n2_max_code"): lambda p: p["segs"] > 1,
    ("v2", "one_tile_one_chunk"): lambda p: (p["tiles"], p["chunks"], p["segs"]) == (1, 1, 1),
    ("v3", "one_tile_one_chunk"): lambda p: (p["tiles"], p["chunks"], p["segs"]) == (1, 1, 1),
    ("v3", "segments_uneven"): lambda p: p["chunks"] % p["segs"] != 0,
    ("v2", "one_segment_per_tile"): lambda p: p["segs"] == 1 < p["chunks"],
    ("v3", "one_segment_per_tile"): lambda p: p["segs"] == 1 < p["chunks"],
    ("v2", "v2_segments_uneven"): lambda p: p["segs"] > 1 and p["chunks"] % p["segs"] != 0,
    ("v2", "v2_lenient_segments"): lambda p: p["segs"] > 1,
}


def lab_edge_inputs(case, rng):
    """(c1, c2, code) of a LAB_EDGES case: the saturation cases are one
    letter pair repeated; v2_lenient_segments lenient random codes; the
    others clean random codes."""
    n1, n2, _ = LAB_EDGES[case]
    code = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False).code.copy()
    if case.startswith("max_n2"):
        a, b = 0, 2                                # class 2 under these weights
        if case == "max_n2_max_code":
            code[a, b] = 126
        assert (code[a, b] - 1) & 3 == (2 if case == "max_n2_one_class" else 1)
        return np.full(n1, a), np.full(n2, b), code
    if case == "v2_lenient_segments":
        return codes(rng, n1, True), codes(rng, n2, True), code
    return rng.integers(0, 26, n1), rng.integers(0, 26, n2), code


@pytest.mark.parametrize("variant,n1,n2,other,edge", [
    *(pytest.param(v, n1, n2, o, None, id=f"{v}-{n1}-{n2}-{o}") for v, n1, n2, o in LAB_CASES),
    *(pytest.param(v, *LAB_EDGES[e][:2], False, e, id=f"{v}-{e}")
      for e in LAB_EDGES for v in LAB_EDGES[e][2])])
def test_lab_kernels_match_plain(cuda, variant, n1, n2, other, edge):
    """The tensor-core sweeps, all 8 rows integer-equal to their plain
    versions on the card; v3 only on clean inputs, its row 3 zero.  The
    edges of the splits (EDGE_HOLDS): l2p = MAX_N2 with every byte lane
    full (one class, then the largest code), one tile of one chunk, chunk
    counts the segments do not divide, one segment per tile, v2 on lenient
    codes over several segments; each variant's card plan equals its
    launch plan (`v2_launch_plan`, `v3_launch_plan`) at each."""
    mod, sweep, plain, count, card_plan, launch_plan = {
        "v2": (v2, v2.sweep_v2, v2.sweep_v2_plain, "launches_v2", v2.v2_card_plan,
               v2.v2_launch_plan),
        "v3": (v3, v3.sweep_v3, v3.sweep_v3_plain, "launches_v3", v3.v3_card_plan,
               v3.v3_launch_plan)}[variant]
    rng = np.random.default_rng(n1 + n2 + 1)
    if edge:
        c1, c2, table = lab_edge_inputs(edge, rng)
    else:
        c1, c2 = codes(rng, n1, other), codes(rng, n2, other)
        table = build_tables(np.array([2.0, 1.0, 5.0, 0.5]), True).code
    noff, noff_pad, l2p, l1k = v2.plan_shapes_v2(n1, n2)
    card = card_plan(noff_pad, l2p)
    model = launch_plan(noff_pad, l2p, card["slots"])
    print(variant, edge or (n1, n2), card)
    assert {k: card[k] for k in ("tiles", "chunks", "segs", "blocks", "most_chunks")} == {
        k: model[k] for k in ("tiles", "chunks", "segs", "blocks", "most_chunks")}
    assert EDGE_HOLDS.get((variant, edge), lambda p: True)(card)
    d1, d2 = sw.upload_codes(cuda, (c1, l1k), (c2, l2p))
    code = torch.from_numpy(table).to(cuda)
    before = getattr(mod, count)
    got = sweep(d1, d2, code)
    torch.cuda.synchronize()
    assert getattr(mod, count) == before + 1
    assert torch.equal(got, plain(d1, d2, code))


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_kernel_lab_on_card(cuda, variant, capsys):
    """The lab's --check on the card at a small size: stats equal to the
    oracle, a RESULT line, and the variant's kernel launched."""
    before = (sw.launches, v2.launches_v2, v3.launches_v3)
    assert kernel_lab.main(["--variant", variant, "--n1", "20000", "--n2", "1500",
                            "--iters", "4", "--check"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        f"RESULT {variant} ")
    after = (sw.launches, v2.launches_v2, v3.launches_v3)
    k = ["v1", "v2", "v3"].index(variant)
    assert after[k] - before[k] == 1 + 1 + 4     # --check, warm-up, timed
    assert all(a == b for i, (a, b) in enumerate(zip(after, before)) if i != k)


@pytest.mark.parametrize("weights,is_max", [((1.0, 3.0, 4.0, 2.0), False),
                                            ((2.0, 1.0, 5.0, 0.5), True),
                                            ((1.0, 1.0, 1.0, 1.0), True)])
def test_engine_on_card_matches_numpy(cuda, weights, is_max):
    rng = np.random.default_rng(17)
    c1, c2 = codes(rng, 9000, False), codes(rng, 700, False)
    got = AlignmentSearchEngine(weights, is_max).search_codes(c1, c2)
    want = AlignmentSearchEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
    assert got == want


def test_north_star_on_card(cuda):
    s1, s2 = random_sequences(100_000, 10_000, seed=0)
    before = sw.launches
    res = AlignmentSearchEngine((1, 3, 4, 2), False).search(s1, s2)
    assert (res.offset, res.char_offset, res.sub_code, res.score) == (
        84944, 10, 10, -21596.0)
    assert sw.launches == before + 1


@pytest.mark.parametrize("backend,share", [("native", None), ("auto", None),
                                           ("hybrid", 50)])
def test_north_star_through_host_backends(cuda, backend, share):
    """The north-star tuple through the backends built on the native
    library; `auto` takes the card at this size, and so does `hybrid`'s
    device half."""
    s1, s2 = random_sequences(100_000, 10_000, seed=0)
    before = sw.launches
    res = AlignmentSearchEngine((1, 3, 4, 2), False, backend=backend,
                                device_share=share).search(s1, s2)
    assert (res.offset, res.char_offset, res.sub_code, res.score) == (
        84944, 10, 10, -21596.0)
    assert sw.launches - before == (0 if backend == "native" else 1)


def test_rescore_multi_native_on_a_fetched_microbatch(cuda):
    """The candidates of one microbatch fetched from the card, re-scored by
    the library and by numpy: the same bits."""
    assert native.available()
    qs = [Query(np.array([1.0, 3.0, 4.0, 2.0]), *random_sequences(2048, 512, seed=s),
                False) for s in range(64)]
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    dtabs = device_tables(tables, cuda)
    noffs = np.array([len(q.seq1) - len(q.seq2) + 1 for q in qs], np.int32)
    n2s = np.array([len(q.seq2) for q in qs], np.int32)
    l2p = sw.plan_shapes(2048, 512)[2]
    _, l1k = sw.plan_bucket(noffs, l2p)
    c1b, _ = encode_batch_checked([q.seq1 for q in qs], l1k)
    c2b, _ = encode_batch_checked([q.seq2 for q in qs], l2p)
    packed = batch.run_exact_batch(torch.from_numpy(c1b).to(cuda),
                                   torch.from_numpy(c2b).to(cuda),
                                   torch.from_numpy(noffs).to(cuda), dtabs)
    topi, stats_k, near, best = batch.unpack_epilogue_outputs(
        batch.start_fetch(packed).wait(), batch.TOPK)
    assert (near <= batch.TOPK).all()
    qidx = np.repeat(np.arange(len(qs), dtype=np.int32), batch.TOPK)
    offs = topi.reshape(-1).astype(np.int64)
    keep = offs < noffs[qidx]
    qidx, offs = qidx[keep], offs[keep]
    got = native.rescore_multi_native(c1b, c2b, n2s, tables, qidx, offs)
    want = rescore_multi(c1b, c2b, n2s, tables, qidx, offs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def batch_rows(rng, b, n1, n2, other, ragged):
    """(c1b, c2b) uint8 of b queries of the bucket of (n1, n2), padded as
    `search_batch` pads it (`plan_bucket`); ragged rows are shorter by up
    to a third."""
    l2p = sw.plan_shapes(n1, n2)[2]
    lens = []
    for _ in range(b):
        m1 = n1 - (int(rng.integers(0, n1 // 3)) if ragged else 0)
        lens.append((m1, min(m1, n2 - (int(rng.integers(0, n2 // 3)) if ragged else 0))))
    _, l1k = sw.plan_bucket([m1 - m2 + 1 for m1, m2 in lens], l2p)
    c1b = np.full((b, l1k), PAD_CODE, np.uint8)
    c2b = np.full((b, l2p), PAD_CODE, np.uint8)
    for q, (m1, m2) in enumerate(lens):
        c1b[q, :m1] = codes(rng, m1, other)
        c2b[q, :m2] = codes(rng, m2, other)
    return c1b, c2b


def check_batched_kernels(cuda, c1b, c2b):
    """Both batched kernels equal to their plain versions (stats5, all 5
    rows), the shared kernel equal to the per-row one on broadcast rows,
    and each launch counted once."""
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         False).code).to(cuda)
    d1 = torch.from_numpy(c1b).to(cuda)
    d2 = torch.from_numpy(c2b).to(cuda)
    before = (sw.launches_batched, sw.launches_batched_shared)
    got = sw.sweep_batched(d1, d2, code)
    shared = sw.sweep_batched_shared(d1[0].contiguous(), d2, code)
    torch.cuda.synchronize()
    assert (sw.launches_batched, sw.launches_batched_shared) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (c2b.shape[0], 5, c1b.shape[1] - c2b.shape[1])
    assert torch.equal(got, sw.sweep_batched_plain(d1, d2, code))
    assert torch.equal(shared, sw.sweep_batched_shared_plain(d1[0].contiguous(),
                                                             d2, code))
    broadcast = d1[:1].expand(c2b.shape[0], -1).contiguous()
    assert torch.equal(shared, sw.sweep_batched(broadcast, d2, code))


@pytest.mark.parametrize("b,n1,n2,other,ragged", [(64, 2048, 512, False, False),
                                                  (37, 3000, 700, True, True)])
def test_batched_kernels_match_plain(cuda, b, n1, n2, other, ragged):
    """Both batched kernels, all 5 rows of stats5 integer-equal to their
    plain versions; the shared kernel equal to the per-row one on
    broadcast rows."""
    rng = np.random.default_rng(b + n1)
    check_batched_kernels(cuda, *batch_rows(rng, b, n1, n2, other, ragged))


def warp_slots(cuda, l2p):
    """The workers a batched launch with Seq2 rows of l2p holds (a block
    each)."""
    return sw.batched_plan(l2p, sw.TILE_O, 1, False)["blocks_per_sm"] * (
        torch.cuda.get_device_properties(cuda).multi_processor_count)


@pytest.mark.parametrize("case", ["noff_1", "noff_multiple_of_tile", "b_1",
                                  "b_not_multiple_of_slots", "seq2_segments",
                                  "seq2_split"])
def test_batched_kernels_at_edge_shapes(cuda, case):
    """The split's edges: one real offset, offsets filling whole warp
    tiles, one query, a B that fills no whole wave (each item one unit and
    one step), Seq2 longer than a step with more items than warp slots, and
    a bucket with fewer items than warp slots; the last two split Seq2 into
    32-position units, and items shared between workers take atomics."""
    rng = np.random.default_rng(len(case))
    b, n1, n2 = {"noff_1": (5, 300, 300), "noff_multiple_of_tile": (7, 967, 200),
                 "b_1": (1, 3000, 500), "b_not_multiple_of_slots": (1111, 1000, 300),
                 "seq2_segments": (warp_slots(cuda, 1120) + 5, 2123, 1100),
                 "seq2_split": (2, 5000, 4000)}[case]
    c1b, c2b = batch_rows(rng, b, n1, n2, False, False)
    plan = sw.batched_plan(c2b.shape[1], c1b.shape[1] - c2b.shape[1], b, False)
    long_seq2 = case in ("seq2_segments", "seq2_split")
    assert (plan["units"] > plan["items"]) == long_seq2
    assert (plan["split_items"] > 0) == long_seq2
    assert plan["per_worker"] == -(-plan["units"] // plan["workers"])
    check_batched_kernels(cuda, c1b, c2b)


# (b, n1, n2) at the benchmark's batch cells (600,000 x 250,000, B = 1-8)
# and the batch workload's 1024 x 2048 x 512
CELL_PLANS = [(b, 600_000, 250_000) for b in range(1, 9)] + [(1024, 2048, 512)]


@pytest.mark.parametrize("b,n1,n2", CELL_PLANS)
def test_batched_plan_is_the_cpu_model(cuda, b, n1, n2):
    """The card's split of both batched kernels equals
    `batched_split_plan` with the card's workers; where Seq2 spans more than
    one step no worker sweeps more than one unit above the mean."""
    _, noff_pad, l2p, _ = sw.plan_shapes(n1, n2)
    for shared in (False, True):
        card = sw.batched_plan(l2p, noff_pad, b, shared)
        model = sw.batched_split_plan(b, noff_pad, l2p, card["workers"])
        keys = ("items", "units", "per_worker", "split_items")
        assert {k: card[k] for k in keys} == {k: model[k] for k in keys}
        if l2p > sw.SEG:
            assert card["per_worker"] - card["units"] / card["workers"] < 1


def test_batched_kernels_at_the_cell_shape(cuda):
    """At B = 4 of 600,000 x 250,000 (the batch cell's launch) the per-row
    kernel equals four `sweep` launches bit for bit, and the shared kernel
    equals the per-row one on broadcast rows."""
    rng = np.random.default_rng(4)
    c1b, c2b = batch_rows(rng, 4, 600_000, 250_000, True, False)
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         False).code).to(cuda)
    d1 = torch.from_numpy(c1b).to(cuda)
    d2 = torch.from_numpy(c2b).to(cuda)
    got = sw.sweep_batched(d1, d2, code)
    want = torch.stack([sw.sweep(d1[q].contiguous(), d2[q].contiguous(), code)
                        for q in range(4)])
    shared = sw.sweep_batched_shared(d1[0].contiguous(), d2, code)
    broadcast = sw.sweep_batched(d1[:1].expand(4, -1).contiguous(), d2, code)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(shared, broadcast)


# Both kernels against their plain versions where the bit-sliced loop has
# its edges: B = 1-8 per-row and shared, long Seq2 whose items are shared
# between workers (atomics), a last warp tile reaching past noff_pad,
# steps that carry their columns over, the maximum mode, weights with other
# ranks, and all-'A' rows that meet no top rank and take the lower
# threshold passes.  (b, n1, n2, weights, is_max, letters)
BITSLICED_EDGES = {
    "b1_long": (1, 40_000, 9000, (1.0, 3.0, 4.0, 2.0), False, "lenient"),
    "b2_max": (2, 20_000, 5000, (1.0, 3.0, 4.0, 2.0), True, "lenient"),
    "b3_partial_tile": (3, 3500, 1100, (2.0, 1.0, 1.0, 1.0), False, "uniform"),
    "b5_weights": (5, 9000, 2048, (-2.0, 1e6, 1e-7, 0.0), True, "uniform"),
    "b8_short": (8, 2000, 700, (1.0, 3.0, 4.0, 2.0), False, "lenient"),
    "b4_all_A": (4, 6000, 2100, (1.0, 3.0, 4.0, 2.0), False, "all_A"),
    "b6_all_A_max": (6, 2600, 1056, (1.0, 3.0, 4.0, 2.0), True, "all_A"),
    "b7_seq2_32": (7, 1500, 32, (1.0, 3.0, 4.0, 2.0), False, "uniform"),
}


@pytest.mark.parametrize("case", sorted(BITSLICED_EDGES))
def test_bitsliced_kernels_at_their_edges(cuda, case):
    """All three kernels integer-equal to their plain versions (stats5, all
    5 rows): the batched ones on the case's B rows, `sweep` on the first."""
    b, n1, n2, w, is_max, letters = BITSLICED_EDGES[case]
    rng = np.random.default_rng(len(case) + b)
    l2p = sw.plan_shapes(n1, n2)[2]
    _, l1k = sw.plan_bucket([n1 - n2 + 1], l2p)
    c1b = np.full((b, l1k), PAD_CODE, np.uint8)
    c2b = np.full((b, l2p), PAD_CODE, np.uint8)
    for q in range(b):
        if letters == "all_A":
            continue
        c1b[q, :n1] = codes(rng, n1, letters == "lenient")
        c2b[q, :n2] = codes(rng, n2, letters == "lenient")
    if letters == "all_A":
        c1b[:, :n1], c2b[:, :n2] = 0, 0
    code = torch.from_numpy(build_tables(np.array(w), is_max).code).to(cuda)
    d1 = torch.from_numpy(c1b).to(cuda)
    d2 = torch.from_numpy(c2b).to(cuda)
    got = sw.sweep_batched(d1, d2, code)
    shared = sw.sweep_batched_shared(d1[0].contiguous(), d2, code)
    one = sw.sweep(d1[0].contiguous(), d2[0].contiguous(), code)
    torch.cuda.synchronize()
    assert torch.equal(got, sw.sweep_batched_plain(d1, d2, code))
    assert torch.equal(shared, sw.sweep_batched_shared_plain(d1[0].contiguous(),
                                                             d2, code))
    assert torch.equal(one, sw.sweep_plain(d1[0].contiguous(),
                                           d2[0].contiguous(), code))


@pytest.mark.parametrize("letters", ["uniform", "all_A"])
def test_rank_passes_pm_on_the_card(cuda, letters):
    """`rank_passes_pm`, set on the single and batch paths' `fetch_wait`
    spans while the recorder is on: 1000 (one pass a step) on uniform
    letters at the benchmark cells' 600,000 x 250,000, above 1000 where no
    offset meets the top rank (all 'A' in the maximum mode, whose 'A'-'A'
    pair ranks below the table's top)."""
    from psa_torch.utils import spans

    n1, n2 = (600_000, 250_000) if letters == "uniform" else (200_000, 2048)
    seqs = (("A" * n1, "A" * n2) if letters == "all_A"
            else random_sequences(n1, n2, seed=24))
    w, is_max = [1.0, 3.0, 4.0, 2.0], letters == "all_A"
    spans.clear()
    AlignmentSearchEngine(w, is_max, device=cuda).search(*seqs)
    batch.search_batch([Query(w, *seqs, is_max)] * 2, device=cuda)
    pms = [r.attrs["rank_passes_pm"] for r in spans.records()
           if r.name == "fetch_wait" and "rank_passes_pm" in r.attrs]
    assert len(pms) == 2
    if letters == "uniform":
        assert pms == [1000, 1000]
    else:
        assert min(pms) > 1000
    was = spans.enable(False)
    try:
        spans.clear()
        AlignmentSearchEngine(w, is_max, device=cuda).search(*seqs)
        assert spans.records() == []
    finally:
        spans.enable(was)


def test_batched_kernels_refuse_misaligned_rows(cuda):
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         False).code).to(cuda)
    flat = torch.full((1 + 2 * (256 + 64),), PAD_CODE, dtype=torch.uint8,
                      device=cuda)
    c2 = torch.full((2, 64), PAD_CODE, dtype=torch.uint8, device=cuda)
    before = (sw.launches_batched, sw.launches_batched_shared)
    with pytest.raises(ValueError, match="aligned"):
        sw.sweep_batched(flat[1:].view(2, 256 + 64), c2, code)
    with pytest.raises(ValueError, match="aligned"):
        sw.sweep_batched_shared(flat[1: 1 + 256 + 64], c2, code)
    with pytest.raises(ValueError, match="aligned"):
        sw.sweep_batched(flat[:-1].view(2, 256 + 64), flat[1: 129].view(2, 64), code)
    assert (sw.launches_batched, sw.launches_batched_shared) == before
    assert sw.sweep_batched(flat[:-1].view(2, 256 + 64), c2, code).shape == (2, 5, 256)


@pytest.mark.parametrize("shared", [False, True])
def test_search_batch_on_card_matches_numpy(cuda, shared, monkeypatch):
    """32 queries in two buckets (the modes), each streamed as two
    microbatches in flight together."""
    monkeypatch.setattr(batch.CONFIG, "micro_batch", 8)
    rng = np.random.default_rng(31 + shared)
    queries = []
    for q in range(32):
        s1, s2 = random_sequences(2048, 512 - 3 * (q % 4), seed=int(rng.integers(1 << 30)))
        if shared and queries:
            s1 = queries[0].seq1
        queries.append(Query(np.array([1.0, 3.0, 4.0, 2.0]), s1, s2, q % 2 == 0))
    before = (sw.launches_batched, sw.launches_batched_shared)
    got = batch.search_batch(queries)
    want = batch.search_batch(queries, backend="numpy")
    assert got == want
    after = (sw.launches_batched, sw.launches_batched_shared)
    assert after[1] - before[1] == 4 if shared else after[0] - before[0] == 4


@pytest.mark.parametrize("shared", [False, True])
def test_tcp_serve_on_card_matches_native(cuda, shared):
    """64 queries from 4 clients through the TCP server on the card (its
    event loop on this thread, the clients on threads): every reply equals
    the native engine's, and the chunks went through the batched kernel
    (the shared-Seq1 one when every query has the one Seq1)."""
    ref = random_sequences(2048, 1, seed=0)[0]
    lines = []
    for s in range(64):
        s1, s2 = random_sequences(2048, 512, seed=s)
        lines.append(f"1 3 4 2 {ref if shared else s1} {s2} minimum")
    want = server.process_query_lines(lines, backend="native", lenient=False,
                                      json_out=False)[0]
    srv = server.TCPQueryServer("127.0.0.1", 0, backend="torch", lenient=False,
                                json_out=False, device=cuda, max_batch=16,
                                quiet=True)
    got = {}

    def client(c):
        while srv.bound_addr is None:
            threading.Event().wait(0.01)
        with socket.create_connection(srv.bound_addr, timeout=120) as sock:
            sock.sendall(("\n".join(lines[c::4]) + "\n").encode())
            sock.shutdown(socket.SHUT_WR)
            buf = b""
            while True:
                d = sock.recv(1 << 16)
                if not d:
                    break
                buf += d
        got[c] = buf.decode().splitlines()
        if len(got) == 4:
            srv.request_stop()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    before = (sw.launches_batched, sw.launches_batched_shared, native.calls["search"])
    for t in threads:
        t.start()
    assert srv.run() == 0
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for c in range(4):
        assert got[c] == want[c::4]
    per_row = sw.launches_batched - before[0]
    shared_n = sw.launches_batched_shared - before[1]
    assert (shared_n if shared else per_row) > 0
    assert native.calls["search"] == before[2]


class _NoNvcc:
    """Stands in for the subprocess module of ops/sweep: a build raises."""

    @staticmethod
    def Popen(*a, **k):
        raise AssertionError("nvcc ran after the warmup")

    run = Popen


@pytest.mark.parametrize("shared", [False, True])
def test_warmed_bucket_chunk_allocates_no_segment(cuda, shared, monkeypatch):
    """After `warm_fused_runner` at B = 256 on the serve path's bucket (the
    batch workload's 2048 x 512), a real 256-line chunk of that bucket
    allocates no new device segment and runs no nvcc; its replies equal
    the native engine's."""
    ref = random_sequences(2048, 1, seed=0)[0]
    lines = []
    for s in range(256):
        s1, s2 = random_sequences(2048, 512, seed=s)
        lines.append(f"1 3 4 2 {ref if shared else s1} {s2} minimum")
    want = server.process_query_lines(lines, backend="native", lenient=False,
                                      json_out=False)[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    l1k, l2p = sw.bucket_shape(2048, 512)
    batch.warm_fused_runner(build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False), 256,
                            l1k, l2p, cuda, shared_s1=shared)
    assert sw._lib is not None
    monkeypatch.setattr(sw, "subprocess", _NoNvcc)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["segment.all.allocated"]
    kernels = (sw.launches_batched, sw.launches_batched_shared)
    got = server.dispatch_query_lines(lines, backend="torch", lenient=False,
                                      json_out=False, device=cuda).finish()[0]
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["segment.all.allocated"] == before
    assert got == want
    launched = (sw.launches_batched - kernels[0], sw.launches_batched_shared - kernels[1])
    assert launched == ((0, 1) if shared else (1, 0))


@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (8, 1), (1, 2), (2, 2), (2, 4)])
def test_sharded_mesh_on_the_card(cuda, shape):
    """1-D and 2-D meshes of the one card: one `sweep` launch per shard and
    the numpy engine's winner."""
    from psa_torch.parallel import mesh

    rng = np.random.default_rng(sum(shape))
    c1, c2 = codes(rng, 30_000, False), codes(rng, 3_000, False)
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    n_op, n_ch = shape
    before = sw.launches
    if n_ch == 1:
        got = mesh.search_sharded(c1, c2, t, [cuda] * n_op)
    else:
        got = mesh.search_sharded_2d(c1, c2, t, mesh.make_mesh_2d([cuda] * (n_op * n_ch),
                                                                   n_op, n_ch))
    assert sw.launches - before == n_op * n_ch
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False,
                                backend="numpy").search_codes(c1, c2)
    assert got == ref


def test_sharded_fallback_on_the_card(cuda):
    from psa_torch.parallel import mesh

    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    c1, c2 = np.zeros(20_000, np.int32), np.zeros(500, np.int32)
    mesh.fallbacks = 0
    got = mesh.search_sharded(c1, c2, t, [cuda] * 4)
    assert mesh.fallbacks == 1 and got.offset == 0
    assert got == AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False,
                                        backend="native").search_codes(c1, c2)


@pytest.mark.parametrize("shared", [False, True])
def test_sharded_batch_on_the_card(cuda, shared):
    """The batch sharded over 4 entries of the card: one batched launch per
    block, the unsharded call's winners."""
    qs = []
    for s in range(64):
        s1, s2 = random_sequences(1500, 300, seed=s)
        qs.append(Query(np.array([1.0, 3.0, 4.0, 2.0]), qs[0].seq1 if shared and qs else s1,
                        s2, False))
    want = batch.search_batch(qs, device=cuda)
    before = (sw.launches_batched, sw.launches_batched_shared)
    got = batch.search_batch(qs, mesh=[cuda] * 4)
    launched = (sw.launches_batched - before[0], sw.launches_batched_shared - before[1])
    assert launched == ((0, 4) if shared else (4, 0))
    assert got == want


@pytest.mark.parametrize("engine", ["conv", "xla"])
@pytest.mark.parametrize("n1,n2,is_max", [(20_000, 2000, False), (70_511, 70_000, True)])
def test_engine_stats_equal_native_on_the_card(cuda, engine, n1, n2, is_max):
    """The differential engines' stats on the card, integer for integer
    against the native host engine's, and their winners."""
    from psa_torch.ops.engine_conv import offset_stats_conv
    from psa_torch.ops.engine_xla import offset_stats_xla

    rng = np.random.default_rng(n1 + is_max)
    c1, c2 = codes(rng, n1, False), codes(rng, n2, False)
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), is_max)
    fn = offset_stats_conv if engine == "conv" else offset_stats_xla
    counts, maxrank = fn(c1, c2, t, cuda)
    want_c, want_m = native.offset_stats_native(c1, c2, t)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(maxrank, want_m)
    got = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], is_max, backend=engine).search_codes(c1, c2)
    assert got == AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], is_max,
                                        backend="native").search_codes(c1, c2)


def test_conv_integer_check_raises_on_the_card(cuda):
    """Operands that are not 0/1 give a non-integer conv output: the engine's
    check on the card raises instead of rounding it away."""
    from psa_torch.ops import engine_conv

    rng = np.random.default_rng(0)
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    c1 = torch.from_numpy(codes(rng, 5000, False)).to(cuda)
    c2 = torch.from_numpy(codes(rng, 300, False)).to(cuda)
    x = engine_conv.onehot_seq1(c1)[None]
    k = engine_conv.indicator_filter(torch.from_numpy(t.code).to(cuda), c2, t.num_ranks)
    with pytest.raises(RuntimeError, match="from an integer"):
        engine_conv.stats5_from_conv(engine_conv.conv1d_f32(x * 0.3, k)[0])
    exact = engine_conv.stats5_from_conv(engine_conv.conv1d_f32(x, k)[0])
    assert exact.dtype == torch.int32 and exact.is_cuda


# (rows, NP, noff, count range, weights, is_max, g0): one block per row
# (no scratch), several blocks (the last block of a row merges), exact key
# ties at 1 3 4 2, all keys equal (every block's candidates tie at the
# row's k-th key), noff < k, a row with no valid offset, a shard's g0, and
# three wide rows of their own noff (a ticket each)
EPILOGUE_CASES = {
    "batch_rows_per_row_noff": (1024, 1792, "per_row", 128, (1.0, 3.0, 4.0, 2.0), False, 0),
    "north_star_width": (1, 90_112, 90_001, 2500, (2.0, 1.0, 5.0, 0.5), True, 0),
    "ties_1M": (1, 998_400, 998_000, 3, (1.0, 3.0, 4.0, 2.0), False, 0),
    "all_equal": (2, 200_000, 199_000, 1, (1.0, 3.0, 4.0, 2.0), False, 0),
    "noff_lt_k": (3, 256, 7, 100, (1.0, 3.0, 4.0, 2.0), True, 0),
    "no_valid_offset": (2, 6000, 0, 100, (1.0, 3.0, 4.0, 2.0), False, 0),
    "shard_g0": (1, 22_528, 20_000, 500, (1.0, 3.0, 4.0, 2.0), False, 67_584),
    "wide_rows_per_row_noff": (3, 5 * 2048 + 1, "per_row", 300,
                               (np.pi / 4, np.e / 7, np.sqrt(2) / 3, 1 / 3), False, 0),
}


def epilogue_case(cuda, case):
    """(stats5 on the card, its host copy, noff, device tables, g0) of one
    of EPILOGUE_CASES."""
    b, np_len, noff, hi, w, is_max, g0 = EPILOGUE_CASES[case]
    rng = np.random.default_rng(np_len + b)
    t = build_tables(np.array(w), is_max)
    st = np.concatenate([rng.integers(0, hi, (b, 4, np_len)),
                         rng.integers(-1, t.num_ranks, (b, 1, np_len))],
                        axis=1).astype(np.int32)
    if case == "all_equal":
        st[:, :4] = 0
        st[:, 4] = 0
    if noff == "per_row":
        noff = torch.from_numpy(rng.integers(1, np_len + 1, b).astype(np.int32)).to(cuda)
    return torch.from_numpy(st).to(cuda), st, noff, device_tables(t, cuda), g0


@pytest.mark.parametrize("case", sorted(EPILOGUE_CASES))
def test_epilogue_kernel_matches_plain(cuda, case):
    """csrc/epilogue.cu against its plain version on the same card
    tensors, word for word (`pack_mismatch` names the first difference),
    in exactly one CUDA launch."""
    d, st, noff, dt, g0 = epilogue_case(cuda, case)
    before = ep.launches, ep.cuda_launches
    got = ep.epilogue_pack(d, dt, noff, 512, g0=g0)
    torch.cuda.synchronize()
    assert (ep.launches, ep.cuda_launches) == (before[0] + 1, before[1] + 1)
    want = ep.epilogue_pack_plain(d, dt, noff, 512, g0=g0)
    assert ep.pack_mismatch(want, got, st, noff, dt, g0) is None
    assert torch.equal(got, want)
    if case == "all_equal":
        assert (got[:, 6 * ep.TOPK].cpu() == d.shape[2] - 1000).all()


def test_epilogue_kernel_repeats_and_resets_its_tickets(cuda):
    """The same wide call three times gives the same pack (equal keys fall
    to the lowest offset, and each row's last block resets its ticket), and
    every ticket of the stream's scratch is 0 after."""
    for case in ("ties_1M", "wide_rows_per_row_noff", "all_equal"):
        d, _, noff, dt, g0 = epilogue_case(cuda, case)
        packs = [ep.epilogue_pack(d, dt, noff, 512, g0=g0) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(p, packs[0]) for p in packs[1:]), case
        stream = torch.cuda.current_stream().cuda_stream
        tickets, _ = ep._scratch[(d.device.index, stream)]
        assert not tickets.any().item(), case


def test_epilogue_kernel_smaller_call_after_larger(cuda):
    """The cached scratch serves a smaller call after a larger one without
    shrinking, and the wrapper's scratch words are the kernel's own."""
    lib = sw.build_library()
    assert lib.psa_epilogue_params() == ep.PARAMS
    for b, np_len, k in ((1, 2048, 32), (1, 2049, 32), (3, 10_241, 32), (2, 90_112, 64),
                         (1024, 1792, 32), (1, 998_400, 7)):
        for cols in (ep.NARROW_COLS, ep.EPILOGUE_COLS):
            assert (lib.psa_epilogue_scratch_words(b, np_len, k, cols)
                    == ep.scratch_words(b, np_len, k, cols))
    big, _, noff_big, dt, _ = epilogue_case(cuda, "wide_rows_per_row_noff")
    ep.epilogue_pack(big, dt, noff_big, 512)
    stream = torch.cuda.current_stream().cuda_stream
    data = ep._scratch[(big.device.index, stream)][1]
    small = big[:1, :, :4100].contiguous()
    got = ep.epilogue_pack(small, dt, 4000, 512)
    assert ep._scratch[(big.device.index, stream)][1] is data
    assert torch.equal(got, ep.epilogue_pack_plain(small, dt, 4000, 512))
    assert torch.equal(ep.epilogue_pack(big, dt, noff_big, 512),
                       ep.epilogue_pack_plain(big, dt, noff_big, 512))


def test_epilogue_kernel_on_the_device_paths(cuda):
    """The single query, a batch and a sharded query each run the kernel:
    one epilogue launch per query, per microbatch and per shard."""
    rng = np.random.default_rng(3)
    c1, c2 = codes(rng, 30_000, False), codes(rng, 900, False)
    eng = AlignmentSearchEngine((1, 3, 4, 2), False)
    before = ep.launches
    want = eng.search_codes(c1, c2)
    assert ep.launches == before + 1
    assert mesh.search_sharded(c1, c2, eng.tables, [cuda] * 4) == want
    assert ep.launches == before + 5
    qs = [Query(np.array([1.0, 3.0, 4.0, 2.0]), *random_sequences(2048, 512, seed=s), False)
          for s in range(8)]
    assert len(batch.search_batch(qs)) == 8
    assert ep.launches == before + 6


def test_epilogue_kernel_refuses_bad_operands(cuda):
    """The wrapper raises before a launch on what the kernel does not take:
    NP < k, a non-contiguous offset axis, a noff tensor of another type."""
    dt = device_tables(build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False), cuda)
    st = torch.zeros((2, 5, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ep.epilogue_pack(st[..., :16], dt, 16, 64)
    with pytest.raises(ValueError):
        ep.epilogue_pack(st.transpose(1, 2).contiguous().transpose(1, 2), dt, 64, 64)
    with pytest.raises(ValueError):
        ep.epilogue_pack(st, dt, torch.tensor([64, 64], device=cuda), 64)
