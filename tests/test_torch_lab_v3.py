"""The split of the kernel lab's v3 sweep over Seq2 segments
(psa_torch.ops._sweep_v3.v3_launch_plan, the model of
csrc/sweep_mma_v3.cu's launch): every (tile, chunk) covered once, no segment
longer than the byte-lane counters hold, enough blocks for the card, and
segments whose partial rows, added and maxed as the kernel's atomics do,
give the plain version's rows.  The card's own plan is held against this
model in tests/test_torch_gpu.py and chip_smoke.py; the kernel's SASS name
is read here."""

import itertools

import numpy as np
import pytest
import torch

from psa_torch.core.alphabet import PAD_CODE
from psa_torch.core.tables import build_tables
from psa_torch.ops import _sweep_v2 as v2
from psa_torch.ops import _sweep_v3 as v3
from psa_torch.ops import sweep as sw
from psa_torch.utils import kernel_lab

# (n1, n2): the lab's shape, the north star, MAX_N2 on one tile and on 128,
# and a ragged small query
SHAPES = {"lab": (131_072, 8192), "north_star": (100_000, 10_000),
          "max_n2_one_tile": (v3.MAX_N2 + 255, v3.MAX_N2),
          "max_n2_128_tiles": (v3.MAX_N2 + 128 * 256 - 1, v3.MAX_N2),
          "small": (1000, 137)}
# resident block slots: one SM's worth, and 132 SMs at 1, 4 and 8 blocks
SLOTS = [1, 132, 528, 1056]


def plan_of(shape, slots):
    _, noff_pad, l2p, _ = v3.plan_shapes_v3(*SHAPES[shape])
    return noff_pad, l2p, v3.v3_launch_plan(noff_pad, l2p, slots)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_covers_every_tile_and_chunk_once(shape, slots):
    noff_pad, l2p, plan = plan_of(shape, slots)
    assert (plan["tiles"], plan["chunks"]) == (noff_pad // v3.TILE, l2p // v3.CHUNK)
    assert len(plan["segments"]) == plan["segs"]
    assert plan["blocks"] == plan["tiles"] * plan["segs"]
    covered = [(tile, c) for tile, (b, e) in itertools.product(
        range(plan["tiles"]), plan["segments"]) for c in range(b, e)]
    assert len(covered) == len(set(covered)) == plan["tiles"] * plan["chunks"]
    assert all(e > b for b, e in plan["segments"])
    assert plan["atomic"] == (plan["segs"] > 1)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_no_segment_exceeds_the_byte_lanes(shape, slots):
    """A byte lane gains at most CHUNK / 4 a chunk (every pair of a 4-pair
    word in class 2 adds one to each counter); a segment of most_chunks
    chunks must stay below 256.  LANE_CHUNKS is the largest such count."""
    _, _, plan = plan_of(shape, slots)
    lengths = [e - b for b, e in plan["segments"]]
    assert plan["most_chunks"] == max(lengths) <= v3.LANE_CHUNKS
    assert max(lengths) - min(lengths) <= 1
    assert v3.LANE_CHUNKS * (v3.CHUNK // 4) <= 255 < (v3.LANE_CHUNKS + 1) * (v3.CHUNK // 4)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_fills_the_card_with_the_fewest_segments(shape, slots):
    """Every slot gets BLOCKS_PER_SLOT blocks unless each segment is already
    one chunk, and one segment fewer would break the lanes or the fill."""
    _, _, plan = plan_of(shape, slots)
    segs, tiles, chunks = plan["segs"], plan["tiles"], plan["chunks"]
    assert plan["blocks"] >= v3.BLOCKS_PER_SLOT * slots or segs == chunks
    if segs > 1:
        fewer = segs - 1
        assert (-(-chunks // fewer) > v3.LANE_CHUNKS
                or tiles * fewer < v3.BLOCKS_PER_SLOT * slots)


def test_plan_at_the_lab_and_north_star_shapes():
    """The grids at the lab's shape and the north star on a card of 132
    SMs with 8 resident blocks each: 481 tiles x 9 segments and 352 x 11,
    each segment 14-15 chunks."""
    assert {k: plan_of("lab", 1056)[2][k] for k in ("tiles", "chunks", "segs")} == {
        "tiles": 481, "chunks": 128, "segs": 9}
    assert {k: plan_of("north_star", 1056)[2][k] for k in ("tiles", "chunks", "segs")} == {
        "tiles": 352, "chunks": 157, "segs": 11}


@pytest.mark.parametrize("slots", [4, 64, 1000])
def test_segments_added_and_maxed_give_the_whole_sweep(slots):
    """The kernel's blocks each sweep one segment of Seq2 and meet in
    atomicAdd (rows 0-2) and atomicMax (row 4) on a zeroed output: replayed
    with the plain version on Seq2 masked to each segment (PAD_CODE is
    inert), the result equals the plain version of the whole."""
    rng = np.random.default_rng(slots)
    n1, n2 = 900, 450
    _, noff_pad, l2p, l1k = v3.plan_shapes_v3(n1, n2)
    plan = v3.v3_launch_plan(noff_pad, l2p, slots)
    assert plan["segs"] > 1
    d1 = sw.upload_codes(rng.integers(0, 26, n1), l1k, "cpu")
    d2 = sw.upload_codes(rng.integers(0, 26, n2), l2p, "cpu")
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False).code)
    acc = torch.zeros((8, noff_pad), dtype=torch.int32)
    for b, e in plan["segments"]:
        part = torch.full_like(d2, PAD_CODE)
        part[b * v3.CHUNK: e * v3.CHUNK] = d2[b * v3.CHUNK: e * v3.CHUNK]
        rows = v3.sweep_v3_plain(d1, part, code)
        acc[:3] += rows[:3]
        acc[4] = torch.maximum(acc[4], rows[4])
    assert torch.equal(acc, v3.sweep_v3_plain(d1, d2, code))


def test_sass_loop_mix_reads_the_v3_kernel():
    """v3's kernel has its own name (no template argument) and its chunk
    loop is its main loop, of v3.CHUNK pairs per thread; v2's kernel keeps
    the name sweep_mma_kernel."""
    def fn(ns_file, kernel):
        ns = f"_GLOBAL__N__71c8276e_{len(ns_file)}_{ns_file}_c09359e6"
        return f"_ZN{len(ns)}{ns}{len(kernel)}{kernel}EPKhS1_iPKaPii"

    sass = f"""
        Function : {fn("sweep_mma_v3_cu", "sweep_v3_kernel")}
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.U8.CONSTANT R4, [R2.64] ;
        /*0020*/                   IMMA.16832.S8.S8 R4, R8, R12, RZ ;
        /*0030*/                   STS.U8 [R2], R4 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   LDS R5, [R3] ;
        /*0060*/                   VIMNMX3.S16x2 R6, R6, R5, R7 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/              @!P0 BRA 0x10 ;
        /*0090*/                   RED.E.ADD.STRONG.GPU [R8.64], R5 ;
        /*00a0*/                   EXIT ;
        Function : {fn("sweep_mma_cu", "sweep_mma_kernel")}
        /*0000*/                   LDS R5, [R3] ;
        /*0010*/              @!P0 BRA 0x0 ;
        /*0020*/                   EXIT ;
"""
    mix = kernel_lab.sass_loop_mix(sass)
    assert sorted(mix) == ["sweep_mma_kernel", "sweep_v3_kernel"]
    got = mix["sweep_v3_kernel"]
    assert got["instructions"] == 8 and got["segments"] == [3, 2, 1]
    assert kernel_lab.LOOP_PAIRS["sweep_v3_kernel"] == v3.CHUNK
    assert got["per_pair"] == 8 / v3.CHUNK
    assert got["mix"]["IMMA.16832.S8.S8"] == 1 and "RED.E.ADD.STRONG.GPU" not in got["mix"]
    assert mix["sweep_mma_kernel"]["per_pair"] == 2 / v2.CHUNK


def test_dispatch_ms_reads_the_loop_mix():
    """The dispatch floor of v3's loop: its SASS per pair over `pairs` pairs
    at one warp instruction per scheduler per clock; None for a kernel
    whose loop is not known."""
    mix = {"sweep_v3_kernel": {"per_pair": 6.5}, "sweep_mma_kernel": {"per_pair": None}}
    pairs = 131_072 * 8192.0
    want = pairs * 6.5 / 32 / kernel_lab.WARP_DISPATCH_PER_S * 1e3
    assert kernel_lab.dispatch_ms(mix, "sweep_v3_kernel", pairs) == pytest.approx(want, rel=1e-12)
    assert kernel_lab.WARP_DISPATCH_PER_S == 132 * 4 * 1.98e9
    assert kernel_lab.dispatch_ms(mix, "sweep_mma_kernel", pairs) is None
    assert kernel_lab.dispatch_ms(mix, "sweep_mma_kernel<true>", pairs) is None
