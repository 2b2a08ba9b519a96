"""The split of the kernel lab's v2 and v3 sweeps over Seq2 segments
(psa_torch.ops._sweep_v2.v2_launch_plan and _sweep_v3.v3_launch_plan, both
`segment_plan`, the model of csrc/sweep_mma.cuh's launch): every (tile,
chunk) covered once, no v3 segment longer than its byte-lane counters hold
(v2 folds every chunk and has no such cap), enough blocks for the card, and
segments whose partial rows, added and maxed as the kernels' atomics do,
give the plain version's rows (v2 on lenient inputs, row 3 included).  The
card's own plans are held against this model in tests/test_torch_gpu.py
and chip_smoke.py; the kernels' SASS names are read here."""

import itertools

import numpy as np
import pytest
import torch

from psa_torch.core.alphabet import HYPHEN_CODE, OTHER_CODE, PAD_CODE
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
VARIANTS = ("v2", "v3")
# (module, launch plan, lane cap) of each variant
SPLIT = {"v2": (v2, v2.v2_launch_plan, None),
         "v3": (v3, v3.v3_launch_plan, v3.LANE_CHUNKS)}


def plan_of(shape, slots, variant="v3"):
    _, noff_pad, l2p, _ = v3.plan_shapes_v3(*SHAPES[shape])
    return noff_pad, l2p, SPLIT[variant][1](noff_pad, l2p, slots)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_plan_covers_every_tile_and_chunk_once(variant, shape, slots):
    noff_pad, l2p, plan = plan_of(shape, slots, variant)
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
@pytest.mark.parametrize("variant", VARIANTS)
def test_plan_fills_the_card_with_the_fewest_segments(variant, shape, slots):
    """Every slot gets BLOCKS_PER_SLOT blocks unless each segment is already
    one chunk, and one segment fewer would break the lanes (v3) or the
    fill."""
    mod, _, lane_chunks = SPLIT[variant]
    _, _, plan = plan_of(shape, slots, variant)
    segs, tiles, chunks = plan["segs"], plan["tiles"], plan["chunks"]
    assert plan["blocks"] >= mod.BLOCKS_PER_SLOT * slots or segs == chunks
    if segs > 1:
        fewer = segs - 1
        assert ((lane_chunks is not None and -(-chunks // fewer) > lane_chunks)
                or tiles * fewer < mod.BLOCKS_PER_SLOT * slots)
    if lane_chunks is None:
        assert segs == min(chunks, -(-mod.BLOCKS_PER_SLOT * slots // tiles))


# The grids on a card of 132 SMs: (variant, blocks per SM) -> (segments at
# the lab's shape, 481 tiles of 128 chunks; at the north star, 352 tiles of
# 157 chunks).  v3's lane cap sets its counts (segments of 14-15 chunks);
# v2's come from the fill alone.
GRIDS = {("v3", 8): (9, 11), ("v2", 4): (3, 3), ("v2", 8): (5, 6)}


@pytest.mark.parametrize("variant,per_sm", sorted(GRIDS))
def test_plan_at_the_lab_and_north_star_shapes(variant, per_sm):
    """The grids at the lab's shape and the north star on a card of 132
    SMs with `per_sm` resident blocks each (GRIDS)."""
    lab, north_star = GRIDS[variant, per_sm]
    assert {k: plan_of("lab", 132 * per_sm, variant)[2][k]
            for k in ("tiles", "chunks", "segs")} == {
        "tiles": 481, "chunks": 128, "segs": lab}
    assert {k: plan_of("north_star", 132 * per_sm, variant)[2][k]
            for k in ("tiles", "chunks", "segs")} == {
        "tiles": 352, "chunks": 157, "segs": north_star}


def test_v2_takes_one_segment_per_tile_at_1m_by_500():
    """1M x 500: 3905 tiles fill a card of 132 SMs at 8 resident blocks
    twice over, so v2 takes one segment per tile (plain stores)."""
    _, noff_pad, l2p, _ = v2.plan_shapes_v2(1_000_000, 500)
    plan = v2.v2_launch_plan(noff_pad, l2p, 1056)
    assert (plan["tiles"], plan["chunks"], plan["segs"], plan["atomic"]) == (
        3905, 8, 1, False)


def lenient_codes(rng, n):
    """Letters with hyphens and OTHER_CODE: OTHER_CODE pairs are inert, so
    row 3 (nonzero - the rest) differs from n2 - the rest."""
    c = rng.integers(0, 26, n)
    c[rng.random(n) < 0.1] = HYPHEN_CODE
    c[rng.random(n) < 0.1] = OTHER_CODE
    return c


@pytest.mark.parametrize("slots", [4, 64, 1000])
@pytest.mark.parametrize("variant", VARIANTS)
def test_segments_added_and_maxed_give_the_whole_sweep(variant, slots):
    """The kernel's blocks each sweep one segment of Seq2 and meet in
    atomicAdd (rows 0-2, and v2's row 3) and atomicMax (row 4) on a zeroed
    output: replayed with the plain version on Seq2 masked to each segment
    (PAD_CODE is inert), the result equals the plain version of the whole.
    v3 on clean inputs; v2 on lenient ones, whose row 3 counts the valid
    class-3 pairs of each segment."""
    mod, launch_plan, _ = SPLIT[variant]
    plain = {"v2": v2.sweep_v2_plain, "v3": v3.sweep_v3_plain}[variant]
    rows_added = {"v2": 4, "v3": 3}[variant]
    rng = np.random.default_rng(slots)
    n1, n2 = 900, 450
    _, noff_pad, l2p, l1k = v3.plan_shapes_v3(n1, n2)
    plan = launch_plan(noff_pad, l2p, slots)
    assert plan["segs"] > 1
    if variant == "v2":
        c1, c2 = lenient_codes(rng, n1), lenient_codes(rng, n2)
    else:
        c1, c2 = rng.integers(0, 26, n1), rng.integers(0, 26, n2)
    d1, d2 = sw.upload_codes("cpu", (c1, l1k), (c2, l2p))
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False).code)
    whole = plain(d1, d2, code)
    if variant == "v2":
        assert 0 < int(whole[3, :n1 - n2 + 1].min()) and int(
            (whole[:4, :n1 - n2 + 1].sum(0)).max()) < n2
    acc = torch.zeros((8, noff_pad), dtype=torch.int32)
    for b, e in plan["segments"]:
        part = torch.full_like(d2, PAD_CODE)
        part[b * mod.CHUNK: e * mod.CHUNK] = d2[b * mod.CHUNK: e * mod.CHUNK]
        rows = plain(d1, part, code)
        acc[:rows_added] += rows[:rows_added]
        acc[4] = torch.maximum(acc[4], rows[4])
    assert torch.equal(acc, whole)


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


def test_ptxas_registers_reads_the_build_log():
    """Registers per thread of each kernel from nvcc's -Xptxas -v lines in
    the build log, by the kernel's name (utils/lab_ab reports them)."""
    def fn(ns_file, kernel):
        ns = f"_GLOBAL__N__71c8276e_{len(ns_file)}_{ns_file}_c09359e6"
        return f"_ZN{len(ns)}{ns}{len(kernel)}{kernel}EPKhS1_iPKaPii"

    log = f"""== sweep_mma.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{fn("sweep_mma_cu", "sweep_mma_kernel")}' for 'sm_90a'
ptxas info    : Function properties for {fn("sweep_mma_cu", "sweep_mma_kernel")}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 20224 bytes smem, 400 bytes cmem[0]
== sweep_mma_v3.cu
ptxas info    : Compiling entry function '{fn("sweep_mma_v3_cu", "sweep_v3_kernel")}' for 'sm_90a'
ptxas info    : Used 64 registers, 20224 bytes smem, 400 bytes cmem[0]
"""
    assert kernel_lab.ptxas_registers(log) == {"sweep_mma_kernel": 40, "sweep_v3_kernel": 64}
