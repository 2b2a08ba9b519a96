"""The even split of the single-query sweep (`ops/sweep.sweep_plan`, the
model of csrc/sweep.cu's indexing) on the CPU: every (warp tile, 32-position
unit) is swept exactly once, no worker takes more than ceil(U / W) units,
steps stay inside one tile and one ring stage, and the writes the kernel
makes from those steps (a store, then adds, where a worker owns a whole
tile; atomics into an output set to 0 and -1 where workers share it) give
`sweep_plain`'s stats5 bit for bit."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from psa_torch.core.alphabet import HYPHEN_CODE, OTHER_CODE, PAD_CODE
from psa_torch.core.tables import build_tables
from psa_torch.ops import sweep as sw

# Workers of the kernel on an H100: 4 resident two-warp blocks on 132 SMs
# (two warps a scheduler), as the card's plans report them.
H100_WORKERS = 528

# (n1, n2) of the timed shapes and of the split's edges.
SHAPES = {
    "north_star": (100_000, 10_000),
    "bench": (131_072, 8192),
    "long_seq1": (400_000, 2048),
    "seq1_1M": (1_000_000, 2048),
    "few_units": (1000, 137),
    "noff_1": (300, 300),
    "tile_over_90_workers": (40_000, 30_000),
    "ranges_of_whole_tiles": (2_000_000, 20),
    "whole_tiles_ragged_step": (2_000_000, 1500),
}


def boundary_split_tiles(units, upt, workers):
    """Tiles with a worker boundary strictly inside them, counted the way
    csrc/sweep.cu's split_tiles counts them."""
    return len({b // upt for b in (w * units // workers for w in range(1, workers))
                if b % upt})


def check_plan(noff_pad, l2p, workers):
    """The plan's invariants; returns it."""
    plan = sw.sweep_plan(noff_pad, l2p, workers)
    upt = l2p // sw.L2_ALIGN
    units = plan["units"]
    assert units == -(-noff_pad // sw.WARP_TILE) * upt
    assert plan["per_worker"] == math.ceil(units / workers)
    seen = np.zeros(units, np.int32)
    split = set()
    for w, steps in enumerate(plan["steps"]):
        begin, end = w * units // workers, (w + 1) * units // workers
        u = begin
        for t, p0, seg, atomic, first in steps:
            assert t * upt * sw.L2_ALIGN + p0 == u * sw.L2_ALIGN   # contiguous
            assert 0 < seg <= sw.SEG and seg % sw.L2_ALIGN == 0
            assert p0 % sw.L2_ALIGN == 0 and p0 + seg <= l2p        # one tile
            # every copy is a multiple of 16 bytes from a 16-byte boundary
            assert (t * sw.WARP_TILE + p0) % 16 == 0 and (sw.WARP_TILE + seg) % 16 == 0
            assert first == (u == begin or p0 == 0)
            owns = begin <= t * upt and (t + 1) * upt <= end
            assert atomic == (not owns)
            if atomic:
                split.add(t)
            seen[u: u + seg // sw.L2_ALIGN] += 1
            u += seg // sw.L2_ALIGN
        assert u == end
    assert (seen == 1).all()
    assert plan["split_tiles"] == len(split) == boundary_split_tiles(units, upt, workers)
    return plan


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_covers_every_unit_once(case):
    n1, n2 = SHAPES[case]
    _, noff_pad, l2p, _ = sw.plan_shapes(n1, n2)
    plan = check_plan(noff_pad, l2p, H100_WORKERS)
    steps = [s for mine in plan["steps"] for s in mine]
    upt = l2p // sw.L2_ALIGN
    if case == "north_star":
        # 27,544 units over 528 workers: at most one above the average
        assert plan["units"] == 27_544 and plan["per_worker"] == 53
    if case in ("few_units", "noff_1"):
        assert plan["units"] < H100_WORKERS
        assert sum(1 for mine in plan["steps"] if mine) == plan["units"]
    if case == "tile_over_90_workers":
        owners = {}
        for w, mine in enumerate(plan["steps"]):
            for t, *_ in mine:
                owners.setdefault(t, set()).add(w)
        assert max(len(v) for v in owners.values()) >= 50
    if case == "ranges_of_whole_tiles":
        assert upt == 1 and plan["split_tiles"] == 0
        assert max(len(mine) for mine in plan["steps"]) >= 2
    if case == "whole_tiles_ragged_step":
        # a worker owns a whole tile in a full step and a ragged last one
        assert any(not a and seg < sw.SEG and p0 == sw.SEG
                   for t, p0, seg, a, f in steps)
    if case == "seq1_1M":
        assert any(not a and not f for t, p0, seg, a, f in steps)   # add step
    assert any(a for *_, a, f in steps) == (plan["split_tiles"] > 0)


@settings(max_examples=150, deadline=None)
@given(tiles=st.integers(1, 40), upt=st.integers(1, 120),
       workers=st.integers(1, 4000))
def test_plan_invariants_drawn(tiles, upt, workers):
    check_plan(tiles * sw.TILE_O, upt * sw.L2_ALIGN, workers)


def run_plan(c1, c2, code, workers):
    """The kernel's writes, in numpy: each step's stats5 (from the plain
    gather over its tile's offsets inside noff_pad and its positions)
    stored, added or added atomically, as csrc/sweep.cu writes them."""
    noff_pad, l2p = c1.shape[0] - c2.shape[0], c2.shape[0]
    plan = sw.sweep_plan(noff_pad, l2p, workers)
    out = np.full((5, noff_pad), 0x5EED, np.int64)        # never written
    if plan["split_tiles"]:
        out[:4], out[4] = 0, -1
    for mine in plan["steps"]:
        for t, p0, seg, atomic, first in mine:
            o0 = t * sw.WARP_TILE
            width = min(sw.WARP_TILE, noff_pad - o0)    # a last tile's part
            part = sw.stats5_from_sweep(sw.sweep_rows_plain(
                c1[o0 + p0: o0 + p0 + width + seg], c2[p0: p0 + seg],
                code)).numpy()
            cols = slice(o0, o0 + width)
            if first and not atomic:
                out[:, cols] = part
            else:
                out[:4, cols] += part[:4]
                out[4, cols] = np.maximum(out[4, cols], part[4])
    return out


@pytest.mark.parametrize("n1,n2,workers", [
    (3000, 2500, 1),       # one worker, two tiles of three steps each
    (3000, 2500, 2),       # a range that ends mid-tile
    (3000, 2500, 7),
    (1400, 64, 3),         # ranges of several tiles
    (1400, 64, 1000),      # fewer units than workers
    (700, 700, 5),         # noff = 1
    (5000, 1200, 50),      # a ragged last step in a shared tile
])
def test_plan_writes_give_sweep_plain(n1, n2, workers):
    rng = np.random.default_rng(n1 + n2 + workers)
    codes1 = rng.integers(0, PAD_CODE + 1, n1).astype(np.int32)
    codes2 = rng.integers(0, PAD_CODE + 1, n2).astype(np.int32)
    codes1[::31] = HYPHEN_CODE
    codes2[::37] = OTHER_CODE
    _, _, l2p, l1k = sw.plan_shapes(n1, n2)
    c1, c2 = sw.upload_codes("cpu", (codes1, l1k), (codes2, l2p))
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         workers % 2 == 1).code)
    np.testing.assert_array_equal(run_plan(c1, c2, code, workers),
                                  sw.sweep_plain(c1, c2, code).numpy())
