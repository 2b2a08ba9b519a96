"""The even split of the batched sweeps (`ops/sweep.batched_split_plan`, the
model of csrc/sweep_batched.cu's indexing) on the CPU: every (query, tile,
unit) is swept exactly once, no worker takes more than ceil(U / W) units
where Seq2 spans more than one step, the work list of one-step items is the
list of whole items it was before the split went even, steps stay inside
one item and one ring stage, and the writes the kernels make from those
steps (a store, then adds, where a worker owns a whole item; atomics into
an output set to 0 and -1 where workers share it) give the plain batched
stats5 bit for bit."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from psa_torch.core.alphabet import HYPHEN_CODE, OTHER_CODE, PAD_CODE
from psa_torch.core.tables import build_tables
from psa_torch.ops import sweep as sw

# Workers of the batched kernels on an H100, as their plans report them: 4
# resident two-warp blocks on 132 SMs (both kernels: two warps a
# scheduler); and the 3,696 one-warp workers of the table route before
# them, a finer split of the same units.
H100_WORKERS = 528
FINE_WORKERS = 3696

# (b, n1, n2) of the benchmark's batch cells at several queries a launch,
# of the batch workload, and of the split's edges.
CELL = (600_000, 250_000)
SHAPES = {**{f"cell_b{b}": (b, *CELL) for b in (1, 2, 3, 4, 7, 8)},
          "batch_workload": (1024, 2048, 512),
          "noff_1": (5, 300, 300),
          "one_query_one_tile": (1, 3000, 2900)}


def bounds(w, units, workers):
    return w * units // workers, (w + 1) * units // workers


def check_worker(plan, b, l2p, workers, w, seen=None):
    """Worker w's steps: contiguous over its range, each inside one item
    and one ring stage, atomic exactly where the worker does not own the
    whole item; marks its units in `seen` and returns its atomic items."""
    upi = 1 if l2p <= sw.SEG else l2p // sw.L2_ALIGN
    unit = l2p // upi
    begin, end = bounds(w, plan["units"], workers)
    u, split = begin, set()
    for item, p0, seg, atomic, first in plan["steps"][w]:
        i0 = item * upi
        assert i0 * unit + p0 == u * unit                           # contiguous
        assert 0 < seg <= min(l2p, sw.SEG) and seg % sw.L2_ALIGN == 0
        assert p0 % sw.L2_ALIGN == 0 and p0 + seg <= l2p            # one item
        t = item // b
        # every copy is a multiple of 16 bytes from a 16-byte boundary
        assert (t * sw.WARP_TILE + p0) % 16 == 0 and (sw.WARP_TILE + seg) % 16 == 0
        assert first == (u == begin or p0 == 0)
        assert atomic == (not (begin <= i0 and i0 + upi <= end))
        if atomic:
            split.add(item)
        if seen is not None:
            seen[u: u + seg // unit] += 1
        u += seg // unit
    assert u == end
    return split


def check_plan(b, noff_pad, l2p, workers, walk=None):
    """The plan's invariants, walking every worker (or those in `walk`);
    returns the plan."""
    plan = sw.batched_split_plan(b, noff_pad, l2p, workers)
    upi = 1 if l2p <= sw.SEG else l2p // sw.L2_ALIGN
    items = -(-noff_pad // sw.WARP_TILE) * b
    assert (plan["items"], plan["units"]) == (items, items * upi)
    assert plan["per_worker"] == math.ceil(plan["units"] / workers)
    assert len(plan["steps"]) == workers
    boundary = {x // upi for x in (bounds(w, plan["units"], workers)[0]
                                   for w in range(1, workers)) if x % upi}
    assert plan["split_items"] == len(boundary)
    if walk is None:
        seen = np.zeros(plan["units"], np.int32)
        split = set()
        for w in range(workers):
            split |= check_worker(plan, b, l2p, workers, w, seen)
        assert (seen == 1).all()
        assert split == boundary
    else:
        for w in walk:
            assert check_worker(plan, b, l2p, workers, w) <= boundary
    if upi == 1:
        # one-step items: the whole items [w I / W, (w + 1) I / W) each
        for w in (range(workers) if walk is None else walk):
            i, j = bounds(w, items, workers)
            assert plan["steps"][w] == [(k, 0, l2p, False, True) for k in range(i, j)]
        assert plan["split_items"] == 0
    return plan


@pytest.mark.parametrize("workers", [H100_WORKERS, FINE_WORKERS])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_covers_every_unit_once(case, workers):
    b, n1, n2 = SHAPES[case]
    _, noff_pad, l2p, _ = sw.plan_shapes(n1, n2)
    if case == "batch_workload":
        noff_pad = 1792                       # the batch path's padding
    big = case.startswith("cell")
    walk = (sorted({*range(4), *range(workers - 4, workers),
                    *range(0, workers, 251)}) if big else None)
    plan = check_plan(b, noff_pad, l2p, workers, walk)
    mean = plan["units"] / workers
    if big:
        # 342 tiles of 7813 units a query: within one unit of the mean
        assert plan["units"] == b * 342 * 7813
        assert plan["per_worker"] - mean < 1
        assert 1000 * mean / plan["per_worker"] > 999.9
        assert plan["split_items"] > 0
    if case == "cell_b4" and workers == H100_WORKERS:
        assert plan["per_worker"] == 20_243
    if case == "batch_workload":
        # whole-item chunks: 2 tiles a query, 2048 items, up to 4 a worker
        assert plan["units"] == plan["items"] == 2048
        assert plan["per_worker"] == (4 if workers == H100_WORKERS else 1)
    if case == "noff_1":
        assert plan["units"] == 5 and sum(1 for s in plan["steps"] if s) == 5
    if case == "one_query_one_tile":
        # one item of 91 units over more workers than units
        assert plan["units"] == 91 and plan["per_worker"] == 1
        assert plan["split_items"] == 1


@settings(max_examples=150, deadline=None)
@given(b=st.integers(1, 9), tiles=st.integers(1, 12), upt=st.integers(1, 90),
       workers=st.integers(1, 3000))
def test_plan_invariants_drawn(b, tiles, upt, workers):
    check_plan(b, tiles * sw.TILE_O, upt * sw.L2_ALIGN, workers)


def run_plan(c1, c2b, code, workers):
    """The kernels' writes, in numpy: each step's stats5 (from the plain
    gather over its tile's offsets inside noff_pad and its positions)
    stored, added or added atomically, as csrc/sweep_batched.cu writes them.  c1 is (B,
    l1k) or, for the shared kernel, one (l1k,) row."""
    b, l2p = c2b.shape
    noff_pad = c1.shape[-1] - l2p
    plan = sw.batched_split_plan(b, noff_pad, l2p, workers)
    out = np.full((b, 5, noff_pad), 0x5EED, np.int64)      # never written
    if plan["split_items"]:
        out[:, :4], out[:, 4] = 0, -1
    for mine in plan["steps"]:
        for item, p0, seg, atomic, first in mine:
            q, t = item % b, item // b
            o0 = t * sw.WARP_TILE
            width = min(sw.WARP_TILE, noff_pad - o0)    # a last tile's part
            row = c1 if c1.dim() == 1 else c1[q]
            part = sw.stats5_from_sweep(sw.sweep_rows_plain(
                row[o0 + p0: o0 + p0 + width + seg], c2b[q, p0: p0 + seg],
                code)).numpy()
            cols = slice(o0, o0 + width)
            if first and not atomic:
                out[q, :, cols] = part
            else:
                out[q, :4, cols] += part[:4]
                out[q, 4, cols] = np.maximum(out[q, 4, cols], part[4])
    return out


@pytest.mark.parametrize("b,n1,n2,workers,shared", [
    (3, 3000, 2100, 1, False),     # one worker, whole items of three steps
    (3, 3000, 2100, 7, False),     # ranges that start and end inside items
    (3, 3000, 2100, 7, True),
    (2, 1400, 1100, 3, False),     # two-step items, a ragged last step
    (4, 1400, 1100, 1000, True),   # fewer units than workers
    (5, 700, 700, 5, False),       # noff = 1, one-step items
    (6, 900, 300, 4, True),        # runs of queries on one Seq1 window
    (1, 5000, 1200, 50, False),    # one query, a ragged step in a shared item
])
def test_plan_writes_give_plain_stats5(b, n1, n2, workers, shared):
    rng = np.random.default_rng(b * n1 + n2 + workers)
    _, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
    c1 = np.full((b, l1k), PAD_CODE, np.uint8)
    c2b = np.full((b, l2p), PAD_CODE, np.uint8)
    c1[:, :n1] = rng.integers(0, PAD_CODE + 1, (b, n1))
    c2b[:, :n2] = rng.integers(0, PAD_CODE + 1, (b, n2))
    c1[:, ::31] = HYPHEN_CODE
    c2b[:, ::37] = OTHER_CODE
    c1, c2b = torch.from_numpy(c1), torch.from_numpy(c2b)
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         workers % 2 == 1).code)
    if shared:
        c1 = c1[0].contiguous()
        want = sw.sweep_batched_shared_plain(c1, c2b, code)
    else:
        want = sw.sweep_batched_plain(c1, c2b, code)
    np.testing.assert_array_equal(run_plan(c1, c2b, code, workers), want.numpy())


def test_balance_pm_reads_the_launch_plan(monkeypatch):
    """`models/batch.balance_pm` is 1000 x the mean worker's units over the
    most one worker takes, from the launch's plan (here the CPU model in
    place of the card's), asked for once per shape and device; a batched
    launch on the CPU (the plain sweeps, no plan) leaves `launch` without
    the attribute."""
    import contextlib

    from psa_torch.core.tables import device_tables
    from psa_torch.models import batch
    from psa_torch.utils import spans

    asked = []

    def plan(l2p, noff_pad, b, shared):
        asked.append((l2p, noff_pad, b, shared))
        return dict(sw.batched_split_plan(b, noff_pad, l2p, H100_WORKERS),
                    workers=H100_WORKERS)
    monkeypatch.setattr(batch, "batched_plan", plan)
    monkeypatch.setattr(batch.torch.cuda, "device", lambda d: contextlib.nullcontext())
    batch.balance_pm.cache_clear()
    _, noff_pad, l2p, _ = sw.plan_shapes(*CELL)
    assert batch.balance_pm(l2p, noff_pad, 4, False, "cuda:0") == 1000
    assert batch.balance_pm(l2p, noff_pad, 4, False, "cuda:0") == 1000
    assert batch.balance_pm(512, 1792, 1024, True, "cuda:0") == round(
        1000 * 2048 / (H100_WORKERS * 4))
    assert asked == [(l2p, noff_pad, 4, False), (512, 1792, 1024, True)]
    batch.balance_pm.cache_clear()

    tabs = device_tables(build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False),
                         torch.device("cpu"))
    c1 = torch.full((2, 256 + 64), PAD_CODE, dtype=torch.uint8)
    c2 = torch.full((2, 64), PAD_CODE, dtype=torch.uint8)
    spans.clear()
    batch.run_exact_batch(c1, c2, torch.tensor([1, 1]), tabs)
    launch = [r for r in spans.records() if r.name == "launch"]
    assert len(launch) == 1 and launch[0].attrs == {"rows": 2, "shared": 0}
