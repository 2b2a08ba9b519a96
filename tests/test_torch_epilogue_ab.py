"""The epilogue's timing harness (psa_torch.utils.epilogue_ab) on the CPU:
the band-block count it reports against a count by hand, the profile
reader that splits device events by range, its seeded inputs, and its exit
without a card.  The timings themselves need the card."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from psa_torch.core.tables import build_tables, device_tables
from psa_torch.ops import epilogue as ep
from psa_torch.ops import sweep as sw
from psa_torch.ops.common import keyed_f32_totals_ops
from psa_torch.utils import epilogue_ab as ab


@pytest.mark.parametrize("block_cols", [512, 2048])
def test_band_blocks_counts_blocks_in_the_band_below_the_best(block_cols):
    """A block counts when its largest key lies in [best - eps, best) of its
    row: counted by hand over the same keys."""
    rng = np.random.default_rng(block_cols)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    dtabs = device_tables(tables, "cpu")
    np_len, l2p = 5 * block_cols + 7, 300_000          # eps ~ 2.3: bands of integers
    st = np.concatenate([rng.integers(0, 40, (2, 4, np_len)),
                         rng.integers(-1, tables.num_ranks, (2, 1, np_len))],
                        axis=1).astype(np.int32)
    noff = np_len - 3
    got = ab.band_blocks(torch, torch.from_numpy(st), dtabs, noff, l2p, block_cols)
    keyed = keyed_f32_totals_ops(torch.from_numpy(st[:, :4]), torch.from_numpy(st[:, 4]),
                                 dtabs.w32, dtabs.diff32, False, noff)[0].numpy()
    want = 0
    for r in range(2):
        best = keyed[r].max()
        lo = np.float32(best) - np.float32(dtabs.eps(l2p))
        for b0 in range(0, np_len, block_cols):
            m = keyed[r, b0:b0 + block_cols].max()
            want += int(lo <= m < best)
    assert got == want > 0
    assert ab.band_blocks(torch, torch.from_numpy(st), dtabs, noff, l2p, np_len) == 0


def test_device_events_splits_a_profile_by_range():
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("first"):
            x + 1
        with record_function("second"):
            x * 2
            x * 3
    got = ab.device_events(prof, ["first", "second", "none"], cats=("cpu_op",))
    assert got["first"]["cpu_op: aten::add"][0] == 1
    assert got["second"]["cpu_op: aten::mul"][0] == 2
    assert "cpu_op: aten::mul" not in got["first"] and got["none"] == {}


def test_device_events_take_the_nearest_range():
    """A device event whose clock lies a little off the host's still goes
    to its own range: the nearest of two ranges apart by idle."""
    trace = {"traceEvents": [
        {"cat": "user_annotation", "name": "a", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "b", "ts": 1000, "dur": 100},
        {"cat": "kernel", "name": "k", "ts": 95, "dur": 20},      # past a's end
        {"cat": "kernel", "name": "k", "ts": 960, "dur": 20},     # before b's start
        {"cat": "kernel", "name": "k", "ts": 1040, "dur": 10},
        {"cat": "cpu_op", "name": "k", "ts": 50, "dur": 1}]}

    class Prof:
        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps(trace))

    got = ab.device_events(Prof(), ["a", "b"])
    assert got == {"a": {"kernel: k": [1, 20.0]}, "b": {"kernel: k": [2, 30.0]}}


def test_case_stats_are_seeded_and_shaped():
    """Each case's stats5 from the sweeps' plain versions on the CPU, at a
    small stand-in for the case's shape: the same arrays on a second call,
    and noff and the padding the sweeps give."""
    tables = build_tables(np.array(ab.WEIGHTS), False)
    code = device_tables(tables, "cpu").code
    cases = dict(ab.CASES)
    try:
        ab.CASES.update(north_star=(1, 3000, 300, 0), batch=(3, 2048, 512, 99),
                        all_A=(1, 2000, 100, None))
        for case in ("north_star", "batch", "all_A"):
            st, noff, l2p = ab.case_stats(torch, sw, code, case, torch.device("cpu"))
            again, _, _ = ab.case_stats(torch, sw, code, case, torch.device("cpu"))
            rows, n1, n2, _ = ab.CASES[case]
            assert torch.equal(st, again) and st.dtype == torch.int32
            assert st.shape[:2] == (rows, 5) and st.shape[2] % sw.TILE_O == 0
            assert l2p == sw.plan_shapes(n1, n2)[2]
            want = n1 - n2 + 1
            assert (noff.tolist() == [want] * rows) if rows > 1 else noff == want
        packed = ep.epilogue_pack(st, device_tables(tables, "cpu"), noff, l2p)
        assert int(packed[0, 6 * ep.TOPK]) == noff       # all-'A': every offset ties
    finally:
        ab.CASES.clear()
        ab.CASES.update(cases)


def test_phase_summary_reads_the_marks():
    """Per-block phase cycles (median, most) and the timeline from the first
    entry, with the row's last block found by its marks 5-7."""
    ns = np.zeros((16, 8), np.uint64)
    clk = np.zeros((16, 8), np.int64)
    for b in range(3):
        ns[b, :5] = 1000 + 100 * b + np.arange(5) * 10
        clk[b, :5] = np.array([0, 50, 150, 160, 400]) * (b + 1)
    ns[2, 5:] = [1300, 1400, 1500]
    clk[2, 5:] = [2000, 3000, 3100]
    got = ab.phase_summary(ns, clk, multi=True)
    assert got["blocks"] == 3 and got["keys_cycles"] == [100, 150]
    assert got["publish_and_ticket_cycles"] == [480, 720]
    assert got["last_best_and_near_cycles"] == 2000 - 1200
    assert got["last_candidates_top_cycles"] == 1000 and got["last_pack_cycles"] == 100
    assert got["entry_spread_ns"] == 200 and got["end_ns"] == 500
    assert got["all_ticketed_ns"] == 240 and got["last_block_entry_ns"] == 200
    one = ab.phase_summary(ns[:2].copy(), clk[:2].copy(), multi=False)
    assert one["blocks"] == 2 and "pack_cycles" in one and "error" not in one


def test_main_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab.main(["."]) == 2
    assert ab.main([]) == 2
    assert "epilogue_ab" in capsys.readouterr().err


def test_paths_rehearse_on_the_cpu():
    """`run_paths` on the CPU at small shapes: every phase timed, the
    meshes and the batch dispatches run, their winners checked inside."""
    got = ab.run_paths(".", device="cpu", north_star=(3000, 300), query=(300, 60))
    assert got["device"] == "cpu"
    assert set(got["north_star_split_ms"]) == {"upload", "sweep", "epilogue", "fetch",
                                               "host_select"}
    assert set(got["sharded_ms"]) == {"1", "4", "8", "2x2"}
    assert all(v > 0 for v in got["sharded_ms"].values())
    assert got["north_star_engine_ms"] > 0
    assert set(got["chunk_8_ms"]) == set(got["chunk_256_ms"]) == {"dispatch", "finish"}
