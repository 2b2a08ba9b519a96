"""The program's spans read by the harness (program_spans.py and the metrics
that use it): the join of root spans to requests, the means over the
requests the profiler did not record, the set-up union, the clock offset
to the profiler's trace and the idle time laid on it, on synthetic runs;
and on a traced CPU run of each cell."""

import itertools
import sys
import time

import pytest
import torch

from psabench import program_spans, registry, run
from psabench.trace import Event, Trace
from psabench.traffic.closed_loop import Request
from psa_torch.utils import spans

OFF = 5e9            # trace microseconds less host microseconds
MS = 1_000_000       # nanoseconds a millisecond

NEW = ("validate_ms", "encode_ms", "upload_host_ms", "fetch_wait_ms",
       "rescore_ms", "near_fallbacks_per_kq", "library_setup_s",
       "front_idle_pct")


IDS = itertools.count(1)


def rec(name, start_ns, end_ns, parent=None, **attrs):
    sid = next(IDS)
    up, request = (None, sid) if parent is None else (parent.id,
                                                      parent.request)
    return spans.Record(name, sid, up, request, int(start_ns), int(end_ns),
                        attrs)


def request_spans(t0_ns, fallback=False) -> list:
    """One request's spans in close order, t0_ns its start (ms offsets as
    in the idle table below)."""
    at = lambda a, b: (t0_ns + a * MS, t0_ns + b * MS)   # noqa: E731
    root = rec("search", *at(1, 99))
    hs = rec("host_select", *at(92, 97), root)
    out = [rec("validate", *at(2, 12), root), rec("encode", *at(12, 22), root),
           rec("upload", *at(22, 23), root, bytes=850_000),
           rec("fetch_wait", *at(24, 91), root),
           rec("rescore", *at(93, 95), hs, candidates=2)]
    if fallback:
        out.append(rec("near_fallback", *at(95, 96), hs))
    return out + [hs, root]


def synthetic(trace_events=True, profiled=(False, True, True)):
    """Three requests of 100 ms at 1.0, 1.2 and 1.4 s; the last two
    profiled, each with a 60 ms kernel at 30-90 ms; set-up spans before."""
    t0s = [1.0, 1.2, 1.4]
    reqs = [Request(0, t, t + 0.1, [None], "", p) for t, p in zip(t0s, profiled)]
    recs = [rec("device_tables", 0.55e9, 0.58e9),
            rec("build_library", 0.5e9, 0.6e9, built=1),
            rec("native_load", 0.7e9, 0.75e9)]
    for i, t in enumerate(t0s):
        recs += request_spans(int(t * 1e9), fallback=i == 0)
    tr = None
    if trace_events:
        device, marks = [], []
        for r in reqs:
            if r.profiled:
                us = r.t0 * 1e6 + OFF
                marks.append(Event("user_annotation", "request", us, 1e5))
                device.append(Event("kernel", "sweep_kernel", us + 30e3, 60e3))
        tr = Trace(device, marks)
    ctx = run.Context({"name": "single.long_seq2"}, {}, {}, 9.0, reqs, 0.5,
                      1, 1, 0.0, trace=tr,
                      traced_requests=sum(r.profiled for r in reqs))
    return ctx, recs


@pytest.fixture
def fake_records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    return use


def read(name, ctx):
    return next(m for m in registry.metrics()
                if registry.metric_name(m) == name).read(ctx)


def test_roots_join_the_requests_that_hold_them():
    ctx, recs = synthetic()
    got = program_spans.joined(ctx, recs)
    assert [r.t0 for r, _ in got] == [1.0, 1.2, 1.4]
    assert [len(s) for _, s in got] == [8, 7, 7]
    assert all(len({s.request for s in spans_}) == 1 for _, spans_ in got)
    # a root outside every request (set-up's, a warm-up's) joins none
    stray = rec("search", 0.8e9, 0.9e9)
    assert len(program_spans.joined(ctx, recs + [stray])) == 3


def test_requests_older_than_the_ring_are_left_out():
    ctx, recs = synthetic()
    kept = [s for s in recs if s.end_ns > 1.05e9]    # the oldest went
    assert [r.t0 for r, _ in program_spans.joined(ctx, kept)] == [1.2, 1.4]


def test_the_time_metrics_average_the_unprofiled_requests(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    assert read("validate_ms", ctx) == pytest.approx(10.0)
    assert read("encode_ms", ctx) == pytest.approx(10.0)
    assert read("upload_host_ms", ctx) == pytest.approx(1.0)
    assert read("fetch_wait_ms", ctx) == pytest.approx(67.0)
    assert read("rescore_ms", ctx) == pytest.approx(2.0)
    # every profiled: no request to average
    ctx2, recs2 = synthetic(profiled=(True, True, True))
    fake_records(recs2)
    assert read("validate_ms", ctx2) is None


def test_fallbacks_count_every_window_request(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    assert read("near_fallbacks_per_kq", ctx) == pytest.approx(1e3 / 3)
    ctx.queries_per_call = 4
    assert read("near_fallbacks_per_kq", ctx) == pytest.approx(1e3 / 12)
    fake_records([s for s in recs if s.name != "near_fallback"])
    assert read("near_fallbacks_per_kq", ctx) == 0.0


def test_library_setup_is_the_union_before_the_window(fake_records):
    ctx, recs = synthetic()
    late = rec("device_tables", 1.25e9, 1.26e9)      # inside the window
    fake_records(recs + [late])
    # build_library 0.5-0.6 holds device_tables 0.55-0.58; native 0.7-0.75
    assert read("library_setup_s", ctx) == pytest.approx(0.15)
    fake_records([s for s in recs if s.name not in program_spans.SETUP])
    assert read("library_setup_s", ctx) is None


def test_the_clock_offset_and_the_front_idle_share(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    assert program_spans.clock_offset_us(ctx) == pytest.approx(OFF)
    # window 1.2-1.5 s (300 ms); the card is idle in validate and encode,
    # 20 ms a profiled request
    assert read("front_idle_pct", ctx) == pytest.approx(100 * 40 / 300)
    # the offset is the median: one late mark moves it not
    ctx.trace.spans[0] = Event("user_annotation", "request",
                               ctx.trace.spans[0].start_us + 700, 1e5)
    ctx.trace.spans.append(Event("user_annotation", "request",
                                 1.6e6 + OFF, 1e5))
    ctx.requests.append(Request(0, 1.6, 1.7, [None], "", True))
    assert program_spans.clock_offset_us(ctx) == pytest.approx(OFF)


def test_a_count_mismatch_gives_none(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    ctx.trace.spans.append(Event("user_annotation", "request",
                                 1.9e6 + OFF, 1e5))
    assert program_spans.clock_offset_us(ctx) is None
    assert read("front_idle_pct", ctx) is None
    assert program_spans.idle_by_span(ctx) is None


def test_without_a_device_operation_front_idle_reads_nothing(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    ctx.trace.device.clear()
    assert read("front_idle_pct", ctx) is None
    ctx.trace = None
    assert read("front_idle_pct", ctx) is None


def test_idle_time_by_innermost_program_span(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    got = program_spans.idle_by_span(ctx)
    ms = {k: v * 1e3 for k, v in got["idle_s"]}
    want = {program_spans.OUTSIDE: 104, "validate": 20, "encode": 20,
            "fetch_wait": 14, "search": 10, "host_select": 6, "rescore": 4,
            "upload": 2}
    assert ms == pytest.approx(want)
    assert [k for k, _ in got["idle_s"]] == sorted(want, key=lambda k: -want[k])
    assert got["child_share_in_roots"] == pytest.approx(1 - 10 / 76)
    assert program_spans.span_ms(ctx)["search.self"] == pytest.approx(
        98 - 10 - 10 - 1 - 67 - 5)


def test_a_root_s_own_time_leaves_out_only_children_inside_it(fake_records):
    """A child that closed after its root (a batch's finish on another
    thread) counts under its own name, not against the root's own time."""
    ctx, recs = synthetic()
    roots = [s for s in recs if s.name == "search"]
    late = [rec("fetch_wait", r.end_ns + MS, r.end_ns + 3 * MS, r)
            for r in roots]
    fake_records(recs + late)
    got = program_spans.span_ms(ctx)
    assert got["search.self"] == pytest.approx(98 - 10 - 10 - 1 - 67 - 5)
    assert got["fetch_wait"] == pytest.approx(67 + 2)


def test_the_tool_captures_and_puts_back(fake_records):
    """The command's capture keeps the Context that front_idle_pct reads and
    the profile's psa.* annotations, and puts both functions back."""
    from psabench import trace
    from psabench.metrics import front_idle_pct

    ctx, recs = synthetic()
    fake_records(recs)
    idle_in, from_chrome = program_spans.idle_in_pct, trace.Trace.from_chrome
    doc = {"traceEvents": [
        {"cat": "user_annotation", "name": "psa.search", "ts": 1, "dur": 2},
        {"cat": "user_annotation", "name": "psabench.request", "ts": 1,
         "dur": 3}]}
    with program_spans._capture() as seen:
        assert front_idle_pct.read(ctx) == pytest.approx(100 * 40 / 300)
        assert isinstance(trace.Trace.from_chrome(doc), Trace)
    assert seen["ctx"] is ctx
    assert [ev["name"] for ev in seen["psa"]] == ["psa.search"]
    assert program_spans.idle_in_pct is idle_in
    assert trace.Trace.from_chrome == from_chrome
    assert front_idle_pct.read(ctx) == pytest.approx(100 * 40 / 300)


def test_the_annotations_check_the_offset(fake_records):
    ctx, recs = synthetic()
    fake_records(recs)
    roots = [s for s in recs if s.name == "search" and s.start_ns >= 1.2e9]
    events = [{"name": "psa.search", "ts": s.start_ns * 1e-3 + OFF + 2}
              for s in roots]
    got = program_spans.annotation_check_us(ctx, events)
    assert got["n"] == 2
    assert got["median_us"] == pytest.approx(-2) and got["max_abs_us"] == \
        pytest.approx(2)
    assert program_spans.annotation_check_us(ctx, events[:1]) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """A program without psa_torch.utils.spans (as before the recorder
    existed): every new metric is None and nothing raises."""
    import psa_torch.utils

    ctx, _ = synthetic()
    with spans.span("left_by_another_test"):
        pass
    monkeypatch.delattr(psa_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "psa_torch.utils.spans", None)
    assert program_spans.records() == []
    for name in NEW:
        assert read(name, ctx) is None, name


@pytest.mark.parametrize("cell", ["single.long_seq2", "batch.long_rows"])
def test_a_traced_cpu_run_reports_the_program_span_metrics(cell, small_mix):
    res = run.run_cell(registry.cell(cell), 7, 2.5, True, torch.device("cpu"),
                       time.perf_counter(), small_mix, log=lambda line: None)
    assert res["correct"] is True
    want = {"validate_ms", "encode_ms", "upload_host_ms", "rescore_ms",
            "near_fallbacks_per_kq", "library_setup_s"}
    if cell == "batch.long_rows":
        want.add("fetch_wait_ms")
    got = set(res["metrics"]) & set(NEW)
    # the device's share finds no device operation on the CPU
    assert got == want
    assert res["metrics"]["near_fallbacks_per_kq"]["value"] == 0.0
    assert res["metrics"]["near_fallbacks_per_kq"]["unit"] == "fallbacks/kq"
