"""The program's span recorder (`psa_torch.utils.spans`) on the CPU: nesting,
times, request ids, a parent passed across threads, the ring's bound,
the off switch, the "psa.<name>" annotations in a profile, and the spans
the single-query, batch and set-up paths record."""

import collections
import functools
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from psa_torch import native
from psa_torch.core.alphabet import encode, encode_batch_checked
from psa_torch.core.tables import build_tables, device_tables
from psa_torch.models import batch
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops import sweep as sw
from psa_torch.ops.sweep import L2_ALIGN, plan_bucket, plan_shapes
from psa_torch.utils import spans
from psa_torch.utils.generator import random_sequences
from psa_torch.utils.io import Query

ROOT = Path(__file__).resolve().parent.parent
W = (1.0, 3.0, 4.0, 2.0)


@pytest.fixture(autouse=True)
def fresh_ring():
    was = spans.enable(True)
    spans.clear()
    yield
    spans.enable(was)
    spans.clear()


def tree(recs) -> list:
    """(name, parent's name or None, attrs) of each record, in close order."""
    names = {s.id: s.name for s in recs}
    return [(s.name, names.get(s.parent), s.attrs) for s in recs]


def test_nesting_parents_and_request_ids():
    with spans.span("a") as a:
        with spans.span("b") as b:
            with spans.span("c") as c:
                pass
        with spans.span("d") as d:
            pass
    with spans.span("e") as e:
        pass
    recs = spans.records()
    assert [s.name for s in recs] == ["c", "b", "d", "a", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.id, b.id, a.id, None)
    assert {s.request for s in (a, b, c, d)} == {a.id}
    assert e.request == e.id != a.id
    assert all(s.start_ns <= s.end_ns for s in recs)
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
    assert b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns


def test_start_and_end_on_the_host_clock(monkeypatch):
    ticks = iter([0, 10, 15, 40, 100, 130, 160, 200])
    monkeypatch.setattr(spans.time, "perf_counter_ns", lambda: next(ticks))
    with spans.span("root") as root:           # 0 .. 200
        with spans.span("one") as one:         # 10 .. 100, holding "deep"
            with spans.span("deep") as deep:   # 15 .. 40
                pass
        with spans.span("two") as two:         # 130 .. 160
            pass
    assert (root.dur_ns, one.dur_ns, deep.dur_ns, two.dur_ns) == (
        200, 90, 25, 30)
    recs = spans.records()
    assert [(s.name, s.start_ns, s.end_ns, s.dur_ns) for s in recs] == [
        ("deep", 15, 40, 25), ("one", 10, 100, 90), ("two", 130, 160, 30),
        ("root", 0, 200, 200)]
    assert [(s.id, s.parent, s.request) for s in recs] == [
        (deep.id, one.id, root.id), (one.id, root.id, root.id),
        (two.id, root.id, root.id), (root.id, None, root.id)]


def test_a_closed_span_leaves_no_object_alive():
    """The ring keeps packed rows, not the spans: once closed and let go, no
    Span object (nor its attributes' dict) stays on the heap."""
    import gc

    for i in range(1000):
        with spans.span("s", rows=i):
            pass
    gc.collect()
    assert not [o for o in gc.get_objects() if type(o) is spans.Span]
    recs = spans.records()
    assert len(recs) == 1000 and recs[-1].attrs == {"rows": 999}


def test_a_snapshot_while_another_thread_closes_spans(monkeypatch):
    """Each record a snapshot returns is whole: a span named for the parity
    of its attribute reads back with that attribute, while another thread
    keeps rewriting the ring's slots, switched every microsecond."""
    n = 63                  # odd: each rewrite of a slot flips the parity
    monkeypatch.setattr(spans, "CAPACITY", n)
    monkeypatch.setattr(spans, "_rows", bytearray(spans._ROW.size * n))
    monkeypatch.setattr(spans, "_names", [None] * n)
    monkeypatch.setattr(spans, "_keys", [None] * n)
    stop, interval = threading.Event(), sys.getswitchinterval()
    written = [0]

    def write():
        while not stop.is_set():
            k = written[0]
            with spans.span(("even", "odd")[k % 2], k=k):
                pass
            written[0] = k + 1

    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=write)
    try:
        t.start()
        snapshots = seen = 0
        deadline = time.monotonic() + 60
        while (written[0] < 20_000 or snapshots < 300) and \
                time.monotonic() < deadline:
            for r in spans.records():
                assert r.name == ("even", "odd")[r.attrs["k"] % 2]
                assert r.request == r.id and r.start_ns <= r.end_ns
                seen += 1
            snapshots += 1
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert written[0] >= 20_000 and seen > 0


def test_attributes_at_open_and_before_close():
    with spans.span("upload", bytes=12) as sp:
        sp.set(rows=3)
        sp.set(bytes=16)
    assert spans.records()[-1].attrs == {"bytes": 16, "rows": 3}


def test_a_parent_passed_to_another_thread():
    with spans.span("search_batch") as root:
        pass
    done = []

    def finish():
        with spans.within(root):
            with spans.span("fetch_wait") as fw:
                with spans.span("rescore") as rs:
                    pass
        with spans.span("alone") as alone:
            pass
        done.append((fw, rs, alone))

    t = threading.Thread(target=finish)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and done
    fw, rs, alone = done[0]
    assert (fw.parent, fw.request) == (root.id, root.id)
    assert (rs.parent, rs.request) == (fw.id, root.id)
    assert alone.parent is None and alone.request == alone.id


def test_the_ring_keeps_the_last_capacity_spans():
    assert spans.CAPACITY == 65_536
    for i in range(spans.CAPACITY + 10):
        with spans.span("s", i=i):
            pass
    recs = spans.records()
    assert len(recs) == spans.CAPACITY
    assert recs[0].attrs["i"] == 10 and recs[-1].attrs["i"] == spans.CAPACITY + 9
    snap = spans.records()
    with spans.span("later"):
        pass
    assert len(snap) == spans.CAPACITY and snap[-1].name == "s"
    spans.clear()
    assert spans.records() == []


def test_off_is_a_shared_no_op():
    assert spans.enable(False) is True
    a, b = spans.span("x", bytes=1), spans.span("y")
    assert a is b
    with a as sp:
        sp.set(rows=1)
        with spans.within(sp):
            with spans.span("z"):
                pass
    assert spans.records() == []
    assert spans.enable(True) is False
    with spans.span("on"):
        pass
    assert [s.name for s in spans.records()] == ["on"]


def test_recording_follows_enable():
    assert spans.recording() is True
    was = spans.enable(False)
    try:
        assert spans.recording() is False
    finally:
        spans.enable(was)
    assert spans.recording() is True


@pytest.mark.parametrize("counts,want", [((5, 5), 1000), ((7, 4), 1750),
                                         ((3, 2), 1500), ((0, 0), None)])
def test_rank_passes_pm_from_fetched_counters(counts, want):
    """[threshold passes, steps] as a launch leaves them: 1000 x passes a
    step on the `fetch_wait` span, nothing before any step."""
    assert sw.rank_passes_pm(counts) == want
    spans.clear()
    with spans.span("fetch_wait") as sp:
        batch.set_rank_passes(sp, torch.tensor(counts, dtype=torch.int64))
    assert spans.records()[-1].attrs == ({} if want is None
                                         else {"rank_passes_pm": want})


def test_no_rank_counters_off_the_card():
    assert sw.rank_counters("cpu") is None
    assert batch.recorded_counters(torch.device("cpu")) is None
    assert batch.fetch_counters(None) is None
    with spans.span("fetch_wait") as sp:
        batch.set_rank_passes(sp, None)
    assert spans.records()[-1].attrs == {}


def test_annotations_only_inside_a_profile(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("search"):
            with spans.span("encode"):
                torch.ones(4).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in events]
    assert "psa.search" in names and "psa.encode" in names
    outer = next(e for e in events if e["name"] == "psa.search")
    inner = next(e for e in events if e["name"] == "psa.encode")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    def refuse(*a, **k):
        raise AssertionError("record_function opened outside a profile")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span("search"):
        pass
    assert spans.records()[-1].name == "search"


def test_the_recorder_imports_no_torch():
    """The module alone (not through the package, which loads torch)."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('s', sys.argv[1])\n"
            "s = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(s)\n"
            "with s.span('a'):\n    pass\n"
            "print(len(s.records()), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, spans.__file__],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "False"]


def test_the_single_query_tree():
    s1, s2 = random_sequences(3000, 400, seed=11)
    eng = AlignmentSearchEngine(W, False, device="cpu")
    want = eng.search(s1, s2)            # the tables and libraries load here
    spans.clear()
    assert eng.search(s1, s2) == want
    recs = spans.records()
    noff, _, l2p, l1k = plan_shapes(3000, 400)
    assert [(n, p) for n, p, _ in tree(recs)] == [
        ("encode", "search"), ("validate", "search"), ("upload", "search"),
        ("launch", "search"), ("fetch_wait", "search"),
        ("rescore", "host_select"), ("host_select", "search"),
        ("search", None)]
    by = {s.name: s for s in recs}
    assert by["encode"].attrs == {"checked": 1}
    assert by["upload"].attrs == {"bytes": l1k + l2p}
    assert by["rescore"].attrs["candidates"] >= 1
    assert len({s.request for s in recs}) == 1
    root = by["search"]
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for s in recs)
    # without the alphabet check there is no validate span
    spans.clear()
    AlignmentSearchEngine(W, False, strict_alphabet=False,
                          device="cpu").search(s1, s2)
    assert "validate" not in [s.name for s in spans.records()]


def queries(n, n1=2500, n2=300):
    return [Query(np.array(W), *random_sequences(n1, n2, seed=40 + i), False)
            for i in range(n)]


def test_the_batch_tree():
    qs = queries(3)
    want = batch.search_batch(qs, device="cpu")
    spans.clear()
    assert batch.search_batch(qs, device="cpu") == want
    recs = spans.records()
    l2p = -(-300 // L2_ALIGN) * L2_ALIGN
    _, l1k = plan_bucket(np.full(3, 2500 - 300 + 1), l2p)
    assert tree(recs) == [
        ("encode", "search_batch", {"rows": 3, "checked": 1}),
        ("validate", "search_batch", {}),
        ("upload", "search_batch", {"bytes": 3 * l1k}),
        ("upload", "search_batch", {"bytes": 3 * l2p}),
        ("upload", "search_batch", {"bytes": 3 * 4}),
        ("launch", "search_batch", {"rows": 3, "shared": 0}),
        ("fetch_wait", "search_batch", {}),
        ("rescore", "host_select", {"candidates": recs[7].attrs["candidates"]}),
        ("host_select", "search_batch", {}),
        ("search_batch", None, {"queries": 3})]
    assert recs[7].attrs["candidates"] >= 3
    root = recs[-1]
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for s in recs)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("path", ["search", "search_batch"])
def test_one_checked_encode_a_request(path, strict):
    """Each string is encoded once a request, in one `encode` span marked
    `checked` when the strict check reads its flags, then one `validate`
    span; a lenient request records no `validate`."""
    qs = queries(2)
    if path == "search":
        eng = AlignmentSearchEngine(W, False, strict_alphabet=strict,
                                    device="cpu")
        run = functools.partial(eng.search, qs[0].seq1, qs[0].seq2)
    else:
        run = functools.partial(batch.search_batch, qs,
                                strict_alphabet=strict, device="cpu")
    want = run()
    spans.clear()
    before = native.calls["encode_checked"]
    for _ in range(3):
        assert run() == want
    recs = spans.records()
    roots = [s for s in recs if s.name == path]
    assert len(roots) == 3
    for root in roots:
        mine = [s for s in recs if s.request == root.id]
        enc = [s for s in mine if s.name == "encode"]
        val = [s for s in mine if s.name == "validate"]
        assert len(enc) == 1 and enc[0].attrs["checked"] == int(strict)
        assert len(val) == int(strict)
        assert all(enc[0].end_ns <= s.start_ns for s in val)
    # one native pass a string (search) or a bucket's Seq1s and Seq2s
    assert native.calls["encode_checked"] == before + 3 * 2


def test_the_async_batch_finishes_under_its_root_on_another_thread():
    qs = queries(2)
    want = batch.search_batch(qs, device="cpu")
    spans.clear()
    handles, finish = batch.search_batch_async(qs, device="cpu")
    out = []
    t = threading.Thread(target=lambda: out.append(finish()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and out == [want]
    recs = spans.records()
    root = next(s for s in recs if s.name == "search_batch")
    assert [s.name for s in recs if s.end_ns <= root.end_ns] == [
        "encode", "validate", "upload", "upload", "upload", "launch",
        "search_batch"]
    later = [s for s in recs if s.start_ns >= root.end_ns]
    assert [(n, p) for n, p, _ in tree(later)] == [
        ("fetch_wait", None), ("rescore", "host_select"),
        ("host_select", None)]
    assert {s.request for s in recs} == {root.id}
    assert [s.parent for s in later] == [root.id, later[2].id, root.id]


def test_near_fallback_through_a_small_k():
    """A Seq1 of three copies of one block ties at three offsets, inside the
    default k; with k = 1 the f32 band holds more than k offsets and host
    selection re-reads the full stats."""
    tables = build_tables(np.array(W), False)
    dtabs = device_tables(tables, "cpu")
    rows = []
    for seed in (1, 2):
        block, _ = random_sequences(400, 10, seed=seed)
        rows.append((block * 3, block[50 + seed: 170 + seed]))
    c1, c2 = encode(rows[0][0]), encode(rows[0][1])
    want = batch.search_exact(c1, c2, dtabs)
    assert "near_fallback" not in [s.name for s in spans.records()]
    spans.clear()
    assert batch.search_exact(c1, c2, dtabs, k=1) == want
    recs = spans.records()
    names = {s.id: s.name for s in recs}
    fb = [s for s in recs if s.name == "near_fallback"]
    assert len(fb) == 1 and names[fb[0].parent] == "host_select"
    # the batch path re-sweeps each such row on its own, one span a row
    l2p = 128
    noffs = np.array([len(a) - len(b) + 1 for a, b in rows], np.int32)
    _, l1k = plan_bucket(noffs, l2p)
    c1b, _ = encode_batch_checked([a for a, _ in rows], l1k)
    c2b, _ = encode_batch_checked([b for _, b in rows], l2p)
    n2s = np.array([len(b) for _, b in rows], np.int32)
    spans.clear()
    want = batch.batched_search_exact(c1b, c2b, noffs, n2s, dtabs)
    assert "near_fallback" not in [s.name for s in spans.records()]
    spans.clear()
    got = batch.batched_search_exact(c1b, c2b, noffs, n2s, dtabs, k=1)
    assert got == want
    recs = spans.records()
    names = {s.id: s.name for s in recs}
    fb = [s for s in recs if s.name == "near_fallback"]
    assert len(fb) == 2 and {names[s.parent] for s in fb} == {"host_select"}
    ups = [s for s in recs if s.name == "upload" and names.get(s.parent)
           == "near_fallback"]
    assert len(ups) == 2


def test_build_library_marks_a_build(monkeypatch, tmp_path):
    """A fake nvcc that writes its -o file and a fake loader: the first
    call builds (built = 1), the next finds the file (built = 0), and a
    loaded library opens no span."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = -o ]; then : > "$2"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    consts = {"psa_sweep_tile": sw.TILE_O, "psa_sweep_warp_tile": sw.WARP_TILE,
              "psa_sweep_align": sw.L2_ALIGN,
              "psa_sweep_seg": sw.SEG, "psa_sweep_mma_tile": sw.MMA_TILE,
              "psa_sweep_mma_chunk": sw.MMA_CHUNK}

    class Fn:
        def __init__(self, value):
            self.value = value

        def __call__(self, *args):
            return self.value

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = Fn(consts.get(name, 0))
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(sw.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(sw.ctypes, "CDLL", Lib)
    monkeypatch.setattr(sw, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sw, "_lib", None)
    first = sw.build_library()
    monkeypatch.setattr(sw, "_lib", None)
    second = sw.build_library()
    assert sw.build_library() is second
    assert first.path == second.path
    recs = [s for s in spans.records() if s.name == "build_library"]
    assert [s.attrs for s in recs] == [{"built": 1}, {"built": 0}]


def test_native_load_and_device_tables_spans(monkeypatch):
    assert native.available()
    spans.clear()                        # the first load, if it was this one
    monkeypatch.setattr(native, "_lib", None)
    native.get_lib()
    native.get_lib()                     # loaded: no second span
    device_tables(build_tables(np.array(W), True), "cpu")
    recs = spans.records()
    assert [(s.name, s.attrs) for s in recs] == [
        ("native_load", {"built": 0}), ("device_tables", {})]
    assert all(s.parent is None for s in recs)


def test_counts_read_from_the_spans():
    """Uploaded bytes and re-scored candidates add up from the spans; the
    launch counters keep counting beside them."""
    qs = queries(2) + queries(1, 4000, 500)
    batch.search_batch(qs, device="cpu")
    spans.clear()
    before = sw.launches_batched
    batch.search_batch(qs, device="cpu")
    recs = spans.records()
    c = collections.Counter(s.name for s in recs)
    # both buckets are encoded in one pass before either is dispatched
    assert c["encode"] == 1 and c["launch"] == 2 and c["upload"] == 6
    assert sum(s.attrs["rows"] for s in recs if s.name == "launch") == 3
    assert sum(s.attrs["candidates"] for s in recs
               if s.name == "rescore") >= 3
    assert sw.launches_batched == before      # the CPU runs no kernel
