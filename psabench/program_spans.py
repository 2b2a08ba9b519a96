"""The program's own spans (`psa_torch.utils.spans`), read after a run's
window and joined to its requests.

The program records a span at each of its layer boundaries, on the host
clock the harness times its requests on (`time.perf_counter`).  A root span
(`search`, `search_batch`) is joined to the request whose [t0, t1] holds
it, and every span of that root's request id goes with it.  A program
without the recorder gives no records, and every reader here gives None.

For the profiled requests the spans are also laid on the profiler's
timeline: the offset between the two clocks is the median, over those
requests, of the harness's `request` event start in the trace less the
request's t0.  With it the device's idle time can be split by the program
step the host was in.

    python -m psabench.program_spans --workload <cell> --seed <n> --seconds <s>

runs one traced run of a cell on the card and prints its result line, then
one JSON line: the device's idle time by innermost program span, the share
of the idle time inside root spans that falls in a child span, each span's
mean host milliseconds a request, and the offset checked against the
program's own "psa.<name>" annotations in the same profile.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import statistics
import sys

from psabench.trace import union

FRONT = ("validate", "encode")
SETUP = ("build_library", "native_load", "device_tables")
OUTSIDE = "outside program spans"


def records() -> list:
    """The program's closed spans, oldest first; [] when the program has no
    recorder."""
    try:
        from psa_torch.utils import spans
    except ImportError:
        return []
    return spans.records()


def joined(ctx, recs: list | None = None) -> list:
    """[(request, [span records])] for the window's requests that a root
    span was joined to and whose spans the ring still holds whole (it keeps
    every span that closed after its oldest one)."""
    recs = records() if recs is None else recs
    reqs = ctx.requests
    if not recs or not reqs:
        return []
    oldest_s = recs[0].end_ns * 1e-9
    starts = [r.t0 for r in reqs]
    by_request: dict = {}
    for s in recs:
        by_request.setdefault(s.request, []).append(s)
    out: dict = {}
    for s in recs:
        if s.parent is not None:
            continue
        i = bisect.bisect_right(starts, s.start_ns * 1e-9) - 1
        if (i >= 0 and s.end_ns * 1e-9 <= reqs[i].t1
                and reqs[i].t0 >= oldest_s):
            out.setdefault(i, []).extend(by_request[s.request])
    return [(reqs[i], out[i]) for i in sorted(out)]


def mean_ms(ctx, name: str) -> float | None:
    """Host milliseconds in spans named `name`, a request, averaged over the
    requests the profiler did not record."""
    rows = [spans for r, spans in joined(ctx) if not r.profiled]
    if not rows:
        return None
    ns = sum(s.dur_ns for spans in rows for s in spans if s.name == name)
    return ns * 1e-6 / len(rows)


def per_kq(ctx, name: str) -> float | None:
    """Spans named `name` per 1,000 queries, over every window request."""
    rows = joined(ctx)
    if not rows:
        return None
    n = sum(s.name == name for _, spans in rows for s in spans)
    return 1e3 * n / (len(rows) * ctx.queries_per_call)


def setup_s(ctx) -> float | None:
    """Seconds of set-up spent in the SETUP spans (the union of their
    intervals) that closed before the window's first request."""
    if not ctx.requests:
        return None
    first = ctx.requests[0].t0
    iv = [(s.start_ns, s.end_ns) for s in records()
          if s.name in SETUP and s.end_ns * 1e-9 <= first]
    if not iv:
        return None
    return sum(e - s for s, e in union(iv)) * 1e-9


def clock_offset_us(ctx) -> float | None:
    """Trace microseconds less host-clock microseconds: the median over the
    profiled requests of the trace's `request` event start less the
    request's t0; None unless the two lists have the same length."""
    if ctx.trace is None:
        return None
    prof = [r for r in ctx.requests if r.profiled]
    events = ctx.trace.requests()
    if not prof or len(prof) != len(events):
        return None
    return statistics.median(e.start_us - r.t0 * 1e6
                             for e, r in zip(events, prof))


def on_trace(ctx):
    """(window, idle intervals, [(start_us, end_us, span)] of the profiled
    requests' spans) on the trace's clock, or None without a device
    operation in the window, without the clock offset or without spans."""
    offset = clock_offset_us(ctx)
    w = ctx.trace.window_us() if offset is not None else None
    if w is None or w[1] <= w[0]:
        return None
    busy = union((max(e.start_us, w[0]), min(e.end_us, w[1]))
                 for e in ctx.trace.in_window())
    if not busy:
        return None
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    laid = [(s.start_ns * 1e-3 + offset, s.end_ns * 1e-3 + offset, s)
            for r, spans in joined(ctx) if r.profiled for s in spans]
    return (w, idle, laid) if laid else None


def overlap_us(a: list, b: list) -> float:
    """Microseconds shared by two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(ctx) -> float | None:
    """The share of the profiled window in which the device is idle while
    the host is inside a FRONT span."""
    laid = on_trace(ctx)
    if laid is None:
        return None
    w, idle, spans = laid
    inside = union((s, e) for s, e, sp in spans if sp.name in FRONT)
    return 100.0 * overlap_us(idle, inside) / (w[1] - w[0])


def idle_by_span(ctx) -> dict | None:
    """The device's idle time in the profiled window, summed by the
    innermost program span the host was in (OUTSIDE where none), in
    seconds, and the share of the idle time inside root spans that falls
    in one of their child spans."""
    laid = on_trace(ctx)
    if laid is None:
        return None
    _, idle, spans = laid
    spans.sort(key=lambda t: t[0])
    starts = [t[0] for t in spans]
    by: dict = {}
    in_roots = in_root_self = 0.0
    for a, b in idle:
        # the spans that meet [a, b]: they start before b and end after a
        meet = [t for t in spans[:bisect.bisect_left(starts, b)] if t[1] > a]
        cuts = sorted({a, b} | {x for s, e, _ in meet for x in (s, e)
                                if a < x < b})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            holding = [t for t in meet if t[0] <= mid < t[1]]
            inner = min(holding, key=lambda t: t[1] - t[0])[2] if holding \
                else None
            name = inner.name if inner is not None else OUTSIDE
            by[name] = by.get(name, 0.0) + (hi - lo) * 1e-6
            if inner is not None:
                in_roots += hi - lo
                if inner.parent is None:
                    in_root_self += hi - lo
    return {"idle_s": sorted(([k, v] for k, v in by.items()),
                             key=lambda kv: -kv[1]),
            "child_share_in_roots": (1.0 - in_root_self / in_roots
                                     if in_roots else None)}


def span_ms(ctx) -> dict:
    """Each span name's mean host milliseconds a request, and the root
    spans' own time ("<root>.self": less the children that closed inside
    them), over the requests the profiler did not record."""
    rows = [spans for r, spans in joined(ctx) if not r.profiled]
    out: dict = {}
    for spans in rows:
        roots = {s.id: s for s in spans if s.parent is None}
        for s in spans:
            ms = s.dur_ns * 1e-6
            out[s.name] = out.get(s.name, 0.0) + ms
            if s.id in roots:
                own = s.name + ".self"
                out[own] = out.get(own, 0.0) + ms
            up = roots.get(s.parent)
            if up is not None and s.end_ns <= up.end_ns:
                own = up.name + ".self"
                out[own] = out.get(own, 0.0) - ms
    return {k: v / len(rows) for k, v in sorted(out.items())} if rows else {}


def annotation_check_us(ctx, events: list) -> dict | None:
    """The clock offset checked against the program's own "psa.<root>"
    annotations in the same profile (Chrome trace events): each root span's
    start laid on the trace with the offset, less its annotation's start,
    in microseconds (median and largest magnitude)."""
    laid = on_trace(ctx)
    if laid is None:
        return None
    roots = sorted((s for s, _, sp in laid[2] if sp.parent is None))
    ann = sorted(float(ev["ts"]) for ev in events
                 if ev.get("name") in ("psa.search", "psa.search_batch"))
    if not roots or len(roots) != len(ann):
        return None
    diffs = [r - a for r, a in zip(roots, ann)]
    return {"n": len(diffs), "median_us": statistics.median(diffs),
            "max_abs_us": max(abs(d) for d in diffs)}


@contextlib.contextmanager
def _capture():
    """For this module's command only, not for a metric: while open, keep
    the traced run's Context (through `idle_in_pct`, which front_idle_pct
    reads) and the profile's "psa.*" annotations (through the harness's
    `Trace.from_chrome`, the one place the whole profile passes), in the
    dict it yields.  Both are put back on leaving."""
    from psabench import program_spans as here, trace   # not __main__

    seen: dict = {}
    idle_in, from_chrome = here.idle_in_pct, trace.Trace.from_chrome.__func__

    def keep_ctx(ctx):
        seen["ctx"] = ctx
        return idle_in(ctx)

    def keep_doc(cls, doc):
        seen["psa"] = [ev for ev in doc.get("traceEvents", [])
                       if ev.get("cat") == "user_annotation"
                       and str(ev.get("name", "")).startswith("psa.")]
        return from_chrome(cls, doc)

    here.idle_in_pct = keep_ctx
    trace.Trace.from_chrome = classmethod(keep_doc)
    try:
        yield seen
    finally:
        here.idle_in_pct = idle_in
        trace.Trace.from_chrome = classmethod(from_chrome)


def main(argv=None) -> int:
    import argparse

    import torch

    from psabench import registry, run

    p = argparse.ArgumentParser(prog="python -m psabench.program_spans",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("psabench.program_spans: no CUDA device. No result.",
              file=sys.stderr)
        return 2

    with _capture() as seen:
        result = run.run_cell(registry.cell(args.workload), args.seed,
                              args.seconds, True, torch.device("cuda", 0),
                              run._T0)
    ctx = seen.get("ctx")
    print(json.dumps(result), flush=True)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "clock_offset_us": clock_offset_us(ctx) if ctx else None,
        "idle_by_span": idle_by_span(ctx) if ctx else None,
        "span_ms": span_ms(ctx) if ctx else None,
        "annotation_check": (annotation_check_us(ctx, seen.get("psa", []))
                             if ctx else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
