"""`sweep_rank_passes` on synthetic runs: the mean of the `fetch_wait`
spans' `rank_passes_pm` in the window, outside the stretch the profiler
recorded and after the oldest span the ring holds, and nothing where no
fetch carries the attribute (a program that lacks it, or a CPU run)."""

import itertools

import pytest

from psabench import registry, run
from psabench.traffic.closed_loop import Request
from psa_torch.utils import spans

MS = 1_000_000
IDS = itertools.count(1)


def rec(name, start_ns, end_ns, parent=None, **attrs):
    sid = next(IDS)
    up, request = (None, sid) if parent is None else (parent.id, parent.request)
    return spans.Record(name, sid, up, request, int(start_ns), int(end_ns), attrs)


def window(passes, profiled, before=None):
    """One request a reading (None: a fetch without the attribute), 100 ms
    apart from 1 s, each a `search` root over one `fetch_wait`; `before`,
    a reading on a fetch that closed before the first request."""
    reqs, recs = [], [rec("build_library", 0.5e9, 0.6e9, built=0)]
    if before is not None:
        recs.append(rec("fetch_wait", 0.7e9, 0.8e9, rank_passes_pm=before))
    for i, (pm, prof) in enumerate(zip(passes, profiled)):
        t0 = int((1.0 + 0.1 * i) * 1e9)
        reqs.append(Request(0, t0 * 1e-9, t0 * 1e-9 + 0.09, [None], "", prof))
        root = rec("search", t0 + MS, t0 + 80 * MS)
        attrs = {} if pm is None else {"rank_passes_pm": pm}
        recs += [rec("fetch_wait", t0 + 60 * MS, t0 + 70 * MS, root, **attrs), root]
    ctx = run.Context({"name": "single.long_seq2"}, {}, {}, 9.0, reqs, 0.5,
                      4, 1, 0.0, trace=None, traced_requests=sum(profiled))
    return ctx, recs


def read(ctx):
    return next(m for m in registry.metrics()
                if registry.metric_name(m) == "sweep_rank_passes").read(ctx)


@pytest.mark.parametrize("passes,profiled,before,want", [
    ((1000, 1000, 1000), (False, False, False), None, 1000.0),
    ((1000, 3000, None), (False, False, False), None, 2000.0),
    ((1000, 5000, 1000), (False, True, False), None, 1000.0),  # profiled left out
    ((1000, 1000), (False, False), 9000, 1000.0),              # before the window
    ((None, None, None), (False, False, False), None, None),   # a program without it
    ((1000, 1000), (True, True), None, None),                  # every request profiled
])
def test_the_mean_passes_of_the_unprofiled_fetches(monkeypatch, passes, profiled,
                                                   before, want):
    from psabench import program_spans

    ctx, recs = window(passes, profiled, before)
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    got = read(ctx)
    assert got == (None if want is None else pytest.approx(want))
