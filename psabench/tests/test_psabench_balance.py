"""`batched_balance_pct` on synthetic runs: the mean of the `launch` spans'
`balance_pm` over the requests the profiler did not record, read as a
percentage, and nothing where no launch carries the attribute (a program
that lacks it, or a CPU run, whose plain sweeps have no plan)."""

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


def window(balances, profiled):
    """One request a balance (None: a launch without the attribute), 100 ms
    apart from 1 s, each a `search_batch` root over one `launch`."""
    reqs, recs = [], [rec("build_library", 0.5e9, 0.6e9, built=0)]
    for i, (pm, prof) in enumerate(zip(balances, profiled)):
        t0 = int((1.0 + 0.1 * i) * 1e9)
        reqs.append(Request(0, t0 * 1e-9, t0 * 1e-9 + 0.09, [None], "", prof))
        root = rec("search_batch", t0 + MS, t0 + 80 * MS, queries=4)
        attrs = {"rows": 4, "shared": 0}
        if pm is not None:
            attrs["balance_pm"] = pm
        recs += [rec("launch", t0 + 2 * MS, t0 + 3 * MS, root, **attrs), root]
    ctx = run.Context({"name": "batch.long_rows"}, {}, {}, 9.0, reqs, 0.5,
                      4, 1, 0.0, trace=None,
                      traced_requests=sum(profiled))
    return ctx, recs


def read(ctx):
    return next(m for m in registry.metrics()
                if registry.metric_name(m) == "batched_balance_pct").read(ctx)


@pytest.mark.parametrize("balances,profiled,want", [
    ((1000, 1000, 1000), (False, False, False), 100.0),
    ((740, 1000, 1000), (False, False, True), 87.0),    # the profiled one left out
    ((999, 740, 500), (False, False, False), 74.633333),
    ((None, None, None), (False, False, False), None),  # a program without it
    ((1000, 1000, 1000), (True, True, True), None),     # every request profiled
])
def test_the_mean_balance_of_the_unprofiled_launches(monkeypatch, balances,
                                                     profiled, want):
    from psabench import program_spans

    ctx, recs = window(balances, profiled)
    monkeypatch.setattr(program_spans, "records", lambda: list(recs))
    got = read(ctx)
    assert got == (None if want is None else pytest.approx(want))
