"""The serve loop's own spans (`psa_torch.utils.server`), read after a
run's window: `serve_read` (a readable event drained), `serve_chunk` (a
dispatch: its `queries`, `lines` and `queue_us`), `parse`, `reply` and
`route`.

A chunk carries the lines of several clients, so no span belongs to one
request: the readers take every serve span that lies inside the window
(the first request's send to the last one's return), after the oldest
span the ring still holds, and outside the stretch the profiler recorded
(the first profiled request's send to the last one's return), and divide
by the queries, lines or chunks of the `serve_chunk` spans among them.  A
program without these spans gives no `serve_chunk`, and every reader here
gives None.
"""

from __future__ import annotations

from psabench import program_spans

NAMES = ("serve_read", "serve_chunk", "parse", "reply", "route")


def window(ctx) -> list | None:
    """The serve spans of the window outside the profile; None without a
    `serve_chunk` with queries among them."""
    every = program_spans.records()
    recs = [s for s in every if s.name in NAMES]
    if not recs or not ctx.requests:
        return None
    lo = max(min(r.t0 for r in ctx.requests) * 1e9, every[0].end_ns)
    hi = max(r.t1 for r in ctx.requests) * 1e9
    prof = [r for r in ctx.requests if r.profiled]
    p0 = min(r.t0 for r in prof) * 1e9 if prof else None
    p1 = max(r.t1 for r in prof) * 1e9 if prof else None
    out = [s for s in recs if lo <= s.start_ns and s.end_ns <= hi
           and (p0 is None or s.end_ns <= p0 or s.start_ns >= p1)]
    if not queries(out):
        return None
    return out


def total(recs: list, name: str, attr: str | None = None) -> float:
    """The summed duration (ns) of the spans named `name`, or with `attr`
    their summed attribute."""
    return sum((s.attrs.get(attr, 0) if attr else s.dur_ns)
               for s in recs if s.name == name)


def queries(recs: list) -> int:
    return int(total(recs, "serve_chunk", "queries"))


def ms_a_query(ctx, *names: str) -> float | None:
    """Milliseconds in the spans named `names`, a query served."""
    recs = window(ctx)
    if recs is None:
        return None
    return sum(total(recs, n) for n in names) * 1e-6 / queries(recs)
