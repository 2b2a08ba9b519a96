"""Threshold passes a step of the offset sweeps, per thousand steps: the
`fetch_wait` spans' `rank_passes_pm` attribute (1000 x the passes the
kernel's warp workers made over the steps they swept, read from the
launch's device counters once the fetch has waited for them), averaged
over the spans that lie in the window, after the oldest span the ring
still holds, and outside the stretch the profiler recorded.  A step makes
one pass when every offset of its tile met the table's top rank, and one
more for each lower threshold it had to sweep: at 1000 the maxrank cost
nothing beyond the counts.  A program whose fetches carry no such
attribute reads nothing."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "passes/ksteps"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "kernels"
MOVES = "pair_evals_per_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows", "serve.tcp_closed",
             "batch.long_shared")


def read(ctx):
    every = program_spans.records()
    if not every or not ctx.requests:
        return None
    lo = max(min(r.t0 for r in ctx.requests) * 1e9, every[0].end_ns)
    hi = max(r.t1 for r in ctx.requests) * 1e9
    prof = [r for r in ctx.requests if r.profiled]
    p0 = min(r.t0 for r in prof) * 1e9 if prof else None
    p1 = max(r.t1 for r in prof) * 1e9 if prof else None
    pms = [s.attrs["rank_passes_pm"] for s in every
           if s.name == "fetch_wait" and "rank_passes_pm" in s.attrs
           and lo <= s.start_ns and s.end_ns <= hi
           and (p0 is None or s.end_ns <= p0 or s.start_ns >= p1)]
    if not pms:
        return None
    return sum(pms) / len(pms)
