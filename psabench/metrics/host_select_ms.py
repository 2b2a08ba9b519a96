"""Host selection's milliseconds a request (`host_select` or `_host_select`:
the exact re-score of the device's candidates), averaged over the requests
the profiler did not record."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host selection"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    if not ctx.spans or not any("host_select" in s for s in ctx.spans):
        return None
    return 1e3 * sum(s.get("host_select", 0.0) for s in ctx.spans) / len(ctx.spans)
