"""The host's wait for the device's result a request: the program's
`fetch_wait` spans (`Fetch.wait`), averaged over the requests the profiler
did not record.  Batch only: in the single-query cell a traced run's
harness synchronises at the end of `run_exact`, so the wait falls outside
this span there."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "device"
MOVES = "request_ms_p95"
WORKLOADS = ("batch.long_rows",)


def read(ctx):
    return program_spans.mean_ms(ctx, "fetch_wait")
