"""The exact re-score's host milliseconds a request: the program's
`rescore` spans (the native or numpy re-score of the device's candidates
inside host selection), averaged over the requests the profiler did not
record."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host selection"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.mean_ms(ctx, "rescore")
