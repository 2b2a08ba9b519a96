"""The alphabet checks' host milliseconds a request: the program's
`validate` spans (both `validate` calls of the engine, both
`validate_batch` calls of the batch front), averaged over the requests the
profiler did not record."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine and batch front"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.mean_ms(ctx, "validate")
