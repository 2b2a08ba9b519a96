"""Host selection's full-stats fallbacks (a query whose f32 near-tie band
holds more than k offsets) per 1,000 queries: the program's
`near_fallback` spans over every request of the window."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "fallbacks/kq"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host selection"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.per_kq(ctx, "near_fallback")
