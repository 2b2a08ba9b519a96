"""The share of the profiled window in which the card is idle while the
host is inside the program's `validate` or `encode` spans: the spans laid
on the profiler's clock (program_spans.on_trace) against the union of the
device's operations."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "engine and batch front"
MOVES = "pair_evals_per_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.idle_in_pct(ctx)
