"""Seconds of set-up in the program's libraries and tables: the union of
its `build_library` (the kernels' hash, nvcc when it runs, the load and
checks), `native_load` (the host library's build, load and self-test) and
`device_tables` spans that closed before the window's first request."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "set-up"
MOVES = "setup_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.setup_s(ctx)
