"""The uploads' host milliseconds a request: the program's `upload` spans
(`ops/sweep.upload_codes`, `models/batch.upload_rows`: the pinned buffer,
the padding, the copy into it and the enqueue), averaged over the requests
the profiler did not record.  `copy_ms` keeps the copies' device time."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "upload and fetch"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.mean_ms(ctx, "upload")
