"""A line's wait in the serve loop's queue: the `serve_chunk` spans'
`queue_us` (each line's wait from the read of its newline to its chunk's
dispatch, summed), over the lines they carried, outside the profile."""

from psabench import serve_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serve loop"
MOVES = "request_ms_p95"
WORKLOADS = ("serve.tcp_closed",)


def read(ctx):
    recs = serve_spans.window(ctx)
    if recs is None:
        return None
    lines = serve_spans.total(recs, "serve_chunk", "lines")
    return 1e-3 * serve_spans.total(recs, "serve_chunk", "queue_us") / lines
