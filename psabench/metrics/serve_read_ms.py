"""The serve loop's socket reads a query: the `serve_read` spans (each a
readable event the loop drained into its connection's buffer and split
into lines), over the queries the window's chunks carried, outside the
profile.  An 850 kB line arrives in many reads, on the loop's thread."""

from psabench import serve_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serve loop"
MOVES = "request_ms_p95"
WORKLOADS = ("serve.tcp_closed",)


def read(ctx):
    return serve_spans.ms_a_query(ctx, "serve_read")
