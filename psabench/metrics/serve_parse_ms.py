"""The serve loop's parse a query: the `parse` spans (the chunk's lines
through `parse_query_lines`, the native chunk scanner), over the queries
the window's chunks carried, outside the profile."""

from psabench import serve_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serve loop"
MOVES = "request_ms_p95"
WORKLOADS = ("serve.tcp_closed",)


def read(ctx):
    return serve_spans.ms_a_query(ctx, "parse")
