"""The serve loop's replies a query: the `reply` spans (the formatting on
the finishing thread: mutant and `%g` score) and the `route` spans (the
replies put in their connections' outboxes, on the loop's thread), over the
queries the window's chunks carried, outside the profile."""

from psabench import serve_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serve loop"
MOVES = "request_ms_p95"
WORKLOADS = ("serve.tcp_closed",)


def read(ctx):
    return serve_spans.ms_a_query(ctx, "reply", "route")
