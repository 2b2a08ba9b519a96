"""Queries a dispatch: the `serve_chunk` spans' `queries`, averaged over
the chunks the loop dispatched in the window, outside the profile.  The
loop dispatches a full `--serve-batch`, or a partial chunk once a pass
read no new line; at one query a chunk the clients' lines do not
coalesce."""

from psabench import serve_spans

KIND = "per_layer"
UNIT = "queries"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "serve loop"
MOVES = "pair_evals_per_s"
WORKLOADS = ("serve.tcp_closed",)


def read(ctx):
    recs = serve_spans.window(ctx)
    if recs is None:
        return None
    chunks = sum(s.name == "serve_chunk" for s in recs)
    return serve_spans.queries(recs) / chunks
