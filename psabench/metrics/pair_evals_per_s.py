"""Pair evaluations a second: (n1 - n2 + 1) x n2 of every query that a
request completed in the window, summed, over the window's whole wall time
(the first call to the last return)."""

KIND = "end_to_end"
UNIT = "pairs/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    done = [r for r in ctx.requests if r.results is not None]
    if not done or ctx.window_s <= 0:
        return None
    return len(done) * ctx.pairs_per_call / ctx.window_s
