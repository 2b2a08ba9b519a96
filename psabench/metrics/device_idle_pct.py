"""The share of the traced window (the first traced request's call to the
last one's return) in which nothing ran on the card: no kernel, no copy, no
memset (the union of their intervals), from the profiler's trace."""

KIND = "per_layer"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "pair_evals_per_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    if ctx.trace is None:
        return None
    w = ctx.trace.window_us()
    if w is None or w[1] <= w[0]:
        return None
    busy = ctx.trace.busy_us()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (w[1] - w[0]))
