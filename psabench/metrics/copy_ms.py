"""Device milliseconds of host-to-device and device-to-host copies a request
(the uploads and the fetch), from the profiler's trace."""

from psabench.trace import COPY

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "upload and fetch"
MOVES = "pair_evals_per_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    if ctx.trace is None or not ctx.traced_requests:
        return None
    us = ctx.trace.device_us((COPY,))
    if us <= 0:
        return None
    return us * 1e-3 / ctx.traced_requests
