"""The top-k epilogue kernel's device microseconds a query
(`csrc/epilogue.cu`, every kernel whose name holds "epilogue"), from the
profiler's trace."""

from psabench.trace import KERNEL

KIND = "per_layer"
UNIT = "us"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "epilogue"
MOVES = "pair_evals_per_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    if ctx.trace is None or not ctx.traced_requests:
        return None
    us = ctx.trace.device_us((KERNEL,), contains="epilogue")
    if us <= 0:
        return None
    return us / (ctx.traced_requests * ctx.queries_per_call)
