"""The kernels' share of their roofline: the least time the card could take
for the traced requests' work (roofline.py: one multiply-accumulate a pair
at the densest int8 rate, or the codes in and the result out at the HBM
rate, whichever is larger) over the summed device time of every kernel and
memset of those requests, copies left out.  It counts the same work
whatever kernels do it, so a kernel taken off the path still shows here."""

from psabench.trace import KERNEL, MEMSET

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "pair_evals_per_s"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    if ctx.trace is None or not ctx.traced_requests:
        return None
    us = ctx.trace.device_us((KERNEL, MEMSET))
    if us <= 0:
        return None
    return 100.0 * ctx.floor_s_per_call * ctx.traced_requests / (us * 1e-6)
