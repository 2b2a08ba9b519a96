"""The 95th percentile (numpy's linear one) of every request completed in
the window: host-clock milliseconds from the call to its return with the
results on the host."""

import numpy as np

KIND = "end_to_end"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    ms = [r.seconds * 1e3 for r in ctx.requests if r.results is not None]
    if not ms:
        return None
    return float(np.percentile(ms, 95))
