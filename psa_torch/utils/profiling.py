"""The device trace: `trace` wraps `torch.profiler` for `psa-torch --trace
LOGDIR`, one Chrome/Perfetto JSON file per traced run, which TensorBoard's
profiler plugin, chrome://tracing and ui.perfetto.dev read.  The file holds
the program's own spans (utils/spans.py, as "psa.<name>" annotations) on the
same timeline as the kernels and copies.

The reference's only instrumentation is one MPI_Wtime pair around the search
(cpu_funcs.c:57-62).  The program times its steps with utils/spans.py.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(logdir: str | None, cuda: bool | None = None):
    """Capture a torch.profiler trace of the block into LOGDIR when logdir
    is given: host operators, and with `cuda` (default: when a card is
    present) the card's kernels, copies and memsets through CUPTI, the
    hand-written sweeps under their compiled names (`sweep_kernel`,
    `sweep_batched_kernel<false>`, ...).  The file is
    LOGDIR/<host>_<pid>.<timestamp>.pt.trace.json, written when the block
    ends.  A falsy logdir does nothing and imports no profiler."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if cuda:
            # the kernels enqueued inside the block land in this trace
            torch.cuda.synchronize()
