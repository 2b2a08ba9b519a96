"""Profiling and throughput accounting.

The reference's only instrumentation is one MPI_Wtime pair around the search
(cpu_funcs.c:57-62).  Here, as in the JAX package's utils/profiling.py:

* `Phase` timers give per-stage wall times (prepare/sweep/select),
* `pair_evals` computes the north-star work metric (BASELINE.json),
* `trace` wraps `torch.profiler` for a device trace (`psa-torch --trace
  LOGDIR`): one Chrome/Perfetto JSON file per traced run, which
  TensorBoard's profiler plugin, chrome://tracing and ui.perfetto.dev read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from psa_torch.models import search


@dataclasses.dataclass
class Phase:
    name: str
    seconds: float = 0.0
    calls: int = 0


class Timer:
    """Accumulating phase timer: with t.phase("sweep"): ..."""

    def __init__(self):
        self.phases: dict[str, Phase] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            p = self.phases.setdefault(name, Phase(name))
            p.seconds += time.perf_counter() - t0
            p.calls += 1

    def report(self) -> str:
        width = max((len(n) for n in self.phases), default=4)
        lines = [
            f"{p.name:<{width}}  {p.seconds * 1e3:10.2f} ms  ({p.calls} calls)"
            for p in self.phases.values()
        ]
        return "\n".join(lines)


def pair_evals(n1: int, n2: int) -> float:
    """Offset-position pair evaluations for one sweep (the work unit)."""
    return float(search.pair_evals(n1, n2))


def throughput(n1: int, n2: int, seconds: float, chips: int = 1) -> float:
    """pair-evals / second / chip."""
    return pair_evals(n1, n2) / seconds / max(chips, 1)


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
