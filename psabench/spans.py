"""The harness's own spans around the program's layers.

A span wraps one function of `psa_torch` where its caller looks it up (a
module attribute, or a method on its class), times each call on the host
clock, and marks it in the profiler's trace (`torch.profiler.
record_function`, named "psabench.<span>"), so the trace's device gaps can
be laid against what the host was doing.  A span is installed for a traced
run only and taken out before the run ends.  A later change that puts such
spans inside the program lets these wrappers go.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import time

import torch

PREFIX = "psabench."


@dataclasses.dataclass(frozen=True)
class Target:
    """`attr` of module `module` ("Class.method" for a method), timed as
    span `span`; with `sync` the span ends with the device synchronised,
    so the device time the caller would wait for next lands inside it."""

    module: str
    attr: str
    span: str
    sync: bool = False


class Spans:
    """Per request, the seconds spent in each span."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.per_request: list[dict] = []
        self._current: dict | None = None

    @contextlib.contextmanager
    def request(self):
        self._current = {}
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(PREFIX + "request"):
                yield self._current
        finally:
            self._current["request"] = time.perf_counter() - t0
            self.per_request.append(self._current)
            self._current = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, fn, target: Target):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(PREFIX + target.span):
                    out = fn(*args, **kwargs)
                    if target.sync:
                        self._sync()
                return out
            finally:
                if self._current is not None:
                    self._current[target.span] = (
                        self._current.get(target.span, 0.0)
                        + time.perf_counter() - t0)
        return timed


def _owner(target: Target):
    obj = importlib.import_module(target.module)
    *path, name = target.attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


@contextlib.contextmanager
def installed(spans: Spans, targets):
    """Install a span on every target for the block, then restore each
    original."""
    saved = []
    try:
        for t in targets:
            owner, name = _owner(t)
            original = owner.__dict__[name]
            saved.append((owner, name, original))
            setattr(owner, name, spans.wrap(original, t))
        yield spans
    finally:
        for owner, name, original in reversed(saved):
            setattr(owner, name, original)
