"""One profile a process, read from `torch.profiler`'s trace.

The traced run starts the profiler once, between two requests in a steady
part of its window, and stops it between two later requests.  The trace is
exported as Chrome JSON into a temporary file under TMPDIR, read, and
deleted.  From it come the device's operations (kernels, copies and memsets
with their times on the device), and the harness's spans
("psabench.<span>", spans.py) on the host's timeline, on one clock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

from psabench.spans import PREFIX

KERNEL = "kernel"
COPY = "gpu_memcpy"
MEMSET = "gpu_memset"
DEVICE_CATS = (KERNEL, COPY, MEMSET)


@dataclasses.dataclass(frozen=True)
class Event:
    cat: str
    name: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    device: list          # Events on the device
    spans: list           # Events of the harness's spans on the host

    @classmethod
    def from_chrome(cls, doc: dict) -> "Trace":
        device, spans = [], []
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat, name = ev.get("cat", ""), str(ev.get("name", ""))
            e = Event(cat, name, float(ev["ts"]), float(ev["dur"]))
            if cat in DEVICE_CATS:
                device.append(e)
            elif cat == "user_annotation" and name.startswith(PREFIX):
                spans.append(Event(cat, name[len(PREFIX):], e.start_us,
                                   e.dur_us))
        return cls(device, spans)

    def requests(self) -> list:
        return sorted((e for e in self.spans if e.name == "request"),
                      key=lambda e: e.start_us)

    def window_us(self) -> tuple[float, float] | None:
        """From the first traced request's start to the last one's end."""
        req = self.requests()
        if not req:
            return None
        return req[0].start_us, max(e.end_us for e in req)

    def in_window(self, cats=DEVICE_CATS) -> list:
        w = self.window_us()
        if w is None:
            return []
        return [e for e in self.device if e.cat in cats
                and e.end_us > w[0] and e.start_us < w[1]]

    def busy_us(self) -> float:
        """Microseconds of the window in which some operation ran on the
        device: the union of kernels, copies and memsets, clipped to it."""
        w = self.window_us()
        if w is None:
            return 0.0
        merged = union((max(e.start_us, w[0]), min(e.end_us, w[1]))
                       for e in self.in_window())
        return sum(e - s for s, e in merged)

    def device_us(self, cats, contains: str = "") -> float:
        return sum(e.dur_us for e in self.in_window(cats)
                   if contains in e.name)

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by: dict = {}
        for e in self.in_window():
            by[e.name] = by.get(e.name, 0.0) + e.dur_us * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """[name, seconds]: the device's idle time in the window, summed by
        the innermost span the host was in at each gap's middle ("outside
        requests" between them), largest first."""
        w = self.window_us()
        if w is None:
            return []
        merged = union((max(e.start_us, w[0]), min(e.end_us, w[1]))
                       for e in self.in_window())
        edges = [w[0]] + [x for iv in merged for x in iv] + [w[1]]
        spans = sorted(self.spans, key=lambda e: e.dur_us)
        by: dict = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            inner = next((sp.name for sp in spans
                          if sp.start_us <= mid < sp.end_us), "outside requests")
            by[inner] = by.get(inner, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


class Profile:
    """Start and stop the profiler once; `trace` holds what it read."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self._prof = profile(activities=acts)
        self.trace: Trace | None = None
        self.bytes = 0

    def start(self):
        self._prof.start()

    def stop(self) -> Trace:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        fd, path = tempfile.mkstemp(prefix="psabench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.bytes = os.path.getsize(path)
            with open(path) as f:
                self.trace = Trace.from_chrome(json.load(f))
        finally:
            os.unlink(path)
        return self.trace
