"""The program's spans: a recorder of where a request's host time goes.

    with spans.span("upload", bytes=n) as sp:
        ...
        sp.set(rows=r)

A span records its name, its start and end on `time.perf_counter_ns()` (the
host clock a caller times its requests on), its own id, its parent (the
innermost span open on the same thread), the request id that every span
under one root shares, and small integer attributes.  A span opened with no
parent is a root and starts a new request.  Work of a request that runs on
another thread joins it under `within(root)`.

Closed spans go into one bounded ring in memory, the last `CAPACITY` of
them: `records()` returns a snapshot (`Record`s), `clear()` empties it.
Nothing is written to disk.  The ring is allocated once: a buffer of packed
integer rows, and lists that hold each span's name and its one attribute's
key, so a closed span leaves no object of its own alive on the heap.  (A
ring of live span objects, first a `collections.deque` and then a list,
read slower requests on an H100 machine's host, for a cause not yet
settled.)  A span with more than one attribute keeps them in a dict.
The recorder is on from import; `enable(False)` turns it off, and `span()`
then returns a shared no-op context.

While a `torch.profiler` profile is active, each span also opens
`record_function("psa.<name>")`, so the program's steps lie on the same
timeline as the kernels and copies in the profiler's trace.  Outside a
profile no `record_function` is opened, and this module never imports torch
itself.
"""

from __future__ import annotations

import itertools
import struct
import sys
import threading
import time
from typing import NamedTuple

CAPACITY = 65_536
PREFIX = "psa."

_on = True
# id, parent (0 for a root), request, start, end, the attribute's value
_ROW = struct.Struct("6q")
_rows = bytearray(_ROW.size * CAPACITY)
_names: list = [None] * CAPACITY          # None: an empty slot
_keys: list = [None] * CAPACITY           # the attribute's; a dict for several
_slots = itertools.count()                # the next slot, taken atomically
_ids = itertools.count(1)
_local = threading.local()
_profiler_enabled = None      # torch.autograd._profiler_enabled, once found


class Record(NamedTuple):
    """A closed span, as `records()` gives it."""

    name: str
    id: int
    parent: int | None
    request: int
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _find_profiler():
    """torch.autograd._profiler_enabled, or None before torch is imported
    (no profile can precede it)."""
    global _profiler_enabled
    torch = sys.modules.get("torch")
    if torch is not None:
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled


class Span:
    """One span while it is open; once closed it still reads as its
    record."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "attrs", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent: int | None = None
        self.request = self.id
        self.start_ns = self.end_ns = 0
        self._rf = None

    def set(self, **attrs) -> None:
        """Set integer attributes before the span closes."""
        self.attrs.update(attrs)

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            up = stack[-1]
            self.parent, self.request = up.id, up.request
        stack.append(self)
        profiling = _profiler_enabled or _find_profiler()
        if profiling is not None and profiling():
            from torch.profiler import record_function

            self._rf = record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _stack().pop()
        # The slot is emptied first and named last: `records()` reads a
        # slot being written as empty, or sees its row change (each store
        # is atomic under the GIL).
        i = next(_slots) % CAPACITY
        _names[i] = None
        a, val = self.attrs, 0
        if len(a) == 1:
            (_keys[i], val), = a.items()
        else:
            _keys[i] = a or None
        _ROW.pack_into(_rows, i * _ROW.size, self.id, self.parent or 0,
                       self.request, self.start_ns, self.end_ns, val)
        _names[i] = self.name


class _NoSpan:
    """What `span()` returns while the recorder is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _NoSpan()


def span(name: str, **attrs):
    """A span named `name` (a context manager), with integer `attrs`."""
    if not _on:
        return _NOOP
    return Span(name, attrs)


class within:
    """Open the block's spans under `parent` (a Span, open or closed), on
    this thread: the work of a request that another thread carries on.
    A no-op span (the recorder was off) changes nothing."""

    __slots__ = ("parent",)

    def __init__(self, parent):
        self.parent = parent if isinstance(parent, Span) else None

    def __enter__(self):
        if self.parent is not None:
            _stack().append(self.parent)
        return self.parent

    def __exit__(self, *exc) -> None:
        if self.parent is not None:
            _stack().pop()


def enable(on: bool = True) -> bool:
    """Turn the recorder on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


def recording() -> bool:
    """Whether the recorder is on (`span()` then records)."""
    return _on


def records() -> list:
    """The ring's closed spans as `Record`s, in the order they closed (a
    snapshot)."""
    first = bytes(_rows)
    names, keys = _names[:], _keys[:]
    rows = bytes(_rows)
    out = []
    for i, (name, key, row) in enumerate(zip(names, keys,
                                              _ROW.iter_unpack(rows))):
        if name is None or _ROW.unpack_from(first, i * _ROW.size) != row:
            continue            # empty, or written while this copy was made
        sid, parent, request, start, end, val = row
        attrs = ({key: val} if isinstance(key, str)
                 else dict(key) if key else {})
        out.append(Record(name, sid, parent or None, request, start, end,
                          attrs))
    out.sort(key=lambda r: r.end_ns)
    return out


def clear() -> None:
    _names[:] = [None] * CAPACITY
