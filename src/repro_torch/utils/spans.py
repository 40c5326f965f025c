"""Spans and counters at the port's layer boundaries, kept in memory.

``with span("engine.round", round=r):`` marks one call of a layer
function, and ``count("host_reads")`` adds to a counter. Both record only
inside ``with recording() as rec:``; outside it `span` checks one
module-level flag and returns a shared object that does nothing, and
`count` returns at once. After the block, ``rec.spans`` holds every span
that closed inside it and ``rec.counts`` every counter.

A span holds its name, its start and end from ``time.time_ns()`` (the
clock of ``torch.profiler``'s events), its parent, its thread and its
attributes. A span inherits its parent's attributes, so every span inside
a round carries the round's ``round`` and every span inside a
Random-Sampling chunk its ``chunk``. Its parent is the innermost span open
on its own thread; a span opened on a thread with none open (the autograd
engine runs CUDA backwards on a thread of its own, while the calling
thread waits in ``autograd.grad``) takes the span that started last among
those open on any thread.

A span is one call of a layer function, never one kernel launch, so that
recording costs little beside the work it marks. Recording reads the host
clock only: it changes no number the program computes.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional

__all__ = ["Recorder", "Span", "count", "recording", "span"]


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    attrs: Dict[str, object]


class _Noop:
    """What `span` returns outside `recording`."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_rec: Optional["Recorder"] = None   # the flag: the recording under way


class Recorder:
    """The spans and counters of one `recording` block."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = defaultdict(int)
        self._ids = itertools.count()
        self._counting = threading.Lock()
        self._local = threading.local()
        # the open spans, id → (start_ns, attrs); each set, delete and copy
        # of it is one step under the interpreter's lock
        self._open: Dict[int, tuple] = {}

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class _Open:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "start", "stack")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        stack = getattr(rec._local, "stack", None)
        if stack is None:
            stack = rec._local.stack = []
        if stack:
            parent = stack[-1]
            inherited = rec._open[parent][1]
        else:
            opened = list(rec._open.items())
            parent, inherited = None, None
            if opened:
                parent, (_, inherited) = max(
                    opened, key=lambda kv: (kv[1][0], kv[0]))
        if inherited:
            self.attrs = {**inherited, **self.attrs}
        self.id, self.parent, self.stack = next(rec._ids), parent, stack
        self.start = time.time_ns()
        rec._open[self.id] = (self.start, self.attrs)
        stack.append(self.id)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        self.stack.pop()
        del rec._open[self.id]
        rec.spans.append(Span(self.id, self.name, self.start, end,
                              self.parent, threading.get_ident(),
                              self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager marking one call of a layer function: recorded
    inside `recording`, else the shared no-op."""
    rec = _rec
    if rec is None:
        return _NOOP
    return _Open(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` inside `recording`."""
    rec = _rec
    if rec is None:
        return
    with rec._counting:
        rec.counts[name] += n


@contextmanager
def recording() -> Iterator[Recorder]:
    """Record every span and counter of the block into a new `Recorder`."""
    global _rec
    outer, rec = _rec, Recorder()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = outer
