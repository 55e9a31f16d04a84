"""Host spans on the program's paths, recorded only when asked for.

    from repro_torch import tracing

    with tracing.recording() as rec:
        fleet = fleet.ingest_stream(chunks)
    rec.spans     # [(name, parent, root, t0_ns, t1_ns), ...] by start
    rec.counts    # {name: times the span was entered}
    rec.dropped   # spans past ``CAPACITY``, counted but not kept

The program marks its layers with ``with tracing.span(name):``. Off, the
default, ``span`` checks one module flag and asks torch whether a
profiler runs; with none, it returns a shared no-op context: nothing is
allocated and no clock is read. Inside ``recording()`` each span keeps
its name, the index of the span around it on its thread (``parent``, -1
for none), the index of the outermost one (``root``, itself for an
outermost span: every span of one call shares it) and its start and end
in ``time.time_ns()``, the Unix nanoseconds that ``torch.profiler``'s
events carry (``start_ns()``), so a record lines up with a profiler's
host events. While a ``torch.profiler`` is recording, each span, recorded
or not, opens a ``record_function`` of its name, which puts it on the
profiler's host and device timelines.

A record keeps the first ``CAPACITY`` spans by start. A span starts after
every span around it, so a kept span's parent and root are kept too.

Spans enclose straight-line code only, never a ``yield``. This module
imports nothing of ``repro_torch``, so any module of it may use it.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["CAPACITY", "Record", "recording", "span"]

CAPACITY = 2 ** 20  # spans a record keeps; a 30 s ingest window enters ~10^5


class Record:
    """What one ``recording()`` kept. ``spans[i]`` is ``(name, parent,
    root, t0_ns, t1_ns)``, listed in the order the spans started; a span
    still open when it is read is None. ``counts`` counts every entry of
    each name, kept or dropped: the counter at that boundary."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self.dropped = 0
        self._lock = threading.Lock()
        self._stacks = threading.local()    # open spans of each thread


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_record = None      # the active Record; None is off


class _Span:
    __slots__ = ("name", "rec", "index", "root", "t0", "twin")

    def __init__(self, name: str, rec: Record):
        self.name, self.rec = name, rec

    def __enter__(self):
        rec, name = self.rec, self.name
        stack = getattr(rec._stacks, "open", None)
        if stack is None:
            stack = rec._stacks.open = []
        with rec._lock:
            rec.counts[name] = rec.counts.get(name, 0) + 1
            if len(rec.spans) < CAPACITY:
                self.index = len(rec.spans)
                rec.spans.append(None)
            else:
                self.index = -1
                rec.dropped += 1
        self.root = stack[0].index if stack else self.index
        stack.append(self)
        self.twin = None
        if torch.autograd._profiler_enabled():
            self.twin = torch.autograd.profiler.record_function(name)
            self.twin.__enter__()
        self.t0 = time.time_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.twin is not None:
            self.twin.__exit__(*exc)
        stack = self.rec._stacks.open
        stack.pop()
        if self.index >= 0:
            parent = stack[-1].index if stack else -1
            self.rec.spans[self.index] = (self.name, parent, self.root,
                                          self.t0, t1)
        return False


def span(name: str):
    """A context marking ``name`` on the active recording and on a running
    profiler, or a no-op."""
    rec = _record
    if rec is not None:
        return _Span(name, rec)
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Turn spans on for the body and yield its ``Record``; off again on
    exit."""
    global _record
    if _record is not None:
        raise RuntimeError("spans are already recording")
    rec = Record()
    _record = rec
    try:
        yield rec
    finally:
        _record = None
