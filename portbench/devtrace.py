"""Reading a profiled window: device time by operation, the device's busy
time, and the idle gaps by what the host was doing.

The window is recorded with ``torch.profiler`` (CPU and CUDA activity)
and the benchmark marks its own host spans with ``record_function``
under names that start with ``pb.``: ``pb.window`` around the whole
window, ``pb.call`` around each call into the system and ``pb.sync``
around the wait for the batch. The profiler also copies every such span,
the benchmark's or the program's, onto the device's timeline as a user
annotation; that copy is no operation, and is left out by its kind.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

WINDOW = "pb.window"


def op_name(name: str) -> str:
    """A device operation's name without its signature or template
    arguments: ``void k<3>(Args)`` -> ``k``."""
    return re.sub(r"^void ", "", name).split("(")[0].split("<")[0].strip()


@dataclasses.dataclass
class Trace:
    busy_s: float                               # union of device activity
    ops: Dict[str, Tuple[int, float]]           # name: (calls, seconds)
    idle: Dict[str, float]                      # host activity: idle s

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(calls, seconds) of the device operations whose name holds
        ``fragment``."""
        calls, secs = 0, 0.0
        for name, (c, s) in self.ops.items():
            if fragment in name:
                calls, secs = calls + c, secs + s
        return calls, secs

    def top_ops(self, n: int = 10) -> List[list]:
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, secs] for name, (_, secs) in rows]

    def top_idle(self, n: int = 10) -> List[list]:
        rows = sorted(self.idle.items(), key=lambda kv: -kv[1])[:n]
        return [[name, secs] for name, secs in rows]


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, points):
    """For each sorted time in ``points``, the name path of the innermost
    host span holding it (spans of one thread nest), or "host idle"."""
    host = sorted(host, key=lambda s: (s[1], -s[2]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][1] <= p:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        if not stack:
            out.append("host idle")
            continue
        outer = next((s[0] for s in stack if s[0].startswith("pb.")
                      and s[0] != WINDOW), None)
        inner = stack[-1][0]
        out.append(inner if outer in (None, inner) else f"{outer}/{inner}")
    return out


def _kind(e, cuda) -> str:
    """The kind of a recorded event: ``cpu`` on the host, ``cuda`` for an
    operation on the device, ``cuda annotation`` for a span's copy on the
    device's timeline (the profiler's ``gpu_user_annotation``)."""
    if e.device_type() != cuda:
        return "cpu"
    return "cuda annotation" if e.is_user_annotation() else "cuda"


def read(prof) -> Optional[Trace]:
    """The Trace of a finished profiler, or None where it recorded no
    device activity. Reads the profiler's raw events (building its Python
    event tree takes about a minute for a window of 10^5 events)."""
    from torch.autograd import DeviceType

    return summarize(
        (e.name(), _kind(e, DeviceType.CUDA), e.start_ns() / 1e3,
         e.end_ns() / 1e3, e.start_thread_id())
        for e in prof.profiler.kineto_results.events())


def summarize(events) -> Optional[Trace]:
    """The Trace of events (name, kind, start us, end us, thread), the kind
    "cpu", "cuda" or "cuda annotation" (left out); None without device
    activity or a window span."""
    device, host, windows = [], [], []
    for name, kind, a, b, thread in events:
        if kind == "cuda":
            device.append((op_name(name), a, b))
        elif kind == "cpu":
            if name == WINDOW:
                windows.append((a, b, thread))
            host.append((name, a, b, thread))
    if not device or not windows:
        return None
    w0, w1, thread = windows[0]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in inside])
    ops: Dict[str, Tuple[int, float]] = {}
    for name, a, b in inside:
        c, s = ops.get(name, (0, 0.0))
        ops[name] = (c + 1, s + (b - a) / 1e6)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    names = _innermost([(n, a, b) for n, a, b, t in host if t == thread],
                       [(a + b) / 2 for a, b in gaps])
    idle: Dict[str, float] = {}
    for name, (a, b) in zip(names, gaps):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return Trace(busy_s=sum(b - a for a, b in busy) / 1e6, ops=ops,
                 idle=idle)
