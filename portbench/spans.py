"""Reading a recorded window: the program's host spans, kept by
``repro_torch.tracing.recording()`` around a window of the harness's own
in a ``--trace 1`` run, summed by name for the readers of
``program_span`` metrics.

A span's self time is its length less the lengths of the spans directly
inside it: the kept spans whose ``parent`` is its index (the spans of one
thread nest and do not overlap). Every helper reads None where the record
dropped spans past its capacity, or where a span it names never ran in
the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional


@dataclasses.dataclass
class Spans:
    spans: list                 # the record's (name, parent, root, t0, t1)
    counts: Dict[str, int]      # entries of each name, kept or dropped
    dropped: int
    batches: int                # batches handed in over the window
    total_s: Dict[str, float]   # summed length of the kept spans a name
    self_s: Dict[str, float]    # their summed self time

    def _seen(self, names: Iterable[str]) -> bool:
        return (not self.dropped and self.batches > 0
                and all(n in self.total_s for n in names))

    def self_ms(self, names) -> Optional[float]:
        """Milliseconds a batch in the spans ``names``, less what their
        child spans cover."""
        if not self._seen(names):
            return None
        return 1e3 * sum(self.self_s[n] for n in names) / self.batches

    def entry_ms(self, name: str) -> Optional[float]:
        """Milliseconds an entry of the span ``name``, whole."""
        if not self._seen((name,)):
            return None
        return 1e3 * self.total_s[name] / self.counts[name]

    def lead_ms(self, root: str, name: str) -> Optional[float]:
        """Milliseconds a batch from the start of each outermost span
        ``root`` to the end of the first span ``name`` inside it."""
        if not self._seen((root, name)):
            return None
        starts, ends = {}, {}
        for i, s in enumerate(self.spans):
            if s is None:
                continue
            n, parent, top, t0, t1 = s
            if n == root and parent == -1:
                starts[i] = t0
            elif n == name and top in starts and top not in ends:
                ends[top] = t1
        ns = sum(t1 - starts[top] for top, t1 in ends.items())
        return ns / 1e6 / self.batches


def summarize(rec, batches: int) -> Spans:
    """The Spans of a ``tracing.Record`` (``spans``, ``counts``,
    ``dropped``) over a window of ``batches`` batches."""
    spans = rec.spans
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s is not None and s[1] >= 0:
            child_ns[s[1]] = child_ns.get(s[1], 0) + s[4] - s[3]
    total: Dict[str, float] = {}
    own: Dict[str, float] = {}
    for i, s in enumerate(spans):
        if s is None:
            continue
        name, length = s[0], s[4] - s[3]
        total[name] = total.get(name, 0.0) + length / 1e9
        own[name] = own.get(name, 0.0) + (length - child_ns.get(i, 0)) / 1e9
    return Spans(spans=spans, counts=dict(rec.counts), dropped=rec.dropped,
                 batches=batches, total_s=total, self_s=own)
