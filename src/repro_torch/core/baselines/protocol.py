"""QuantileEstimator — the one interface every quantile summary answers.

The paper's §6 comparison runs frugal sketches against GK, q-digest and
random-order Selection. Each baseline here (and the frugal adapter,
repro_torch.api.FrugalEstimator) implements this protocol, so benchmark
harnesses drive every algorithm through one loop:

    est.insert(v)         # one stream item
    est.extend(values)    # a block of items
    est.query(q)          # current estimate of quantile q
    est.memory_words()    # persistent summary size, in words

`memory_words` is a METHOD (not a property) to match
GroupedQuantileSketch / QuantileFleet — one calling convention everywhere.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class QuantileEstimator(Protocol):
    """Structural interface for streaming quantile summaries."""

    def insert(self, v: float) -> None:
        """Ingest one stream item."""
        ...

    def extend(self, values) -> None:
        """Ingest an iterable of stream items, in order."""
        ...

    def query(self, q: float) -> float:
        """Current estimate of quantile q ∈ (0, 1)."""
        ...

    def memory_words(self) -> int:
        """Persistent summary size in (4-byte) words."""
        ...
