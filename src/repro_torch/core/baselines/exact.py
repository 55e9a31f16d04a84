"""Exact quantile oracle — stores the full stream (ground truth only)."""
from __future__ import annotations

import bisect
from typing import List


class ExactQuantile:
    def __init__(self):
        self.sorted: List[float] = []

    def insert(self, v: float) -> None:
        bisect.insort(self.sorted, v)

    def extend(self, values) -> None:
        for v in values:
            self.insert(float(v))

    def query(self, q: float) -> float:
        """Upper quantile per the paper's upper-median convention."""
        n = len(self.sorted)
        if n == 0:
            return 0.0
        idx = min(int(q * n), n - 1)
        return self.sorted[idx]

    def memory_words(self) -> int:
        """QuantileEstimator protocol: summary size in words (here: all of
        them — the exact oracle stores the stream)."""
        return len(self.sorted)
