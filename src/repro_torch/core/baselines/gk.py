"""Greenwald-Khanna ε-approximate quantile summary (paper §6.1).

Maintains tuples (v_i, g_i, Δ_i) sorted by v. Invariant: for every tuple,
g_i + Δ_i <= 2εn. The paper's comparison variant accepts a hard memory budget
`max_tuples` (t=20 in their experiments): when the list exceeds the budget,
ε is inflated by +0.001 repeatedly and compression re-run until the summary
fits (§6.1, last paragraph).
"""
from __future__ import annotations

from typing import List, Tuple


class GKSummary:
    def __init__(self, eps: float = 0.001, max_tuples: int = 20):
        self.eps = eps
        self.max_tuples = max_tuples
        self.n = 0
        # list of [v, g, delta]
        self.tuples: List[List[float]] = []

    # ------------------------------------------------------------- insertion
    def insert(self, v: float) -> None:
        self.n += 1
        t = self.tuples
        if not t or v < t[0][0]:
            t.insert(0, [v, 1, 0])
        elif v >= t[-1][0]:
            t.append([v, 1, 0])
        else:
            # find first tuple with value > v (binary search)
            lo, hi = 0, len(t)
            while lo < hi:
                mid = (lo + hi) // 2
                if t[mid][0] <= v:
                    lo = mid + 1
                else:
                    hi = mid
            cap = max(int(2 * self.eps * self.n) - 1, 0)
            t.insert(lo, [v, 1, cap])
        if len(t) > self.max_tuples:
            self._force_compress()

    def extend(self, values) -> None:
        for v in values:
            self.insert(float(v))

    # ----------------------------------------------------------- compression
    def _compress_once(self) -> None:
        """Merge adjacent tuples while preserving g_i + Δ_i <= 2εn."""
        t = self.tuples
        if len(t) < 3:
            return
        bound = 2 * self.eps * self.n
        i = len(t) - 2
        while i >= 1:
            if t[i][1] + t[i + 1][1] + t[i + 1][2] <= bound:
                t[i + 1][1] += t[i][1]
                del t[i]
                i = min(i, len(t) - 2)
            i -= 1

    def _force_compress(self) -> None:
        """Paper §6.1: inflate ε by 0.001 until the budget is met."""
        self._compress_once()
        while len(self.tuples) > self.max_tuples:
            self.eps += 0.001
            self._compress_once()
            if self.eps > 0.5:  # degenerate safety valve
                break

    # ----------------------------------------------------------------- query
    def query(self, q: float) -> float:
        """ε-approximate q-quantile."""
        if not self.tuples:
            return 0.0
        r = q * self.n
        bound = self.eps * self.n
        rmin = 0.0
        for v, g, d in self.tuples:
            rmin += g
            if rmin + d >= r - bound and rmin <= r + bound:
                return v
            if rmin > r + bound:
                return v
        return self.tuples[-1][0]

    def memory_words(self) -> int:
        """QuantileEstimator protocol: 3 words per (v, g, Δ) tuple."""
        return 3 * len(self.tuples)
