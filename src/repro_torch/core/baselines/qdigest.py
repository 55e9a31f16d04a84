"""q-digest (Shrivastava et al. 2004), streaming adaptation (paper §6.2).

Binary tree over integer domain [1, sigma] (sigma a power of two, given up
front — a real disadvantage vs frugal that the paper calls out). Node id uses
the standard heap numbering: root 1, children 2i, 2i+1; leaves are the domain
values. Compression enforces, with alpha = n / b:

  (1) count(v)              <= floor(alpha)
  (2) count(v)+count(parent)+count(sibling) > floor(alpha)

violating non-leaf nodes have their children merged upward. Memory may exceed
b but is bounded by 3b (paper §6.2).
"""
from __future__ import annotations

import math
from typing import Dict


class QDigest:
    def __init__(self, sigma: int, b: int = 20):
        # round domain up to a power of two
        self.log_sigma = max(1, int(math.ceil(math.log2(max(2, sigma)))))
        self.sigma = 1 << self.log_sigma
        self.b = b
        self.n = 0
        self.counts: Dict[int, int] = {}

    def _leaf_id(self, v: int) -> int:
        v = min(max(int(v), 0), self.sigma - 1)
        return self.sigma + v

    def insert(self, v: float) -> None:
        self.n += 1
        leaf = self._leaf_id(int(v))
        self.counts[leaf] = self.counts.get(leaf, 0) + 1
        if len(self.counts) > self.b:
            self.compress()

    def extend(self, values) -> None:
        for v in values:
            self.insert(v)

    def compress(self) -> None:
        alpha = max(1, self.n // self.b)
        # bottom-up sweep: deepest ids first
        for node in sorted(self.counts.keys(), reverse=True):
            if node <= 1:
                continue
            c = self.counts.get(node, 0)
            if c == 0:
                self.counts.pop(node, None)
                continue
            parent = node // 2
            sibling = node ^ 1
            total = c + self.counts.get(parent, 0) + self.counts.get(sibling, 0)
            if total <= alpha:
                # merge node + sibling into parent
                self.counts[parent] = total
                self.counts.pop(node, None)
                self.counts.pop(sibling, None)

    def query(self, q: float) -> float:
        """Traverse leaves-first in value order accumulating counts."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        # order nodes by (right endpoint, range size): postorder value sweep
        def node_range(node: int):
            depth = node.bit_length() - 1
            span = self.sigma >> depth
            lo = (node - (1 << depth)) * span
            return lo, lo + span - 1

        items = []
        for node, c in self.counts.items():
            lo, hi = node_range(node)
            items.append((hi, hi - lo, node, c))
        items.sort()
        acc = 0.0
        for hi, _, node, c in items:
            acc += c
            if acc >= target:
                return float(hi)
        return float(items[-1][0]) if items else 0.0

    def memory_words(self) -> int:
        """QuantileEstimator protocol: 2 words per occupied bucket."""
        return 2 * len(self.counts)
