"""k-item reservoir sampling baseline (not in the paper's comparison set, but
the natural 'what k words buys you' control for EXPERIMENTS.md)."""
from __future__ import annotations

import random
from typing import List


class Reservoir:
    def __init__(self, k: int = 20, seed: int = 0):
        self.k = k
        self.n = 0
        self.sample: List[float] = []
        self.rng = random.Random(seed)

    def insert(self, v: float) -> None:
        self.n += 1
        if len(self.sample) < self.k:
            self.sample.append(v)
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.sample[j] = v

    def extend(self, values) -> None:
        for v in values:
            self.insert(float(v))

    def query(self, q: float) -> float:
        if not self.sample:
            return 0.0
        s = sorted(self.sample)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    def memory_words(self) -> int:
        """QuantileEstimator protocol: one word per reservoir slot."""
        return len(self.sample)
