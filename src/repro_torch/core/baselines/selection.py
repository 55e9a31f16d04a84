"""Guha-McGregor single-pass selection for random-order streams (paper §6.3).

Phases of sample / estimate / update over an interval (a, b) enclosing the
target quantile. The paper evaluates the unknown-n variant: the stream is
chopped into sub-streams of exponentially increasing length (one extra word
for the iteration counter), each running one full phase. State: a, b, u,
rank counter (+ iteration) — constant memory, but ~5 words vs frugal's 1-2.

delta = 0.99 per the paper's experimental setup.
"""
from __future__ import annotations

import math
import random
from typing import Optional


class Selection:
    def __init__(self, quantile: float = 0.5, base_len: int = 256, seed: int = 0,
                 delta: float = 0.99):
        self.q = quantile
        self.delta = delta
        self.a = -math.inf
        self.b = math.inf
        self.u: Optional[float] = None
        self.rng = random.Random(seed)
        # phase machinery
        self.iteration = 0
        self.phase_len = base_len
        self.pos_in_phase = 0
        # sample sub-phase reservoir
        self._cand: Optional[float] = None
        self._cand_seen = 0
        # estimate sub-phase counters
        self._less = 0
        self._total = 0
        self.n = 0

    def insert(self, v: float) -> None:
        self.n += 1
        half = self.phase_len // 2
        if self.pos_in_phase < half:
            # ---- sample sub-phase: reservoir-sample one item inside (a, b)
            if self.a < v < self.b:
                self._cand_seen += 1
                if self.rng.random() < 1.0 / self._cand_seen:
                    self._cand = v
        else:
            # ---- estimate sub-phase: estimate rank of candidate u
            u = self._cand if self._cand is not None else self.u
            if u is not None:
                self._total += 1
                if v < u:
                    self._less += 1
        self.pos_in_phase += 1
        if self.pos_in_phase >= self.phase_len:
            self._finish_phase()

    def extend(self, values) -> None:
        for v in values:
            self.insert(float(v))

    def _finish_phase(self) -> None:
        u = self._cand if self._cand is not None else self.u
        if u is not None and self._total > 0:
            est_rank = self._less / self._total
            if est_rank < self.q:
                self.a = u
            else:
                self.b = u
            self.u = u
        # next phase: exponentially longer (unknown-n variant)
        self.iteration += 1
        self.phase_len *= 2
        self.pos_in_phase = 0
        self._cand = None
        self._cand_seen = 0
        self._less = 0
        self._total = 0

    def query(self, q: float = None) -> float:
        del q
        if self.u is not None:
            return self.u
        if self._cand is not None:
            return self._cand
        return 0.0

    def memory_words(self) -> int:
        """QuantileEstimator protocol: (a, b, counters) — constant words."""
        return 5
