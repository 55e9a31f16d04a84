"""FrugalEstimator — a frugal sketch behind the QuantileEstimator protocol.

Benchmark harnesses compare frugal against GK / q-digest / Selection; the
baselines are sequential Python structures with ``insert/extend/query/
memory_words`` (``core.baselines.protocol``). This adapter gives a frugal
lane plane the same face, so one loop drives every algorithm.

Unlike GK (any q at query time), a frugal sketch streams toward fixed
targets, so the targets are named at construction, one lane each, and
``query`` answers only those. Items buffer on the host and go in as one
[n, 1] block through a G = 1 ``QuantileFleet`` at each query; two
estimators with the same seed and targets replay each other bit for bit.

The port's default engine is "fused" (the dense kernel on the card; the
JAX package's default is "jnp"): both give the same bits, and the plain
loop would otherwise sit on the evaluation path wherever a card is.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .fleet import QuantileFleet
from .spec import FleetSpec


class FrugalEstimator:
    """One group's frugal quantile lanes behind insert/extend/query."""

    def __init__(self, quantiles: Sequence[float] = (0.5,), algo: str = "2u",
                 seed: int = 0, backend: str = "fused", device=None):
        self._fleet = QuantileFleet.create(
            FleetSpec(num_groups=1, quantiles=tuple(quantiles), algo=algo,
                      backend=backend), seed=seed, device=device)
        self._buf: List[float] = []

    # ------------------------------------------------------------- streaming
    def insert(self, v: float) -> None:
        self._buf.append(float(v))

    def extend(self, values) -> None:
        self._buf.extend(float(v) for v in values)

    def _flush(self) -> None:
        if self._buf:
            items = np.asarray(self._buf, np.float32)[:, None]
            self._buf = []
            self._fleet = self._fleet.ingest(items)

    # ----------------------------------------------------------------- reads
    def query(self, q: float) -> float:
        """Estimate of tracked target ``q`` (ValueError for an untracked
        one: frugal lanes answer the quantiles they streamed for)."""
        self._flush()
        qs = self._fleet.spec.quantiles
        if float(q) not in qs:
            raise ValueError(f"quantile {q} not tracked; lanes hold {qs}")
        return float(self._fleet.estimate(quantile=float(q))[0])

    def memory_words(self) -> int:
        """1-2 words per tracked quantile — the paper's claim, per lane."""
        return self._fleet.memory_words() * self._fleet.num_lanes

    @property
    def quantiles(self):
        return self._fleet.spec.quantiles
