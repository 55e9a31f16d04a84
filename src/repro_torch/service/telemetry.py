"""Service observability: monotonic counters, gauges, and latency
histograms tracked by a frugal fleet on its OWN metrics.

Port of the JAX package's ``service/telemetry.py``. The counters are
plain thread-safe dict increments (ingest and query threads both write
them); per-metric p50/p99 latencies come from a tiny scalar-clock
``repro_torch.api.QuantileFleet`` on ``device`` (one group per latency
metric, quantile lanes (0.5, 0.99)) fed NaN-padded [rounds, metrics]
blocks, NaN being the bit-exact no-op padding. On the card each flush is
one launch of the dense kernel, bit-exact with the JAX package's scan.

Determinism: a latency lane's trajectory is a pure function of the
sequence of (flush boundary, observed values), since the counter RNG
keys each round on the fleet cursor's absolute tick; replaying the same
observations through the same flush pattern replays the same histogram,
in either package.

``runtime_metadata()`` is the run-record stamp (wall-clock, device count,
backend, versions).
"""
from __future__ import annotations

import os
import platform as _platform
import threading
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.fleet import QuantileFleet
from repro_torch.api.spec import FleetSpec

# Canonical counter names the service increments; callers may add their own.
ITEMS_INGESTED = "items_ingested"
CHUNKS_INGESTED = "chunks_ingested"
CHUNKS_IN_FLIGHT = "chunks_in_flight"          # gauge
QUERIES_SERVED = "queries_served"
QUERIES_STALLED = "queries_stalled"
QUARANTINED_LANES = "quarantined_lanes"

DEFAULT_LATENCY_METRICS: Tuple[str, ...] = ("ingest_chunk_ms", "query_ms")
LATENCY_QUANTILES: Tuple[float, ...] = (0.5, 0.99)


class Telemetry:
    """Thread-safe counters + gauges + frugal latency histograms.

    One instance is shared by a service's ingest thread, its query
    callers, and (duck-typed, via ``telemetry=``) serve.SLOFleet: anything
    with ``count(name, n)`` fits that slot, so serve never imports this
    package. The histogram fleet lives on ``device`` (None: the card;
    raises where there is none).
    """

    def __init__(self, metrics: Sequence[str] = DEFAULT_LATENCY_METRICS,
                 seed: int = 0, device=None):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._metrics = tuple(str(m) for m in metrics)
        if len(set(self._metrics)) != len(self._metrics):
            raise ValueError(f"duplicate latency metrics in {metrics}")
        self._metric_idx = {m: i for i, m in enumerate(self._metrics)}
        self._pending: Dict[str, list] = {m: [] for m in self._metrics}
        # One group per metric, a (p50, p99) quantile lane pair each.
        self._fleet = QuantileFleet.create(
            FleetSpec(num_groups=max(1, len(self._metrics)),
                      quantiles=LATENCY_QUANTILES),
            seed=int(seed), device=device)

    # -------------------------------------------------------------- counters
    def count(self, name: str, n: int = 1) -> None:
        """Monotonically bump counter ``name`` by ``n`` (n >= 0)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"counters are monotonic; count({name!r}, {n})")
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` (point-in-time value, e.g. chunks in
        flight)."""
        with self._lock:
            self._gauges[name] = float(value)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    # ------------------------------------------------------------- latencies
    def observe_ms(self, metric: str, ms: float) -> None:
        """Buffer one latency observation (host-side, no device work)."""
        if metric not in self._metric_idx:
            raise KeyError(f"unknown latency metric {metric!r}; have "
                           f"{self._metrics}")
        with self._lock:
            self._pending[metric].append(float(ms))

    def _flush_locked(self) -> None:
        rounds = max((len(v) for v in self._pending.values()), default=0)
        if rounds == 0:
            return
        g = self._fleet.num_groups
        block = np.full((rounds, g), np.nan, np.float32)
        for m, gi in self._metric_idx.items():
            vals = self._pending[m]
            if vals:
                block[:len(vals), gi] = np.asarray(vals, np.float32)
            self._pending[m] = []
        self._fleet = self._fleet.ingest(block)

    def flush(self) -> None:
        """Apply buffered observations as one NaN-padded block ingest."""
        with self._lock:
            self._flush_locked()

    def latency_quantiles(self) -> Dict[str, Dict[str, float]]:
        """{metric: {"p50": ..., "p99": ...}} from the frugal lanes."""
        with self._lock:
            self._flush_locked()
            plane = self._fleet.estimate()       # [metrics, 2]
        return {m: {"p50": float(plane[gi, 0]), "p99": float(plane[gi, 1])}
                for m, gi in self._metric_idx.items()}

    # --------------------------------------------------------------- readout
    def snapshot(self) -> Dict[str, object]:
        """One coherent observability readout (counters + gauges +
        latency quantiles): what the server exposes."""
        return {
            "counters": self.counters(),
            "gauges": self.gauges(),
            "latency_ms": self.latency_quantiles(),
        }


def runtime_metadata() -> Dict[str, object]:
    """Self-describing run-record stamp: wall-clock, device count, backend,
    versions. The keys are the JAX package's, with ``torch_version`` in
    place of ``jax_version``; the backend is "cuda" where a card is
    present (``device_count`` cards), else "cpu" (one device, the
    host)."""
    cuda = torch.cuda.is_available()
    return {
        "unix_time": float(time.time()),
        "wall_clock_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "device_count": int(torch.cuda.device_count()) if cuda else 1,
        "backend": "cuda" if cuda else "cpu",
        "torch_version": str(torch.__version__),
        "python_version": _platform.python_version(),
        "cpu_count": int(os.cpu_count() or 1),
    }
