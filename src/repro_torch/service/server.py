"""StreamingService — concurrent ingest + snapshot queries over one fleet.

Port of the JAX package's ``service/server.py``: a background ingest
thread drives the put-ahead ``IngestPipeline`` into a ``QuantileFleet``
and PUBLISHES each new fleet version under a lock, while any number of
query callers pin the current version (one lock read), ``Snapshot.
capture`` host copies of the query planes, and answer. Readers never
block ingest, ingest never blocks readers, and every answer is
bit-reproducible offline from its cursor.

Per-tenant DP gating routes through the ``2u-dp`` program's
``run_query``: a ``TenantPolicy(trusted=True)`` reads the program's own
release; an untrusted tenant's answer is output-perturbed at the
tenant's epsilon (``Snapshot.estimate_dp``), deterministic at a cursor, so
even noised answers audit bit-exact against replay.

Threading (CPython): the ingest thread waits for each chunk's apply on a
CUDA event, which releases the GIL, and a query's device-to-host copy
and its host-side ``run_query`` run meanwhile; the only shared mutable
state is the fleet reference + counters, each behind its own lock.
Ingest errors are captured and re-raised at ``join()``: a dying source
never deadlocks a reader.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from repro_torch.api.fleet import QuantileFleet
from repro_torch.api.spec import FleetSpec

from .pipeline import IngestPipeline
from .snapshot import Snapshot
from .telemetry import QUERIES_SERVED, Telemetry


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """What one tenant may see. Trusted tenants read the program's own
    release; untrusted tenants get the DP output-perturbation release at
    ``epsilon`` (smaller = noisier = more private)."""

    name: str
    trusted: bool = False
    epsilon: float = 1.0

    def __post_init__(self):
        if not self.trusted and not (self.epsilon > 0):
            raise ValueError(
                f"tenant {self.name!r}: untrusted reads need epsilon > 0")


# The implicit operator tenant every service has.
INTERNAL = TenantPolicy(name="internal", trusted=True)


class StreamingService:
    """Ingest/query front-end over one QuantileFleet.

    Synchronous use:  ``ingest(chunk)`` / ``query()`` from one thread.
    Concurrent use:   ``start(chunks)`` spawns the ingest thread;
                      ``query()`` from any thread; ``join()`` waits and
                      re-raises ingest errors.

    ``spec=`` creates the fleet on ``device`` (None: the card; raises
    where there is none); ``fleet=`` serves a fleet on its own device.
    The default telemetry's latency fleet sits on the fleet's device.
    """

    def __init__(self, spec: Optional[FleetSpec] = None, *,
                 fleet: Optional[QuantileFleet] = None, seed: int = 0,
                 tenants: Sequence[TenantPolicy] = (),
                 telemetry: Optional[Telemetry] = None,
                 prefetch_depth: int = 1, device=None):
        if (spec is None) == (fleet is None):
            raise ValueError("pass exactly one of spec= or fleet=")
        if fleet is None:
            fleet = QuantileFleet.create(spec, seed=int(seed), device=device)
        elif device is not None:
            raise ValueError("device= goes with spec=; a fleet= is served "
                             "on its own device")
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry(device=fleet.device)
        self._fleet_lock = threading.Lock()
        self._fleet = fleet
        self._tenants: Dict[str, TenantPolicy] = {INTERNAL.name: INTERNAL}
        for t in tenants:
            self._tenants[t.name] = t
        self.pipeline = IngestPipeline(depth=int(prefetch_depth),
                                       telemetry=self.telemetry)
        self._thread: Optional[threading.Thread] = None
        self._ingest_error: Optional[BaseException] = None

    # ------------------------------------------------------------- versions
    @property
    def fleet(self) -> QuantileFleet:
        """The current published fleet version (lock-protected read)."""
        with self._fleet_lock:
            return self._fleet

    def _publish(self, fleet: QuantileFleet, n_items: int) -> None:
        with self._fleet_lock:
            self._fleet = fleet

    # --------------------------------------------------------------- ingest
    def ingest(self, chunk) -> None:
        """Apply one [t, G] chunk synchronously and publish the result."""
        self.pipeline.run(self.fleet, [chunk], on_chunk=self._publish)

    def ingest_stream(self, chunks: Iterable) -> None:
        """Drive a whole chunk stream synchronously (publishes per
        chunk)."""
        self.pipeline.run(self.fleet, chunks, on_chunk=self._publish)

    def start(self, chunks: Iterable) -> None:
        """Spawn the background ingest thread over ``chunks``. One stream
        at a time; ``join()`` collects it."""
        if self._thread is not None:
            raise RuntimeError("ingest already running; join() it first")
        self._ingest_error = None

        def run():
            try:
                self.pipeline.run(self.fleet, chunks,
                                  on_chunk=self._publish)
            except BaseException as e:  # noqa: BLE001 — re-raised at join()
                self._ingest_error = e

        self._thread = threading.Thread(target=run, name="service-ingest",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the ingest thread; re-raise any error it captured."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError("ingest thread still running")
            self._thread = None
        if self._ingest_error is not None:
            err, self._ingest_error = self._ingest_error, None
            raise err

    @property
    def ingest_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # --------------------------------------------------------------- queries
    def register_tenant(self, policy: TenantPolicy) -> None:
        self._tenants[policy.name] = policy

    def snapshot(self) -> Snapshot:
        """Pin the current fleet version and capture a consistent read."""
        return Snapshot.capture(self.fleet, telemetry=self.telemetry)

    def query(self, tenant: str = INTERNAL.name,
              quantile: Optional[float] = None) -> np.ndarray:
        """Answer one quantile read for ``tenant`` from a fresh snapshot:
        [G, Q] (or ``quantile=``'s [G] column), DP-gated by the tenant's
        policy. Raises KeyError for an unregistered tenant: an unknown
        reader must never see even a noised release."""
        policy = self._tenants[tenant]
        t0 = time.perf_counter()
        snap = self.snapshot()
        if policy.trusted:
            out = snap.estimate(quantile)
        else:
            out = snap.estimate_dp(policy.epsilon, quantile)
        self.telemetry.observe_ms("query_ms",
                                  (time.perf_counter() - t0) * 1e3)
        self.telemetry.count(QUERIES_SERVED)
        return out

    # ---------------------------------------------------------------- health
    def check_health(self):
        """Run the fleet's lane-health policy on the CURRENT version and
        publish the (possibly quarantine-healed) result. Safe between
        chunks; concurrent with ingest it may lose the race to the next
        publish, so call it from the ingest thread's on_chunk cadence (or
        quiesce) for a guaranteed apply."""
        fleet, rep = self.fleet.check_health()
        self._publish(fleet, 0)
        if rep.quarantined:
            self.telemetry.count("quarantined_lanes", rep.quarantined)
        return rep

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, object]:
        """Coherent observability readout (counters, gauges, latency
        quantiles from the frugal histogram lanes)."""
        return self.telemetry.snapshot()
