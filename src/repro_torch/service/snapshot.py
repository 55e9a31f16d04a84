"""Consistent copy-on-query reads: a ``Snapshot`` pins one fleet version.

Port of the JAX package's ``service/snapshot.py``. The snapshot protocol
is the service's whole consistency story:

  1. The server publishes a NEW ``QuantileFleet`` object per applied chunk
     (functional ingest: the previous version is never mutated), swapping
     one reference under a lock.
  2. A reader pins the current reference (one lock-protected read), then
     gathers HOST COPIES of only the program's ``layout.query_fields``
     planes plus the cursor: ``QuantileFleet.query_view()``. Readers never
     block ingest beyond that reference swap, and ingest never blocks
     readers.
  3. Because the copies are real numpy arrays, a snapshot survives the
     producer moving on, including ``tick_lanes_sparse(donate=True)``
     rounds that overwrite the old device tensors IN PLACE.

Every answer is bit-reproducible offline: ``(m_planes, t_next, seed,
lanes)`` fully determine ``program.run_query``, including the ``2u-dp``
program's Laplace noise (keyed on ``(seed ^ salt, t_next, lane)``, drawn
on the host in numpy float64), so a served answer can be audited against
a single-threaded replay of the same cursor, in either package.

``chaos.on_query_event()`` fires mid-capture (fault kind
``query_stall``): a reader dying between pinning the fleet version and
finishing the gather must leave ingest untouched, and the retried capture
must answer bit-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.api.fleet import QuantileFleet
from repro_torch.core.program import LaneProgram, make_program
from repro_torch.resilience import chaos


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable, host-owned view of one fleet version at one cursor.

    Holds only the query planes (1-2 words per lane: a windowed program's
    two m planes at most) plus the cursor scalars; never step/sign words,
    never device tensors.
    """

    program: LaneProgram
    num_groups: int
    num_quantiles: int
    quantiles: Tuple[float, ...]
    m_planes: Tuple[np.ndarray, ...]
    t_next: np.ndarray            # scalar () or per-lane [L] int32
    seed: int
    lanes: np.ndarray             # absolute lane ids [L]

    @classmethod
    def capture(cls, fleet: QuantileFleet,
                telemetry=None) -> "Snapshot":
        """Copy-on-query capture of ``fleet`` (the caller has already
        pinned which version). ``telemetry`` (optional, duck-typed
        ``.count``) records stall counts; the server times the full query
        round-trip itself."""
        try:
            # The worst place for a reader to die: version pinned, gather
            # not yet done. chaos injects QueryStalled here.
            chaos.on_query_event()
            m_planes, t_next, seed, lanes = fleet.query_view()
        except chaos.QueryStalled:
            if telemetry is not None:
                telemetry.count("queries_stalled")
            raise
        return cls(program=fleet.spec.program,
                   num_groups=fleet.num_groups,
                   num_quantiles=fleet.num_quantiles,
                   quantiles=fleet.spec.quantiles,
                   m_planes=m_planes, t_next=t_next, seed=seed, lanes=lanes)

    # ------------------------------------------------------------------ reads
    @property
    def items_ingested(self) -> int:
        """Items behind this snapshot (scalar-clock fleets): the replay key
        an offline auditor feeds the same stream up to."""
        t = np.asarray(self.t_next)
        if t.ndim != 0:
            raise ValueError("per-lane clock snapshot has no single item "
                             "count; read t_next directly")
        return int(t)

    def _released(self, program: LaneProgram) -> np.ndarray:
        return np.asarray(program.run_query(
            self.m_planes, t_next=self.t_next, seed=self.seed,
            lanes=self.lanes))

    def _shaped(self, flat, quantile) -> np.ndarray:
        plane = np.asarray(flat).reshape(self.num_groups, self.num_quantiles)
        if quantile is None:
            return plane
        return plane[:, self.quantiles.index(float(quantile))]

    def estimate(self, quantile: Optional[float] = None) -> np.ndarray:
        """[G, Q] estimates via the program's own query (the trusted read:
        for a ``2u-dp`` program this is already the noised release); with
        ``quantile=`` one tracked target's [G] column."""
        return self._shaped(self._released(self.program), quantile)

    def estimate_dp(self, epsilon: float,
                    quantile: Optional[float] = None) -> np.ndarray:
        """DP-gated release for untrusted tenants: the program's answer
        passed through the ``2u-dp`` output-perturbation query at
        ``epsilon``, Laplace noise keyed on ``(seed ^ salt, t_next,
        lane)``, so the release is deterministic at a cursor (same
        snapshot, same tenant question, same noised answer: replayable
        for audit).

        A fleet already running ``2u-dp`` releases through its OWN
        calibrated noise; stacking a second draw would double-spend the
        budget."""
        if self.program.family == "2u-dp":
            return self.estimate(quantile)
        base = self._released(self.program)
        dp = make_program("2u-dp", epsilon=float(epsilon))
        return self._shaped(dp.run_query(
            (base,), t_next=self.t_next, seed=self.seed, lanes=self.lanes),
            quantile)
