"""repro_torch.api — the fleet API of the port.

  spec.py       — FleetSpec (static fleet description, single placement;
                  ``backend`` picks the ingest engine, BACKENDS) and
                  StreamCursor (seed, t_offset scalar or per lane,
                  g_offset).
  fleet.py      — QuantileFleet: create / ingest / ingest_stream /
                  tick_lanes / tick_lanes_sparse / grow_groups / estimate /
                  health / check_health / checkpoint / restore over a
                  (G × Q) lane plane, and from_jax_state, which continues
                  a JAX package fleet in the port.
  estimators.py — FrugalEstimator: frugal lanes behind the baselines'
                  QuantileEstimator protocol (one comparison loop).
  lint.py       — public-API export lint and the lane-program registry
                  check (``python -m repro_torch.api.lint``).
"""
from repro_torch.core.baselines.protocol import QuantileEstimator
from repro_torch.core.drift import DriftConfig
from repro_torch.core.program import (LaneProgram, StateLayout, make_program,
                                      registered_families)

from .spec import BACKENDS, FleetSpec, StreamCursor
from .fleet import QuantileFleet, from_jax_state
from .estimators import FrugalEstimator
from .lint import check_programs, check_public_api

__all__ = [
    "BACKENDS",
    "DriftConfig",
    "LaneProgram",
    "StateLayout",
    "make_program",
    "registered_families",
    "FleetSpec",
    "StreamCursor",
    "QuantileFleet",
    "QuantileEstimator",
    "FrugalEstimator",
    "check_programs",
    "check_public_api",
    "from_jax_state",
]
