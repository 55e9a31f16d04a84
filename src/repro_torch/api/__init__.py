"""repro_torch.api — the fleet API of the port.

  spec.py       — FleetSpec (static fleet description: ``backend`` picks
                  the ingest engine, BACKENDS; ``topology=TopologySpec(
                  data=..., lanes=..., devices=...)`` the placement, with
                  the deprecated backend="sharded" spelling mapped on)
                  and StreamCursor (seed, t_offset scalar or per lane,
                  g_offset).
  fleet.py      — QuantileFleet: create / ingest / ingest_stream /
                  tick_lanes / tick_lanes_sparse / grow_groups / sync /
                  reshard / estimate / health / check_health / checkpoint /
                  restore over a (G × Q) lane plane on any placement, and
                  from_jax_state, which continues a JAX package fleet in
                  the port.
  estimators.py — FrugalEstimator: frugal lanes behind the baselines'
                  QuantileEstimator protocol (one comparison loop).
  lint.py       — public-API export lint, the lane-program registry
                  check and the deprecated-placement-spelling source scan
                  (``python -m repro_torch.api.lint``).
"""
from repro_torch.core.baselines.protocol import QuantileEstimator
from repro_torch.core.drift import DriftConfig
from repro_torch.core.program import (LaneProgram, StateLayout, make_program,
                                      registered_families)
from repro_torch.parallel.topology import TopologySpec

from .spec import BACKENDS, FleetSpec, StreamCursor
from .fleet import QuantileFleet, from_jax_state
from .estimators import FrugalEstimator
from .lint import check_programs, check_public_api, check_topology_spellings

__all__ = [
    "BACKENDS",
    "DriftConfig",
    "LaneProgram",
    "StateLayout",
    "make_program",
    "registered_families",
    "TopologySpec",
    "FleetSpec",
    "StreamCursor",
    "QuantileFleet",
    "QuantileEstimator",
    "FrugalEstimator",
    "check_programs",
    "check_public_api",
    "check_topology_spellings",
    "from_jax_state",
]
