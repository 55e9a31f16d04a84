"""repro_torch.api — the fleet API of the port.

  spec.py  — FleetSpec (static fleet description, single placement) and
             StreamCursor (seed, t_offset scalar or per lane, g_offset).
  fleet.py — QuantileFleet: create / ingest / ingest_stream / tick_lanes /
             tick_lanes_sparse / grow_groups / estimate / health /
             check_health / checkpoint / restore over a (G × Q) lane
             plane, and from_jax_state, which continues a JAX package
             fleet in the port.
"""
from repro_torch.core.drift import DriftConfig
from repro_torch.core.program import (LaneProgram, StateLayout, make_program,
                                      registered_families)

from .fleet import QuantileFleet, from_jax_state
from .spec import FleetSpec, StreamCursor

__all__ = [
    "DriftConfig",
    "LaneProgram",
    "StateLayout",
    "make_program",
    "registered_families",
    "FleetSpec",
    "StreamCursor",
    "QuantileFleet",
    "from_jax_state",
]
