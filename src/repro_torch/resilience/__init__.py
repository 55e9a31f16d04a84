"""Resilience of the port: deterministic fault injection and lane health.

  chaos  — seeded FaultPlan and the injection hooks that streaming ingest
           and the checkpoint protocol call (no-ops unless a plan is
           armed);
  health — StateLayout-derived lane invariant validation and self-healing
           (QuantileFleet.health()/check_health() under FleetSpec.health).

chaos binds first: core/streaming.py imports it while this package may
still be initialising.
"""
from . import chaos
from . import health
from .chaos import (CheckpointKilled, Fault, FaultPlan, QueryStalled,
                    StreamFault, StreamInterrupted)
from .health import (HEALTH_POLICIES, HealthReport, LaneCorruptionError,
                     heal_planes, validate_planes)

__all__ = [
    "chaos", "health",
    "Fault", "FaultPlan", "StreamFault", "StreamInterrupted",
    "CheckpointKilled", "QueryStalled",
    "HEALTH_POLICIES", "HealthReport", "LaneCorruptionError",
    "validate_planes", "heal_planes",
]
