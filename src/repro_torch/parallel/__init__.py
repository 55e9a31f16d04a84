"""Placement across devices: the declarative topology, lane-sharded
fleets and 2-D (data × lane) fleets with the pinned replica merge (port of
the JAX package's ``parallel/``)."""

from .topology import (
    DATA_AXIS,
    LANE_AXIS,
    TopologySpec,
)
from .mesh2d import (
    Mesh2DFleet,
    merge_replica_planes,
)
from .group_sharding import (
    GROUP_AXIS,
    ShardedGroupFleet,
    group_mesh,
)

__all__ = [
    "DATA_AXIS",
    "LANE_AXIS",
    "TopologySpec",
    "Mesh2DFleet",
    "merge_replica_planes",
    "GROUP_AXIS",
    "ShardedGroupFleet",
    "group_mesh",
]
