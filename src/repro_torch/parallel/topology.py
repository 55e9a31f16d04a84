"""TopologySpec — the declarative (data × lane) placement of a fleet.

Port of the JAX package's ``parallel/topology.py``:

    TopologySpec()                       # one device (the default)
    TopologySpec(lanes=8)                # the lane axis split over 8 devices
    TopologySpec(data=2, lanes=4)        # 2 stream replicas × 4 lane shards
    TopologySpec(data=2, lanes=4,
                 devices=("cuda:0",) * 8)  # an explicit device tuple

Axes:
  * ``lanes`` — shards of the flattened (G × Q) lane axis. Shards share
    nothing: ingest needs no collective.
  * ``data``  — stream replicas of the same lanes, each fed a disjoint
    share of the stream's chunks, merged by the pinned rule of
    ``parallel.mesh2d``.

Devices are ``torch.device``s. The port's "mesh" is a numpy object array
of them, shaped ``(lanes,)`` (``mesh1d``) or ``(data, lanes)``
(``mesh2d``). An explicit tuple may name one device more than once: the
port's counterpart of a forced host device count, which drives the
per-device execution on one card or on the CPU. ``devices=None`` resolves
against the visible CUDA devices: a 1-D topology with too few raises, a
2-D one falls back to the sequential replica loop (the same bits).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
LANE_AXIS = "groups"

PLACEMENTS = ("single", "sharded", "mesh2d")


def _device_array(devices, shape) -> np.ndarray:
    out = np.empty(len(devices), dtype=object)
    out[:] = list(devices)
    return out.reshape(shape)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Declarative (data × lane) placement for a fleet.

    data    — stream replicas along the data axis. 1 = no data axis.
    lanes   — lane-axis shards. 1 = lanes unsharded.
    devices — None (resolve against the visible CUDA devices), an int
              (that many of them), or an explicit tuple of ``data ×
              lanes`` devices, replica-major (device ``r·lanes + s`` holds
              replica r's lane shard s).

    Frozen and hashable: it rides as static metadata on FleetSpec.
    """

    data: int = 1
    lanes: int = 1
    devices: Optional[Tuple] = None

    def __post_init__(self):
        data = int(self.data)
        lanes = int(self.lanes)
        if data < 1 or lanes < 1:
            raise ValueError(
                f"TopologySpec axes must be >= 1, got data={self.data} "
                f"lanes={self.lanes}")
        object.__setattr__(self, "data", data)
        object.__setattr__(self, "lanes", lanes)
        devs = self.devices
        if devs is not None and not isinstance(devs, (int, np.integer)):
            devs = tuple(torch.device(d) for d in devs)
            if len(devs) != data * lanes:
                raise ValueError(
                    f"TopologySpec(data={data}, lanes={lanes}) needs "
                    f"{data * lanes} devices, got {len(devs)} explicitly")
            object.__setattr__(self, "devices", devs)

    # ------------------------------------------------------------- placement
    @property
    def placement(self) -> str:
        """'single' | 'sharded' (1-D lane mesh) | 'mesh2d' (data × lane)."""
        if self.data > 1:
            return "mesh2d"
        return "sharded" if self.lanes > 1 else "single"

    @property
    def num_devices(self) -> int:
        return self.data * self.lanes

    def describe(self) -> dict:
        """JSON-able stanza (checkpoint manifests, service stats)."""
        return {"data": self.data, "lanes": self.lanes,
                "placement": self.placement}

    # ------------------------------------------------------------ resolution
    def resolve(self) -> "TopologySpec":
        """Pin ``devices`` to a concrete tuple (or None).

        single   — devices forced to None (nothing to place).
        sharded  — exactly ``lanes`` devices, the first visible CUDA
                   devices when unspecified; too few raises.
        mesh2d   — ``data · lanes`` devices when that many are visible;
                   otherwise, with none given explicitly, devices stays
                   None and the fleet runs the sequential replica loop.
        """
        if self.placement == "single":
            return self if self.devices is None else \
                dataclasses.replace(self, devices=None)
        need = self.num_devices
        devs = self.devices
        if isinstance(devs, (int, np.integer)):
            if int(devs) != need:
                raise ValueError(
                    f"TopologySpec(data={self.data}, lanes={self.lanes}) "
                    f"needs {need} devices, got devices={devs}")
            devs = None
        if devs is not None:
            return self
        avail = torch.cuda.device_count()
        if avail < need:
            if self.placement == "sharded":
                raise ValueError(
                    f"TopologySpec(lanes={self.lanes}) needs {need} "
                    f"devices, found {avail} CUDA device(s); name them "
                    "explicitly with devices=")
            return dataclasses.replace(self, devices=None)  # loop fallback
        return dataclasses.replace(
            self, devices=tuple(torch.device("cuda", i) for i in range(need)))

    @property
    def on_devices(self) -> bool:
        """True when a resolved non-single topology holds a device tuple
        (per-device execution); False = the sequential replica loop."""
        return isinstance(self.devices, tuple)

    # ----------------------------------------------------------------- meshes
    def mesh1d(self) -> np.ndarray:
        """The 1-D lane mesh (placement 'sharded'): [lanes] devices."""
        if self.placement != "sharded":
            raise ValueError(f"mesh1d() on a {self.placement} topology")
        return _device_array(self.resolve().devices, (self.lanes,))

    def mesh2d(self) -> np.ndarray:
        """The 2-D mesh (placement 'mesh2d', device-resolved): [data,
        lanes] devices."""
        if self.placement != "mesh2d":
            raise ValueError(f"mesh2d() on a {self.placement} topology")
        t = self.resolve()
        if not t.on_devices:
            raise ValueError(
                f"TopologySpec(data={self.data}, lanes={self.lanes}) is in "
                f"loop-fallback mode ({torch.cuda.device_count()} CUDA "
                "device(s) visible) — no device mesh to build")
        return _device_array(t.devices, (self.data, self.lanes))

    # --------------------------------------------------------------- mappers
    @staticmethod
    def single() -> "TopologySpec":
        return TopologySpec()

    @staticmethod
    def from_mesh(mesh) -> "TopologySpec":
        """Map a legacy 1-D ``mesh=`` (a device sequence or array; None =
        every visible CUDA device) onto a spec — the FleetSpec
        deprecation shim's half of 'equal specs'."""
        if mesh is None:
            return TopologySpec(lanes=torch.cuda.device_count())
        devs = tuple(np.asarray(mesh, dtype=object).reshape(-1))
        return TopologySpec(lanes=len(devs), devices=devs)


__all__ = ["DATA_AXIS", "LANE_AXIS", "PLACEMENTS", "TopologySpec"]
