"""FleetSpec and StreamCursor — the configuration and stream position of a
``QuantileFleet`` (port of the JAX package's ``api/spec.py``)."""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import rng as crng
from repro_torch.core.drift import DriftConfig
from repro_torch.core.program import LaneProgram, make_program, program_for
from repro_torch.parallel.topology import TopologySpec
from repro_torch.resilience.health import HEALTH_POLICIES

# User-spellable backends. "jnp" and "fused" are engines of the single
# placement; "sharded" survives only as the deprecated placement spelling,
# mapped onto topology= with a DeprecationWarning; "mesh2d" is derived only
# (spell it as topology=TopologySpec(data=...)).
BACKENDS = ("jnp", "fused", "sharded")


class StreamCursor(NamedTuple):
    """Absolute position of a fleet in its uniform stream.

    seed     — counter-RNG seed (int32).
    t_offset — absolute stream tick of the next item (int32-wrapped): a
               Python int, or for an event-stream fleet a per-lane [L]
               int32 tensor on the fleet's device.
    g_offset — absolute lane id of this fleet's lane 0.

    ``create``, ``advance`` and ``advance_lanes`` wrap like the kernel's
    int32 tick counter (two's complement), so advancing past 2^31 ticks
    stays bit-consistent with unbounded ingestion.
    """

    seed: int
    t_offset: Union[int, torch.Tensor]
    g_offset: int

    @staticmethod
    def create(seed=0, t_offset=0, g_offset=0, key=None) -> "StreamCursor":
        """A cursor from an int seed or uint32 key words (``key``). Fields
        may be ints or 0-d integer tensors; a 1-d ``t_offset`` (tensor or
        numpy) becomes the per-lane int32 clock, kept on its device."""
        if key is not None:
            seed = crng.seed_from_key(key)
        if isinstance(t_offset, np.ndarray):
            t_offset = torch.from_numpy(t_offset.astype(np.int32))
        if isinstance(t_offset, torch.Tensor) and t_offset.dim() > 0:
            if t_offset.dim() != 1 or t_offset.dtype.is_floating_point:
                raise ValueError(f"a per-lane t_offset must be [L] int32, "
                                 f"got {tuple(t_offset.shape)} "
                                 f"{t_offset.dtype}")
            t_offset = t_offset.to(torch.int32).contiguous()
        else:
            t_offset = crng.wrap_i32(int(t_offset))
        return StreamCursor(seed=crng.wrap_i32(int(seed)), t_offset=t_offset,
                            g_offset=crng.wrap_i32(int(g_offset)))

    @property
    def per_lane(self) -> bool:
        """True when t_offset is a per-lane tick vector (event streams)."""
        return isinstance(self.t_offset, torch.Tensor)

    def advance(self, ticks: int) -> "StreamCursor":
        """Cursor after ``ticks`` more stream items (every lane's clock)."""
        if self.per_lane:
            return self._replace(
                t_offset=self.t_offset + crng.wrap_i32(int(ticks)))
        return self._replace(
            t_offset=crng.wrap_i32(self.t_offset + int(ticks)))

    def advance_lanes(self, mask) -> "StreamCursor":
        """Cursor after one event round: lanes with mask 1 consumed a
        uniform, lanes with mask 0 did not (per-lane clock). Returns a new
        clock tensor; the old one is untouched."""
        if not self.per_lane:
            raise ValueError("advance_lanes needs a per-lane cursor")
        mask = torch.as_tensor(mask, device=self.t_offset.device)
        return self._replace(t_offset=self.t_offset + mask.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Static description of a QuantileFleet.

    num_groups — G, independent streams (the paper's GROUPBY keys).
    quantiles  — targets per group; the fleet lays out a (G × Q) lane
                 plane, lane = g·Q + qi.
    algo       — "1u" (paper Alg. 2) or "2u" (paper Alg. 3).
    backend    — the ingest engine of the single placement: "fused"
                 (chunked dense-kernel calls, ``core.streaming``: the CUDA
                 kernel on the card) or "jnp" (the plain PyTorch loop,
                 ``core.frugal.program_process_seeded``, on the fleet's
                 device). Both give the same bits. Meshed placements run
                 the chunked engine; after normalization ``backend`` reads
                 "sharded" (1-D) or "mesh2d" (2-D). Spelling
                 backend="sharded" (with an optional ``mesh=``) is
                 deprecated: it builds a spec equal to the topology=
                 spelling, under a DeprecationWarning.
    chunk_t    — tick-block size of one kernel call in chunked ingest; on
                 a 2-D topology also the replica round-robin unit (chunk c
                 goes to replica c mod R).
    drift      — legacy parameter carrier (a DriftConfig or None).
    program    — the update rule: a LaneProgram or a registered family
                 name; owns algo and drift when given.
    topology   — THE placement surface, a ``parallel.TopologySpec``:
                   TopologySpec()                — one device (default)
                   TopologySpec(lanes=8)         — the lane axis over 8
                                                   devices
                   TopologySpec(data=2, lanes=4) — 2 stream replicas × 4
                                                   lane shards
                 normalized device-resolved, so equal placements compare
                 equal however they were spelled.
    health     — lane-corruption policy of QuantileFleet.check_health()
                 (resilience.health.HEALTH_POLICIES): "raise", "quarantine"
                 (re-initialize corrupt lanes) or "ignore" (report only).
    mesh       — deprecated input (see backend): a device sequence. After
                 normalization it holds the 1-D lane devices of a sharded
                 placement (a tuple), else None.
    """

    num_groups: int
    quantiles: Tuple[float, ...] = (0.5,)
    algo: str = "2u"
    backend: str = "fused"
    chunk_t: int = 4096
    drift: Optional[DriftConfig] = None
    program: Optional[Union[str, LaneProgram]] = None
    topology: Optional[TopologySpec] = None
    health: str = "raise"
    mesh: Optional[Tuple] = None

    def __post_init__(self):
        qs = tuple(float(q) for q in np.atleast_1d(np.asarray(self.quantiles,
                                                              np.float64)))
        object.__setattr__(self, "quantiles", qs)
        if self.num_groups <= 0:
            raise ValueError(f"num_groups must be positive, got "
                             f"{self.num_groups}")
        if not qs:
            raise ValueError("quantiles must name at least one target")
        if any(not (0.0 < q < 1.0) for q in qs):
            raise ValueError(f"quantiles must lie in (0, 1), got {qs}")
        if self.algo not in ("1u", "2u"):
            raise ValueError(f"algo must be '1u' or '2u', got {self.algo!r}")
        if self.chunk_t <= 0:
            raise ValueError(f"chunk_t must be positive, got {self.chunk_t}")
        self._normalize_topology()
        if self.health not in HEALTH_POLICIES:
            raise ValueError(
                f"health must be one of {HEALTH_POLICIES}, got "
                f"{self.health!r}")
        if self.drift is not None:
            self.drift.validate_for_algo(self.algo)
        prog = self.program
        if prog is None:
            prog = program_for(self.algo, self.drift)
        else:
            prog = make_program(prog)
            # The program owns algo/drift; a spelled legacy field may
            # restate them but not contradict ("2u" is the default).
            if self.algo != prog.algo and self.algo != "2u":
                raise ValueError(
                    f"algo={self.algo!r} contradicts program "
                    f"{prog.family!r} (algo {prog.algo!r})")
            if self.drift is not None and self.drift != prog.drift:
                raise ValueError(
                    f"drift={self.drift!r} contradicts program "
                    f"{prog.family!r} ({prog.drift!r})")
        object.__setattr__(self, "program", prog)
        object.__setattr__(self, "algo", prog.algo)
        object.__setattr__(self, "drift", prog.drift)

    # -------------------------------------------------------------- topology
    def _normalize_topology(self):
        """Fold the placement spellings onto ONE normalized surface.

        Afterwards ``topology`` is a device-resolved TopologySpec,
        ``backend`` the derived engine ("jnp"/"fused" single-device,
        "sharded" 1-D, "mesh2d" 2-D) and ``mesh`` the 1-D lane devices of a
        sharded placement (or None). The deprecated backend="sharded" /
        mesh= spelling builds a spec EQUAL to the topology= spelling, under
        a DeprecationWarning. Normalized values round-trip through
        dataclasses.replace without warning again."""
        topo = self.topology
        if topo is None:
            if self.backend == "sharded" or self.mesh is not None:
                if self.backend != "sharded":
                    raise ValueError("mesh= only applies to "
                                     "backend='sharded'")
                warnings.warn(
                    "backend='sharded' (with an optional mesh) is the "
                    "deprecated placement spelling — give the spec "
                    "topology=TopologySpec(lanes=...) instead "
                    "(parallel.TopologySpec; migration table in "
                    "DESIGN.md §9)", DeprecationWarning, stacklevel=4)
                topo = TopologySpec.from_mesh(self.mesh)
            else:
                if self.backend not in ("jnp", "fused"):
                    raise ValueError(f"backend must be one of {BACKENDS}, "
                                     f"got {self.backend!r}")
                topo = TopologySpec()
        else:
            if not isinstance(topo, TopologySpec):
                raise ValueError("topology must be a parallel.TopologySpec, "
                                 f"got {type(topo).__name__}")
            placement = topo.placement
            if self.backend in ("jnp", "fused"):
                if self.mesh is not None:
                    raise ValueError(
                        "mesh= is the deprecated placement spelling — fold "
                        "the devices into topology= (DESIGN.md §9)")
                if self.backend == "jnp" and placement != "single":
                    raise ValueError(
                        "backend='jnp' is the single-device scan engine; "
                        "meshed topologies run the chunked engine — drop "
                        "backend=")
            elif not ((self.backend == "sharded" and placement == "sharded")
                      or (self.backend == "mesh2d"
                          and placement == "mesh2d")):
                raise ValueError(
                    f"backend={self.backend!r} contradicts topology "
                    f"placement {placement!r} — topology= is the one "
                    "placement surface (drop backend=/mesh=)")
        topo = topo.resolve()
        placement = topo.placement
        if placement == "single":
            backend = self.backend if self.backend in ("jnp", "fused") \
                else "fused"
            mesh = None
        elif placement == "sharded":
            backend, mesh = "sharded", topo.devices
        else:
            backend, mesh = "mesh2d", None
        object.__setattr__(self, "topology", topo)
        object.__setattr__(self, "backend", backend)
        object.__setattr__(self, "mesh", mesh)

    def with_topology(self, topology: TopologySpec) -> "FleetSpec":
        """This spec re-placed on ``topology`` (the reshard and restore
        spelling). The plain engine exists on one device only, so a fleet
        leaving the single placement runs the chunked engine."""
        backend = self.backend if (self.backend in ("jnp", "fused") and
                                   topology.placement == "single") \
            else "fused"
        return FleetSpec(num_groups=self.num_groups,
                         quantiles=self.quantiles, backend=backend,
                         chunk_t=self.chunk_t, program=self.program,
                         health=self.health, topology=topology)

    # ------------------------------------------------------------ lane plane
    @property
    def num_quantiles(self) -> int:
        return len(self.quantiles)

    @property
    def num_lanes(self) -> int:
        """Flattened (G × Q) lane count; lane = g·Q + qi."""
        return self.num_groups * self.num_quantiles

    def lane_quantiles(self) -> np.ndarray:
        """[L] per-lane targets (the Q-vector tiled per group)."""
        return np.tile(np.asarray(self.quantiles, np.float32),
                       self.num_groups)

    def lane(self, group: int, quantile: float) -> int:
        """Flat lane index of (group, quantile)."""
        return group * self.num_quantiles + self.quantiles.index(
            float(quantile))

    def memory_words(self) -> int:
        """Persistent words per lane (the program layout's word count)."""
        return self.program.layout.num_words
