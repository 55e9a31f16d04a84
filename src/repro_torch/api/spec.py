"""FleetSpec and StreamCursor — the configuration and stream position of a
``QuantileFleet`` (port of the JAX package's ``api/spec.py``, single
placement only)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import rng as crng
from repro_torch.core.drift import DriftConfig
from repro_torch.core.program import LaneProgram, make_program, program_for
from repro_torch.resilience.health import HEALTH_POLICIES

# The JAX package's spellable backends. "jnp" and "fused" are engines of
# the single placement; "sharded" names a placement across devices, which
# the port does not have yet.
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
    backend    — the ingest engine: "fused" (chunked dense-kernel calls,
                 ``core.streaming``: the CUDA kernel on the card) or "jnp"
                 (the plain PyTorch loop, ``core.frugal
                 .program_process_seeded``, on the fleet's device). Both
                 give the same bits.
    chunk_t    — tick-block size of one kernel call in chunked ingest.
    drift      — legacy parameter carrier (a DriftConfig or None).
    program    — the update rule: a LaneProgram or a registered family
                 name; owns algo and drift when given.
    topology   — placement; only the single device is ported (None).
    health     — lane-corruption policy of QuantileFleet.check_health()
                 (resilience.health.HEALTH_POLICIES): "raise", "quarantine"
                 (re-initialize corrupt lanes) or "ignore" (report only).
    """

    num_groups: int
    quantiles: Tuple[float, ...] = (0.5,)
    algo: str = "2u"
    backend: str = "fused"
    chunk_t: int = 4096
    drift: Optional[DriftConfig] = None
    program: Optional[Union[str, LaneProgram]] = None
    topology: Optional[object] = None
    health: str = "raise"

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
        if self.backend == "sharded":
            raise ValueError(
                "backend='sharded' places a fleet across devices, which "
                "waits for the parallel/ port (ROADMAP.md queue A, item 2); "
                "use 'fused' or 'jnp'")
        if self.backend not in ("jnp", "fused"):
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        if self.health not in HEALTH_POLICIES:
            raise ValueError(
                f"health must be one of {HEALTH_POLICIES}, got "
                f"{self.health!r}")
        if self.topology is not None:
            raise NotImplementedError(
                "only the single-device placement is ported; lane-sharded "
                "and 2-D placements wait for the parallel/ port "
                "(ROADMAP.md queue A, item 2)")
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
