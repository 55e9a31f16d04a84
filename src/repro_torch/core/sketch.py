"""GroupedQuantileSketch — per-lane frugal state as torch tensors.

Port of the JAX package's ``core/sketch.py``: 1 or 2 memory words per lane
(the paper's accounting), planes laid out by the sketch's ``LaneProgram``.
A (G × Q) multi-quantile plane is one flat sketch of L = G·Q lanes,
group-major (lane = g·Q + qi). Functional like the JAX version: ingest
returns a new sketch and leaves the old one's tensors untouched.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device

from . import frugal
from . import packing
from . import rng as crng
from .drift import DriftConfig, is_windowed


class PackedSketchState(NamedTuple):
    """Serialized sketch payload, the JAX package's ``PackedSketchState``:
    m [L] f32, step_sign [L] i32 (2U only), quantile [L] f32, and for a
    window program the shadow plane m2 / step_sign2."""

    m: object
    step_sign: Optional[object]
    quantile: object
    m2: Optional[object] = None
    step_sign2: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class GroupedQuantileSketch:
    """Per-lane streaming quantile state (1 or 2 memory words per plane)."""

    m: torch.Tensor
    step: Optional[torch.Tensor]
    sign: Optional[torch.Tensor]
    quantile: torch.Tensor              # [L] float32 per-lane target
    m2: Optional[torch.Tensor] = None   # window shadow plane
    step2: Optional[torch.Tensor] = None
    sign2: Optional[torch.Tensor] = None
    algo: str = "2u"
    drift: Optional[DriftConfig] = None

    @property
    def num_groups(self) -> int:
        """Lanes in the sketch (groups for a Q = 1 sketch)."""
        return self.m.shape[0]

    @property
    def device(self) -> torch.device:
        return self.m.device

    @property
    def program(self):
        """The sketch's LaneProgram, from its (algo, drift)."""
        from . import program as program_mod

        return program_mod.program_for(self.algo, self.drift)

    def planes(self) -> tuple:
        """The program's ordered plane tuple (layout.plane_fields)."""
        return tuple(getattr(self, f)
                     for f in self.program.layout.plane_fields)

    def with_planes(self, planes) -> "GroupedQuantileSketch":
        fields = self.program.layout.plane_fields
        return dataclasses.replace(self, **dict(zip(fields, planes)))

    @property
    def estimate(self) -> torch.Tensor:
        """Plane A's estimates (a window fleet's query picks the plane from
        its cursor: read through repro_torch.api.QuantileFleet)."""
        return self.m

    def memory_words(self) -> int:
        return self.program.layout.num_words

    # ------------------------------------------------------- serialization
    def packed(self) -> PackedSketchState:
        """The serialized form: each plane-pair as (m, step_sign) words."""
        layout = self.program.layout
        slots = {"m": self.m, "step_sign": None, "m2": None,
                 "step_sign2": None}
        for i, (head, pair) in enumerate(layout.packing):
            suffix = "" if i == 0 else "2"
            slots["m" + suffix] = getattr(self, head)
            if pair is not None:
                slots["step_sign" + suffix] = packing.pack_step_sign(
                    getattr(self, pair[0]), getattr(self, pair[1]))
        return PackedSketchState(quantile=self.quantile, **slots)

    @staticmethod
    def from_packed(p, drift: Optional[DriftConfig] = None,
                    device=None) -> "GroupedQuantileSketch":
        """Inverse of ``packed``. ``p`` holds tensors or numpy arrays (a JAX
        package payload converted with ``np.asarray`` restores too); they
        land on ``device`` (None: the card). A shadow plane restores as a
        window sketch; an explicit ``drift`` must agree with it."""
        device = resolve_device(device)

        def tensor(x, dtype):
            if x is None:
                return None
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))    # an owned copy
            return x.to(device=device, dtype=dtype).contiguous()

        m = tensor(p.m, torch.float32)
        ss = tensor(p.step_sign, torch.int32)
        q = tensor(p.quantile, torch.float32)
        m2 = tensor(getattr(p, "m2", None), torch.float32)
        ss2 = tensor(getattr(p, "step_sign2", None), torch.int32)
        if drift is not None and is_windowed(drift) != (m2 is not None):
            raise ValueError(
                f"packed payload {'has' if m2 is not None else 'lacks'} a "
                f"window shadow plane but drift={drift!r}")
        if m2 is not None and drift is None:
            drift = DriftConfig(mode="window")
        algo = "1u" if ss is None else "2u"
        if drift is not None:
            drift = drift.validate_for_algo(algo)
        if ss is None:
            return GroupedQuantileSketch(m=m, step=None, sign=None,
                                         quantile=q, m2=m2, algo="1u",
                                         drift=drift)
        step, sign = packing.unpack_step_sign(ss)
        step2 = sign2 = None
        if ss2 is not None:
            step2, sign2 = packing.unpack_step_sign(ss2)
        return GroupedQuantileSketch(m=m, step=step, sign=sign, quantile=q,
                                     m2=m2, step2=step2, sign2=sign2,
                                     algo="2u", drift=drift)

    # ---------------------------------------------------------------- init
    @staticmethod
    def create(num_groups: int, quantile=0.5, algo: str = "2u", init=0.0,
               drift: Optional[DriftConfig] = None,
               device=None) -> "GroupedQuantileSketch":
        """Fresh lanes: estimate heads at ``init``, step and sign at 1.
        ``quantile`` is a scalar or a per-lane vector."""
        from . import program as program_mod

        if algo not in ("1u", "2u"):
            raise ValueError(f"algo must be '1u' or '2u', got {algo!r}")
        if drift is not None:
            drift.validate_for_algo(algo)
        device = resolve_device(device)
        layout = program_mod.program_for(algo, drift).layout
        m = torch.broadcast_to(
            torch.as_tensor(init, dtype=torch.float32, device=device),
            (num_groups,)).clone()
        q = torch.broadcast_to(
            torch.as_tensor(quantile, dtype=torch.float32, device=device),
            (num_groups,)).clone()
        fields = {"step": None, "sign": None, "m2": None, "step2": None,
                  "sign2": None}
        for f in layout.plane_fields:
            if f == "m":
                fields[f] = m
            elif f in layout.heads:
                fields[f] = m.clone()
            else:
                fields[f] = torch.ones_like(m)
        return GroupedQuantileSketch(quantile=q, algo=algo, drift=drift,
                                     **fields)

    @staticmethod
    def create_lanes(num_groups: int, quantiles, algo: str = "2u",
                     init=0.0, drift: Optional[DriftConfig] = None,
                     device=None) -> "GroupedQuantileSketch":
        """A (G × Q) multi-quantile lane plane as one flat sketch, lane
        g·Q + qi tracking quantiles[qi] of group g. ``init`` may be a
        scalar, [G] (repeated per group) or [G·Q]."""
        quantiles = np.asarray(quantiles, np.float32).reshape(-1)
        if quantiles.size == 0:
            raise ValueError("need at least one quantile target")
        nq = int(quantiles.size)
        init_arr = torch.as_tensor(init, dtype=torch.float32).reshape(-1)
        if init_arr.shape[0] == num_groups and nq > 1:
            init_arr = init_arr.repeat_interleave(nq)
        q = torch.from_numpy(np.tile(quantiles, num_groups))
        return GroupedQuantileSketch.create(
            num_groups * nq, quantile=q, algo=algo, init=init_arr,
            drift=drift, device=device)

    # -------------------------------------------------------------- ingest
    def update(self, items: torch.Tensor,
               rand: torch.Tensor) -> "GroupedQuantileSketch":
        """One tick, one item per lane, with fed uniforms (items and rand
        [L]). Vanilla lanes only: the drift rules key on the absolute tick,
        which this call does not carry."""
        if self.drift is not None:
            raise ValueError(
                "update(items, rand) carries no stream tick; drift-aware "
                "sketches need the absolute tick — use process_seeded or "
                "repro_torch.api.QuantileFleet")
        if self.algo == "1u":
            st = frugal.frugal1u_update(frugal.Frugal1UState(self.m), items,
                                        rand, self.quantile)
            return dataclasses.replace(self, m=st.m)
        st = frugal.frugal2u_update(
            frugal.Frugal2UState(self.m, self.step, self.sign), items, rand,
            self.quantile)
        return dataclasses.replace(self, m=st.m, step=st.step, sign=st.sign)

    def process(self, items, key, g_offset: int = 0,
                lanes_per_group: int = 1) -> "GroupedQuantileSketch":
        """Sequential ingest of [T, G] items (numpy or tensor, moved to the
        sketch's device) from ``key``: an int seed or uint32 key words,
        folded by ``rng.seed_from_key``; the stream starts at tick 0."""
        items = torch.as_tensor(items, dtype=torch.float32,
                                device=self.device)
        return self.process_seeded(items, crng.seed_from_key(key),
                                   g_offset=g_offset,
                                   lanes_per_group=lanes_per_group)

    def process_seeded(self, items: torch.Tensor, seed, t_offset=0,
                       g_offset=0, lanes_per_group: int = 1
                       ) -> "GroupedQuantileSketch":
        """Sequential ingest of [T, G] items with the plain PyTorch loop
        (``core.frugal.program_process_seeded``) from an int32 counter seed
        and explicit stream offsets."""
        planes, _ = frugal.program_process_seeded(
            self.program, self.planes(), items, seed, self.quantile,
            t_offset=t_offset, g_offset=g_offset,
            lanes_per_group=lanes_per_group)
        return self.with_planes(planes)

    def ingest_tensor(self, x: torch.Tensor, key,
                      group_axis: int = -1) -> "GroupedQuantileSketch":
        """Batched binomial update from a tensor (``core.batched``): every
        axis but ``group_axis`` flattens into each group's item batch.
        ``key``: uint32 key words. Vanilla lanes only."""
        from .batched import batched_frugal2u_update

        if self.drift is not None:
            raise ValueError(
                "ingest_tensor's batched binomial update collapses the tick "
                "axis; drift-aware lanes need per-tick phase — use "
                "process/process_seeded")
        x = torch.as_tensor(x, device=self.device)
        x = torch.movedim(x, group_axis, -1)
        x = x.reshape(-1, x.shape[-1])            # [B, G]
        if self.algo == "1u":
            # 1U batched = 2U batched with the step frozen at 1.
            one = torch.ones_like(self.m)
            st = batched_frugal2u_update(
                frugal.Frugal2UState(self.m, one, one), x, key,
                self.quantile, freeze_step=True)
            return dataclasses.replace(self, m=st.m)
        st = batched_frugal2u_update(
            frugal.Frugal2UState(self.m, self.step, self.sign), x, key,
            self.quantile)
        return dataclasses.replace(self, m=st.m, step=st.step, sign=st.sign)


def sketch_update_jit(sk: GroupedQuantileSketch, items: torch.Tensor,
                      rand: torch.Tensor, algo: str = "2u"
                      ) -> GroupedQuantileSketch:
    """``sk.update(items, rand)`` under the JAX package's name (there a
    jitted function; ``algo`` is unused, as there)."""
    del algo
    return sk.update(items, rand)
