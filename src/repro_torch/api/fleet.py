"""QuantileFleet — the fleet API of the port.

    spec  = FleetSpec(num_groups=4096, quantiles=(0.5, 0.95, 0.99))
    fleet = QuantileFleet.create(spec, seed=0)          # on the card
    fleet = fleet.ingest(items)                         # [t, G] block
    fleet = fleet.ingest_stream(chunks)                 # unbounded stream
    fleet.estimate()                                    # [G, Q] numpy

Event-stream lanes (a per-lane clock, ``per_lane_clock=True``):

    fleet = QuantileFleet.create(spec, per_lane_clock=True)
    fleet = fleet.tick_lanes(items)                     # [L], NaN = none
    fleet = fleet.tick_lanes_sparse(lanes, items)       # K events, O(K)

Placement across devices (``FleetSpec(topology=TopologySpec(...))``):

    spec  = FleetSpec(num_groups=2**20, topology=TopologySpec(data=2,
                      lanes=4, devices=("cuda:0",) * 8))
    fleet = QuantileFleet.create(spec).ingest(items)    # 2 replicas x 4
    fleet = fleet.sync()                                # merge, write back
    fleet = fleet.reshard(TopologySpec(data=4, lanes=2))  # elastic

Health and checkpoints:

    fleet.health()                                      # scan only
    fleet, report = fleet.check_health()                # apply spec.health
    fleet.checkpoint(ckpt_dir, step=n)                  # format 4
    fleet = QuantileFleet.restore(ckpt_dir, spec)       # newest verified

Functional like the JAX package's facade: every ingest returns a new
fleet whose cursor has advanced (``tick_lanes_sparse(donate=True)`` is
the one call that updates this fleet's tensors in place). A single or
loop-mode fleet lives on one device, chosen at creation (``device=None``
is the card); a device-resolved topology places on its own devices. Later
calls move items there. Every placement gives the JAX package's bits:
single and 1-D placements the single trajectory, 2-D placements replicas
that merge by the pinned rule (``parallel.mesh2d``). Checkpoints are the
JAX package's format and hold the merged canonical lanes, so either
package restores the other's onto any topology; ``from_jax_state`` /
``to_numpy_state`` carry a fleet's exact state across in memory.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.platform import resolve_device
from repro_torch.core import frugal, streaming
from repro_torch.core import rng as crng
from repro_torch.core.sketch import GroupedQuantileSketch, PackedSketchState
from repro_torch.kernels import ops as kernel_ops
from repro_torch.parallel.group_sharding import ShardedGroupFleet
from repro_torch.parallel.mesh2d import Mesh2DFleet
from repro_torch.parallel.topology import TopologySpec, local_devices
from repro_torch.resilience import chaos
from repro_torch.resilience import health as health_mod
from repro_torch.train import checkpoint as ckpt

from .spec import FleetSpec, StreamCursor

_MESHED = (ShardedGroupFleet, Mesh2DFleet)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, with a CUDA device of no index read as the current
    one."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


def _home_device(spec: FleetSpec, device=None) -> torch.device:
    """Where a fleet of ``spec`` builds its canonical sketch: the first
    device of a device-resolved topology, else ``device`` (None: the
    card). A ``device`` that names another device than the topology's
    raises."""
    topo = spec.topology
    if not topo.on_devices:
        return resolve_device(device)
    devices = local_devices(topo.devices)
    if device is not None and not all(
            _same_device(torch.device(device), d) for d in devices):
        raise ValueError(
            f"device={device!r} contradicts the topology's devices "
            f"{devices}; drop device= or name the devices in the "
            "TopologySpec")
    return devices[0]


def _lane_tick(program, planes, ticks, q, items, seed, g_offset, scalars):
    """One tick over all L lanes: uniforms key on (seed, per-lane or
    scalar tick, absolute lane id); NaN items are bit-exact no-ops. Plain
    tensor operations on the planes' device (the JAX package computes it
    outside any kernel too)."""
    g_ids = crng.wrap_i32(g_offset) + torch.arange(
        planes[0].shape[0], dtype=torch.int32, device=planes[0].device)
    u = crng.counter_uniform(seed, ticks, g_ids)
    ctx = frugal.TickCtx(quantile=q, t=ticks, seed=seed, lanes=g_ids,
                         scalars=scalars)
    return program.run_tick(planes, items, u, ctx)


def _check_sparse_lanes(lanes, items, mask, num_lanes):
    """Host-side check of the round contract, the strict case of
    ``tick_lanes_sparse``'s run contract (a debugging aid, not a hot
    path): lane ids lie in [0, L), masked-in lanes are distinct, and no
    masked-out pad names a masked-in lane."""
    ln = lanes.cpu().numpy()
    mk = (~torch.isnan(items) if mask is None else mask != 0).cpu().numpy()
    out = ln[(ln < 0) | (ln >= num_lanes)]
    if out.size:
        raise ValueError(f"tick_lanes_sparse: lanes {out[:8].tolist()} lie "
                         f"outside [0, {num_lanes})")
    uniq, counts = np.unique(ln[mk], return_counts=True)
    dupes = uniq[counts > 1]
    if dupes.size:
        raise ValueError(
            f"tick_lanes_sparse: lanes {dupes[:8].tolist()} repeat within "
            "one round — the round contract that check_duplicates checks; "
            "without the check, one call takes each lane's events as one "
            "run of adjacent slots in arrival order")
    bad_pads = np.intersect1d(ln[~mk], uniq)
    if bad_pads.size:
        raise ValueError(
            f"tick_lanes_sparse: masked-out pad slots reuse event lanes "
            f"{bad_pads[:8].tolist()} — pad with lanes that have no event "
            "this round")


@dataclasses.dataclass(frozen=True)
class QuantileFleet:
    """A (G × Q) fleet of frugal quantile lanes behind one ingest/query
    API. ``state`` is the lane sketch (single placement), a
    ShardedGroupFleet (1-D topology) or a Mesh2DFleet (2-D); ``cursor``
    the stream position."""

    state: Union[GroupedQuantileSketch, ShardedGroupFleet, Mesh2DFleet]
    cursor: StreamCursor
    spec: FleetSpec

    @classmethod
    def create(cls, spec: FleetSpec, init=0.0, seed: int = 0, key=None,
               cursor: Optional[StreamCursor] = None,
               per_lane_clock: bool = False,
               device=None) -> "QuantileFleet":
        """Fresh fleet at stream position 0 on ``device`` (None: the card;
        raises where there is none) or on the devices of a device-resolved
        topology, which ``device`` may restate but not contradict.
        ``seed`` or uint32 key words ``key`` seed the counter RNG.
        ``per_lane_clock`` starts the cursor with a per-lane [L] tick
        tensor, the event-stream mode (``tick_lanes``,
        ``tick_lanes_sparse``, single placement); block ingest uses the
        scalar clock."""
        sk = GroupedQuantileSketch.create_lanes(
            spec.num_groups, spec.quantiles, algo=spec.algo, init=init,
            drift=spec.drift, device=_home_device(spec, device))
        if cursor is None:
            t0 = torch.zeros(spec.num_lanes, dtype=torch.int32,
                             device=sk.device) if per_lane_clock else 0
            cursor = StreamCursor.create(seed=seed, t_offset=t0, key=key)
        return cls(state=cls._place(spec, sk), cursor=cursor, spec=spec)

    @staticmethod
    def _place(spec: FleetSpec, sk: GroupedQuantileSketch):
        """Lay a canonical [L] sketch out on the spec's topology (a loop-mode
        fleet on the sketch's device). Every replica of a 2-D placement
        starts at the canonical state: placing is a sync point."""
        if spec.backend == "sharded":
            return ShardedGroupFleet.from_sketch(
                sk, spec.mesh, lanes_per_group=spec.num_quantiles)
        if spec.backend == "mesh2d":
            return Mesh2DFleet.from_sketch(
                sk, spec.topology, lanes_per_group=spec.num_quantiles)
        return sk

    # ------------------------------------------------------------ properties
    @property
    def num_groups(self) -> int:
        return self.spec.num_groups

    @property
    def num_quantiles(self) -> int:
        return self.spec.num_quantiles

    @property
    def num_lanes(self) -> int:
        return self.spec.num_lanes

    @property
    def algo(self) -> str:
        return self.spec.algo

    @property
    def device(self) -> torch.device:
        return self.state.device

    def memory_words(self) -> int:
        """Persistent words per lane: 1 (1U) or 2 (packed 2U) per plane."""
        return self.spec.memory_words()

    def _lane_sketch(self) -> GroupedQuantileSketch:
        """The canonical [L]-lane sketch: the state itself, a 1-D fleet's
        gathered lanes, or a 2-D fleet's replicas through the pinned merge
        (reading is a merge, not a mutation)."""
        if isinstance(self.state, _MESHED):
            return self.state.unshard()
        return self.state

    # ---------------------------------------------------------------- health
    def health(self) -> health_mod.HealthReport:
        """Scan-only lane health report: every lane's planes against the
        spec program's declared StateLayout invariants (finite heads, exact
        ±1 signs, pack-round-trippable steps). Never mutates or raises;
        ``check_health`` applies the policy. A meshed fleet is scanned
        over its merged canonical lanes."""
        return health_mod.report_for(self.spec.program,
                                     self._lane_sketch().planes(),
                                     self.spec.health)

    def check_health(self) -> Tuple["QuantileFleet",
                                    health_mod.HealthReport]:
        """Scan lane health and apply ``spec.health``; returns (fleet,
        report).

        "raise"      — LaneCorruptionError if any lane is corrupt;
        "quarantine" — a new fleet whose corrupt lanes hold the fresh lane
                       state (future ticks bit-exact with a lane created
                       at the current cursor), healthy lanes untouched;
        "ignore"     — report only.

        On a 2-D placement the scan and the heal run over the merged
        canonical lanes, and re-placing the healed sketch writes it to
        every replica: a quarantine is a sync point.
        """
        sk = self._lane_sketch()
        prog, planes = self.spec.program, sk.planes()
        mask = health_mod.validate_planes(prog, planes)
        rep = health_mod.report_of(mask, self.spec.health)
        if rep.healthy or self.spec.health == "ignore":
            return self, rep
        if self.spec.health == "raise":
            raise health_mod.LaneCorruptionError(str(rep))
        healed = sk.with_planes(health_mod.heal_planes(prog, planes, mask))
        rep = dataclasses.replace(rep, quarantined=rep.corrupt_lanes)
        return dataclasses.replace(
            self, state=self._place(self.spec, healed)), rep

    # ---------------------------------------------------------------- ingest
    def _require_scalar_clock(self, what: str):
        if self.cursor.per_lane:
            raise ValueError(
                f"{what} needs the scalar stream clock; this fleet uses a "
                "per-lane cursor (event-stream mode) — use tick_lanes")

    def ingest(self, items) -> "QuantileFleet":
        """Ingest a [t, G] block (numpy or tensor); returns the fleet
        advanced t ticks. Bit-identical for any split of a stream into
        successive calls, and on either ``spec.backend``: "fused" runs
        ``chunk_t``-row dense-kernel calls, "jnp" the plain loop
        (``GroupedQuantileSketch.process_seeded``) over the same rows.
        A meshed fleet runs the chunked engine on every shard (and routes
        chunks to replicas by absolute tick)."""
        self._require_scalar_clock("ingest")
        cur = self.cursor
        if isinstance(self.state, _MESHED):
            items = streaming._as_2d(items, self.num_groups)
            state = self.state.ingest_array(
                items, seed=cur.seed, chunk_t=self.spec.chunk_t,
                t_offset=cur.t_offset, g_offset=cur.g_offset)
        else:
            state = streaming.ingest_array(
                self.state, items, cur.seed, chunk_t=self.spec.chunk_t,
                t_offset=cur.t_offset, g_offset=cur.g_offset,
                lanes_per_group=self.num_quantiles,
                plain=self.spec.backend == "jnp")
        return dataclasses.replace(
            self, state=state, cursor=cur.advance(np.shape(items)[0]))

    def ingest_stream(self, chunks: Iterable, chunk_t: Optional[int] = None,
                      skip_items: int = 0) -> "QuantileFleet":
        """Ingest an unbounded stream of [t_i, G] blocks in ``chunk_t``-row
        kernel calls; the cursor advances by the number of real items.

        If the source raises mid-stream, a ``chaos.StreamInterrupted``
        carries ``fleet`` (this fleet advanced through every fully-applied
        chunk) and ``items_applied`` (committed leading items of the
        original stream); resume with
        ``err.fleet.ingest_stream(stream, skip_items=err.items_applied)``.
        """
        with tracing.span("fleet.ingest_stream"):
            self._require_scalar_clock("ingest_stream")
            chunk_t = chunk_t or self.spec.chunk_t
            cur = self.cursor
            skip_items = int(skip_items)
            if skip_items:
                chunks = streaming.drop_leading_items(chunks, skip_items,
                                                      self.num_groups)
            counted = [0]

            def counting():
                for c in chunks:
                    shape = np.shape(c)
                    counted[0] += shape[0] if shape else 1
                    yield c

            try:
                if isinstance(self.state, _MESHED):
                    sk = self.state.ingest_stream(
                        counting(), seed=cur.seed, chunk_t=chunk_t,
                        t_offset=cur.t_offset, g_offset=cur.g_offset)
                else:
                    sk = streaming.ingest_stream(
                        self.state, counting(), cur.seed, chunk_t=chunk_t,
                        t_offset=cur.t_offset, g_offset=cur.g_offset,
                        lanes_per_group=self.num_quantiles,
                        plain=self.spec.backend == "jnp")
            except chaos.StreamInterrupted as e:
                applied = e.items_applied
                partial = dataclasses.replace(self, state=e.state,
                                              cursor=cur.advance(applied))
                total = skip_items + applied
                raise chaos.StreamInterrupted(
                    f"{e}; resume with err.fleet.ingest_stream(stream, "
                    f"skip_items={total}) over the ORIGINAL stream",
                    state=e.state, fleet=partial, items_applied=total) from e
            return dataclasses.replace(self, state=sk,
                                       cursor=cur.advance(counted[0]))

    # ---------------------------------------------------------- event ingest
    def _on_device(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)

    def _refuse_meshed(self, what: str):
        if isinstance(self.state, _MESHED):
            raise NotImplementedError(
                f"{what} on a meshed fleet — event-stream lanes run the "
                "single placement (TopologySpec())")

    def tick_lanes(self, items, mask=None) -> "QuantileFleet":
        """One tick over all L lanes from lane-level items [L] (NaN = no
        event on that lane: a bit-exact no-op).

        With a per-lane cursor each lane's clock advances only where
        ``mask`` is 1 (default: where items are not NaN), so a lane's k-th
        event always consumes uniform (seed, k, lane). Items on masked-out
        lanes are forced to NaN first: a lane's state never moves without
        its clock. With the scalar clock every lane shares the tick and
        the clock advances by 1; a mask raises there. Single placement
        only, as in the JAX package.
        """
        self._refuse_meshed("tick_lanes")
        sk = self.state
        items = self._on_device(items, torch.float32)
        if tuple(items.shape) != (self.num_lanes,):
            raise ValueError(f"lane items shape {tuple(items.shape)} != "
                             f"[{self.num_lanes}]")
        cur = self.cursor
        if not cur.per_lane and mask is not None:
            raise ValueError(
                "tick_lanes(mask=...) needs a per-lane cursor: with the "
                "scalar clock every lane's tick advances together, so a "
                "mask cannot hold individual clocks back — pass NaN items "
                "for no-op lanes, or create the fleet with "
                "per_lane_clock=True")
        if mask is not None:
            mask = self._on_device(mask, torch.int32)
            items = torch.where(mask == 0, float("nan"), items)
        planes = _lane_tick(self.spec.program, sk.planes(), cur.t_offset,
                            sk.quantile, items, cur.seed, cur.g_offset,
                            self.spec.program.scalar_values())
        if cur.per_lane:
            if mask is None:
                mask = (~torch.isnan(items)).to(torch.int32)
            cur = cur.advance_lanes(mask)
        else:
            cur = cur.advance(1)
        return dataclasses.replace(self, state=sk.with_planes(planes),
                                   cursor=cur)

    def tick_lanes_sparse(self, lanes, items, mask=None, *,
                          donate: bool = False,
                          check_duplicates: bool = False
                          ) -> "QuantileFleet":
        """O(events) event ingest: slot j ticks lane ``lanes[j]`` once, in
        one launch (``kernels.ops.frugal_update_sparse``: the run kernel on
        the card, its plain version on the CPU). Needs a per-lane cursor.
        ``mask`` advances each slot's lane clock (None: where the item is
        not NaN); a slot with mask 0 ticks with a NaN item, so a pad never
        moves state without its clock.

        Run contract: each lane's masked-in events are adjacent and in
        arrival order (a stable sort by lane gives this, as
        ``serve.SLOFleet.flush`` does), and distinct runs of adjacent slots
        name distinct lanes, except runs of pads only. A round of distinct
        lanes is the case of runs of length 1.

        ``donate=True`` updates THIS fleet's plane and clock tensors in
        place (cost flat in L, the serve path's mode): the old fleet object
        then aliases the new state, so use only the returned fleet. The
        default clones the planes and the clock first, one [L] copy per
        plane, and leaves this fleet as it was.
        ``check_duplicates=True`` adds a host-side check of the stricter
        round contract (distinct masked-in lanes, pads on lanes of their
        own; a debugging aid that synchronises with the card).
        Single placement only, as in the JAX package.
        """
        self._refuse_meshed("tick_lanes_sparse")
        if not self.cursor.per_lane:
            raise ValueError("tick_lanes_sparse needs a per-lane cursor "
                             "(create with per_lane_clock=True)")
        sk = self.state
        cur = self.cursor
        lanes = self._on_device(lanes, torch.int32)
        items = self._on_device(items, torch.float32)
        if lanes.shape != items.shape or lanes.dim() != 1:
            raise ValueError(f"lanes {tuple(lanes.shape)} and items "
                             f"{tuple(items.shape)} must be matching [K] "
                             "vectors")
        if mask is not None:
            mask = self._on_device(mask, torch.int32)
        if check_duplicates:
            _check_sparse_lanes(lanes, items, mask, self.num_lanes)
        planes, ticks = kernel_ops.frugal_update_sparse(
            lanes, items, mask, sk.planes(), cur.t_offset, sk.quantile,
            cur.seed, program=self.spec.program,
            g_offset=cur.g_offset, donate=donate)
        return dataclasses.replace(self, state=sk.with_planes(planes),
                                   cursor=cur._replace(t_offset=ticks))

    # ------------------------------------------------------------------ grow
    def grow_groups(self, num_groups: int, init=0.0) -> "QuantileFleet":
        """Append groups (capacity growth, e.g. serving routes). Lane ids
        are group-major and independent of capacity, so growth appends
        lanes (and zero clocks on a per-lane cursor) without touching any
        existing lane's state or uniform stream. A 2-D fleet appends to
        every replica (not a sync point); a 1-D fleet gathers its real
        lanes, appends and re-shards."""
        if num_groups < self.num_groups:
            raise ValueError(f"cannot shrink {self.num_groups} -> "
                             f"{num_groups}")
        if num_groups == self.num_groups:
            return self
        spec = dataclasses.replace(self.spec, num_groups=num_groups)
        fresh = GroupedQuantileSketch.create_lanes(
            num_groups - self.num_groups, spec.quantiles, algo=spec.algo,
            init=init, drift=spec.drift, device=self.device)
        if isinstance(self.state, Mesh2DFleet):
            grown = self.state.grow(fresh)
        else:
            sk = self._lane_sketch()
            grown = self._place(spec, dataclasses.replace(
                sk, quantile=torch.cat([sk.quantile, fresh.quantile]), **{
                    f: torch.cat([getattr(sk, f), getattr(fresh, f)])
                    for f in spec.program.layout.plane_fields}))
        cur = self.cursor
        if cur.per_lane:
            pad = torch.zeros(spec.num_lanes - self.num_lanes,
                              dtype=torch.int32, device=self.device)
            cur = cur._replace(t_offset=torch.cat([cur.t_offset, pad]))
        return QuantileFleet(state=grown, cursor=cur, spec=spec)

    # --------------------------------------------------------------- elastic
    def sync(self) -> "QuantileFleet":
        """Fold every data replica through the pinned merge and write the
        canonical state back (the DESIGN.md §15 sync point), on the
        fleet's devices. Idempotent, and the identity on single and 1-D
        placements, which hold one trajectory."""
        if isinstance(self.state, Mesh2DFleet):
            return dataclasses.replace(self, state=self.state.sync())
        return self

    def reshard(self, topology: TopologySpec) -> "QuantileFleet":
        """Re-place this live fleet on ``topology`` without perturbing its
        lanes:

        * the same data-replica count: every replica's lanes carry over
          bit for bit (a relayout, no merge);
        * another replica count (single and 1-D included): the fleet
          passes through the pinned merge — a sync point — so
          ``estimate()`` is unchanged and the canonical trajectory goes on.

        A single or loop-mode result stays on this fleet's device. The
        cursor is untouched."""
        spec = self.spec.with_topology(topology)
        topo = spec.topology
        if (isinstance(self.state, Mesh2DFleet)
                and topo.placement == "mesh2d"
                and topo.data == self.state.data_replicas):
            state = Mesh2DFleet._build(self.state.replica_sketches(), topo,
                                       spec.num_quantiles)
        else:
            state = self._place(spec, self._lane_sketch())
        return QuantileFleet(state=state, cursor=self.cursor, spec=spec)

    # ----------------------------------------------------------------- reads
    def query_view(self) -> Tuple[Tuple[np.ndarray, ...], np.ndarray, int,
                                  np.ndarray]:
        """Host-owned ``(m_planes, t_next, seed, lanes)``: copies of the
        layout's query planes, the cursor tick (scalar or per lane), the
        seed and absolute lane ids — the one gathering read behind
        ``estimate()``. Nothing returned aliases a tensor that a later
        ``tick_lanes_sparse(donate=True)`` round updates in place. Only
        the query planes move: a 2-D fleet folds them on the host through
        the pinned merge."""
        fields = self.spec.program.layout.query_fields
        if isinstance(self.state, Mesh2DFleet):
            m_planes = self.state.merged_planes(fields)
        elif isinstance(self.state, ShardedGroupFleet):
            m_planes = self.state.host_planes(fields)
        else:
            m_planes = tuple(getattr(self.state, f).cpu().numpy().copy()
                             for f in fields)
        cur = self.cursor
        t_next = (cur.t_offset.cpu().numpy().copy() if cur.per_lane
                  else np.array(cur.t_offset, dtype=np.int32))
        lanes = cur.g_offset + np.arange(self.num_lanes, dtype=np.int64)
        return m_planes, t_next, cur.seed, lanes

    def estimate(self, quantile: Optional[float] = None) -> np.ndarray:
        """Current estimates as [G, Q] numpy (or one target's [G] column).
        The program's query answers: the estimate plane, the older window
        plane, or the Laplace-noised release of 2u-dp."""
        m_planes, t_next, seed, lanes = self.query_view()
        m = self.spec.program.run_query(m_planes, t_next=t_next, seed=seed,
                                        lanes=lanes)
        plane = np.asarray(m).reshape(self.num_groups, self.num_quantiles)
        if quantile is None:
            return plane
        return plane[:, self.spec.quantiles.index(float(quantile))]

    # -------------------------------------------------------- serialization
    def checkpoint_state(self) -> dict:
        """Checkpoint tree: the canonical lane sketch (stored packed, 1-2
        words per lane; a meshed fleet's merged lanes) and the cursor as
        int32 leaves (0-d, or [L] for a per-lane clock), the JAX package's
        layout leaf for leaf. A single fleet's tensors are its own
        (``tick_lanes_sparse(donate=True)`` updates them in place)."""
        cur = self.cursor
        t_off = cur.t_offset if cur.per_lane \
            else np.asarray(cur.t_offset, np.int32)
        return {"sketch": self._lane_sketch(),
                "cursor": StreamCursor(seed=np.asarray(cur.seed, np.int32),
                                       t_offset=t_off,
                                       g_offset=np.asarray(cur.g_offset,
                                                           np.int32))}

    def checkpoint_template(self) -> dict:
        """Structure-only ``like`` tree for
        ``train.checkpoint.restore_checkpoint``."""
        return self.template_for(self.spec,
                                 per_lane_clock=self.cursor.per_lane)

    @staticmethod
    def template_for(spec: FleetSpec, per_lane_clock: bool = False) -> dict:
        """``checkpoint_template`` from a spec alone: shape-only leaves,
        no fleet and no allocation."""
        lanes = spec.num_lanes
        f32 = ckpt.LeafSpec((lanes,), np.float32)
        i32s = ckpt.LeafSpec((), np.int32)
        m2 = f32 if spec.program.layout.has_shadow else None
        if spec.algo == "1u":
            sk = GroupedQuantileSketch(m=f32, step=None, sign=None,
                                       quantile=f32, m2=m2, algo="1u",
                                       drift=spec.drift)
        else:
            sk = GroupedQuantileSketch(m=f32, step=f32, sign=f32,
                                       quantile=f32, m2=m2, step2=m2,
                                       sign2=m2, algo="2u",
                                       drift=spec.drift)
        t_off = ckpt.LeafSpec((lanes,), np.int32) if per_lane_clock \
            else i32s
        return {"sketch": sk,
                "cursor": StreamCursor(seed=i32s, t_offset=t_off,
                                       g_offset=i32s)}

    @classmethod
    def from_checkpoint_state(cls, state: dict,
                              spec: FleetSpec) -> "QuantileFleet":
        """A fleet from a checkpoint tree (``{"sketch": sketch, "cursor":
        (seed, t_offset, g_offset)}``), placed on ``spec``'s topology (a
        single or loop-mode fleet on the sketch's device). The sketch must
        match ``spec``'s lane count and program layout; the spec, not the
        file, owns drift parameters going forward."""
        sk = state["sketch"]
        if sk.num_groups != spec.num_lanes:
            raise ValueError(
                f"checkpoint holds {sk.num_groups} lanes but spec "
                f"{spec.num_groups}x{spec.num_quantiles} expects "
                f"{spec.num_lanes}")
        if sk.algo != spec.algo:
            raise ValueError(f"checkpoint holds a {sk.algo} sketch but spec "
                             f"program {spec.program.family!r} is "
                             f"{spec.algo}")
        if spec.program.layout.has_shadow != (sk.m2 is not None):
            raise ValueError(
                f"checkpoint {'has' if sk.m2 is not None else 'lacks'} a "
                f"window shadow plane but spec.drift is {spec.drift!r}")
        if sk.drift != spec.drift:
            sk = dataclasses.replace(sk, drift=spec.drift)
        seed, t_off, g_off = state["cursor"]
        if np.ndim(t_off):
            if not isinstance(t_off, torch.Tensor):
                t_off = torch.from_numpy(np.array(t_off, np.int32))
            t_off = t_off.to(device=sk.device, dtype=torch.int32)
            if t_off.shape[0] != spec.num_lanes:
                raise ValueError(f"per-lane cursor holds {t_off.shape[0]} "
                                 f"clocks, spec expects {spec.num_lanes}")
        else:
            t_off = int(t_off)
        return cls(state=cls._place(spec, sk), cursor=StreamCursor.create(
            seed=int(seed), t_offset=t_off, g_offset=int(g_off)), spec=spec)

    def checkpoint(self, ckpt_dir: str, step: int, keep: int = 3) -> str:
        """Write a committed, per-leaf-checksummed format-4 checkpoint
        (``train.checkpoint``: restore verifies the CRCs, quarantines a
        corrupt step and falls back to the newest intact one). The payload
        is the merged canonical lanes (a checkpoint is a sync point), so
        ``restore`` re-places it on any topology; the manifest records the
        writer's topology."""
        return ckpt.save_checkpoint(ckpt_dir, step, self.checkpoint_state(),
                                    keep=keep,
                                    topology=self.spec.topology.describe())

    @classmethod
    def restore(cls, ckpt_dir: str, spec: FleetSpec,
                step: Optional[int] = None, per_lane_clock: bool = False,
                device=None) -> "QuantileFleet":
        """Load the newest committed checkpoint (or ``step``) into a fleet
        on ``spec``'s topology: on ``device`` (None: the card; raises where
        there is none) or on the topology's own devices. A checkpoint the
        JAX package wrote, under any topology, restores the same way."""
        like = cls.template_for(spec, per_lane_clock=per_lane_clock)
        state, _ = ckpt.restore_checkpoint(ckpt_dir, like=like, step=step,
                                           device=_home_device(spec, device))
        return cls.from_checkpoint_state(state, spec)

    # ------------------------------------------------------- carry across
    def to_numpy_state(self) -> Tuple[PackedSketchState, StreamCursor]:
        """(packed payload as numpy arrays, cursor): the JAX package's
        ``GroupedQuantileSketch.packed()`` fields and its ``StreamCursor``
        values (a per-lane ``t_offset`` as an [L] int32 numpy array), ready
        to rebuild a JAX fleet at exactly this state."""
        p = self._lane_sketch().packed()
        cur = self.cursor
        if cur.per_lane:
            cur = cur._replace(t_offset=cur.t_offset.cpu().numpy().copy())
        return PackedSketchState(*(None if x is None else x.cpu().numpy()
                                   for x in p)), cur


def from_jax_state(spec: FleetSpec, packed, cursor,
                   device=None) -> QuantileFleet:
    """A port fleet that continues exactly where a JAX fleet stands.

    ``packed`` holds the JAX sketch's ``packed()`` fields (``m``,
    ``step_sign``, ``quantile``, ``m2``, ``step_sign2``) as numpy arrays
    (or tensors); ``cursor`` is the JAX ``StreamCursor`` as (seed,
    t_offset, g_offset): ints, with ``t_offset`` an [L] int32 array for a
    per-lane (event-stream) fleet. The payload must match ``spec``'s lane
    count and program layout (``QuantileFleet.from_checkpoint_state``),
    and lands on ``spec``'s topology.
    """
    sk = GroupedQuantileSketch.from_packed(
        packed, device=_home_device(spec, device))
    return QuantileFleet.from_checkpoint_state(
        {"sketch": sk, "cursor": cursor}, spec)
