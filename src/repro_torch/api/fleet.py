"""QuantileFleet — the fleet API of the port (single placement).

    spec  = FleetSpec(num_groups=4096, quantiles=(0.5, 0.95, 0.99))
    fleet = QuantileFleet.create(spec, seed=0)          # on the card
    fleet = fleet.ingest(items)                         # [t, G] block
    fleet = fleet.ingest_stream(chunks)                 # unbounded stream
    fleet.estimate()                                    # [G, Q] numpy

Event-stream lanes (a per-lane clock, ``per_lane_clock=True``):

    fleet = QuantileFleet.create(spec, per_lane_clock=True)
    fleet = fleet.tick_lanes(items)                     # [L], NaN = none
    fleet = fleet.tick_lanes_sparse(lanes, items)       # K events, O(K)

Functional like the JAX package's facade: every ingest returns a new
fleet whose cursor has advanced (``tick_lanes_sparse(donate=True)`` is
the one call that updates this fleet's tensors in place). The fleet's
tensors live on one device, chosen at creation (``device=None`` is the
card); later calls move items there. ``from_jax_state`` / ``to_numpy_state`` carry a fleet's exact state
between this package and the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import frugal, streaming
from repro_torch.core import rng as crng
from repro_torch.core.sketch import GroupedQuantileSketch, PackedSketchState
from repro_torch.kernels import ops as kernel_ops
from repro_torch.resilience import chaos

from .spec import FleetSpec, StreamCursor


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
    API. ``state`` is the lane sketch; ``cursor`` the stream position."""

    state: GroupedQuantileSketch
    cursor: StreamCursor
    spec: FleetSpec

    @classmethod
    def create(cls, spec: FleetSpec, init=0.0, seed: int = 0, key=None,
               cursor: Optional[StreamCursor] = None,
               per_lane_clock: bool = False,
               device=None) -> "QuantileFleet":
        """Fresh fleet at stream position 0 on ``device`` (None: the card;
        raises where there is none). ``seed`` or uint32 key words ``key``
        seed the counter RNG. ``per_lane_clock`` starts the cursor with a
        per-lane [L] tick tensor, the event-stream mode (``tick_lanes``,
        ``tick_lanes_sparse``); block ingest uses the scalar clock."""
        sk = GroupedQuantileSketch.create_lanes(
            spec.num_groups, spec.quantiles, algo=spec.algo, init=init,
            drift=spec.drift, device=device)
        if cursor is None:
            t0 = torch.zeros(spec.num_lanes, dtype=torch.int32,
                             device=sk.device) if per_lane_clock else 0
            cursor = StreamCursor.create(seed=seed, t_offset=t0, key=key)
        return cls(state=sk, cursor=cursor, spec=spec)

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

    # ---------------------------------------------------------------- ingest
    def _require_scalar_clock(self, what: str):
        if self.cursor.per_lane:
            raise ValueError(
                f"{what} needs the scalar stream clock; this fleet uses a "
                "per-lane cursor (event-stream mode) — use tick_lanes")

    def ingest(self, items) -> "QuantileFleet":
        """Ingest a [t, G] block (numpy or tensor); returns the fleet
        advanced t ticks. Bit-identical for any split of a stream into
        successive calls."""
        self._require_scalar_clock("ingest")
        cur = self.cursor
        sk = streaming.ingest_array(
            self.state, items, cur.seed, chunk_t=self.spec.chunk_t,
            t_offset=cur.t_offset, g_offset=cur.g_offset,
            lanes_per_group=self.num_quantiles)
        return dataclasses.replace(
            self, state=sk, cursor=cur.advance(np.shape(items)[0]))

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
            sk = streaming.ingest_stream(
                self.state, counting(), cur.seed, chunk_t=chunk_t,
                t_offset=cur.t_offset, g_offset=cur.g_offset,
                lanes_per_group=self.num_quantiles)
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

    def tick_lanes(self, items, mask=None) -> "QuantileFleet":
        """One tick over all L lanes from lane-level items [L] (NaN = no
        event on that lane: a bit-exact no-op).

        With a per-lane cursor each lane's clock advances only where
        ``mask`` is 1 (default: where items are not NaN), so a lane's k-th
        event always consumes uniform (seed, k, lane). Items on masked-out
        lanes are forced to NaN first: a lane's state never moves without
        its clock. With the scalar clock every lane shares the tick and
        the clock advances by 1; a mask raises there.
        """
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
        """
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
        existing lane's state or uniform stream."""
        if num_groups < self.num_groups:
            raise ValueError(f"cannot shrink {self.num_groups} -> "
                             f"{num_groups}")
        if num_groups == self.num_groups:
            return self
        spec = dataclasses.replace(self.spec, num_groups=num_groups)
        sk = self.state
        fresh = GroupedQuantileSketch.create_lanes(
            num_groups - self.num_groups, spec.quantiles, algo=spec.algo,
            init=init, drift=spec.drift, device=self.device)
        grown = dataclasses.replace(sk, quantile=torch.cat(
            [sk.quantile, fresh.quantile]), **{
                f: torch.cat([getattr(sk, f), getattr(fresh, f)])
                for f in spec.program.layout.plane_fields})
        cur = self.cursor
        if cur.per_lane:
            pad = torch.zeros(spec.num_lanes - self.num_lanes,
                              dtype=torch.int32, device=self.device)
            cur = cur._replace(t_offset=torch.cat([cur.t_offset, pad]))
        return QuantileFleet(state=grown, cursor=cur, spec=spec)

    # ----------------------------------------------------------------- reads
    def query_view(self) -> Tuple[Tuple[np.ndarray, ...], np.ndarray, int,
                                  np.ndarray]:
        """Host-owned ``(m_planes, t_next, seed, lanes)``: copies of the
        layout's query planes, the cursor tick (scalar or per lane), the
        seed and absolute lane ids — the one gathering read behind
        ``estimate()``. Nothing returned aliases a tensor that a later
        ``tick_lanes_sparse(donate=True)`` round updates in place."""
        fields = self.spec.program.layout.query_fields
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

    # ------------------------------------------------------- carry across
    def to_numpy_state(self) -> Tuple[PackedSketchState, StreamCursor]:
        """(packed payload as numpy arrays, cursor): the JAX package's
        ``GroupedQuantileSketch.packed()`` fields and its ``StreamCursor``
        values (a per-lane ``t_offset`` as an [L] int32 numpy array), ready
        to rebuild a JAX fleet at exactly this state."""
        p = self.state.packed()
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
    count and program layout.
    """
    sk = GroupedQuantileSketch.from_packed(packed, drift=spec.drift,
                                           device=device)
    if sk.num_groups != spec.num_lanes:
        raise ValueError(f"payload holds {sk.num_groups} lanes but spec "
                         f"{spec.num_groups}x{spec.num_quantiles} expects "
                         f"{spec.num_lanes}")
    if sk.algo != spec.algo:
        raise ValueError(f"payload is a {sk.algo} sketch but spec program "
                         f"{spec.program.family!r} is {spec.algo}")
    seed, t_offset, g_offset = cursor
    if np.ndim(t_offset):
        t_offset = torch.from_numpy(np.array(t_offset, np.int32)).to(
            sk.device)
        if t_offset.shape[0] != spec.num_lanes:
            raise ValueError(f"per-lane cursor holds {t_offset.shape[0]} "
                             f"clocks, spec expects {spec.num_lanes}")
    return QuantileFleet(state=sk, cursor=StreamCursor.create(
        seed=int(seed), t_offset=t_offset, g_offset=int(g_offset)),
        spec=spec)
