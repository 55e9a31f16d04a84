"""QuantileFleet — the fleet API of the port (single placement).

    spec  = FleetSpec(num_groups=4096, quantiles=(0.5, 0.95, 0.99))
    fleet = QuantileFleet.create(spec, seed=0)          # on the card
    fleet = fleet.ingest(items)                         # [t, G] block
    fleet = fleet.ingest_stream(chunks)                 # unbounded stream
    fleet.estimate()                                    # [G, Q] numpy

Functional like the JAX package's facade: every ingest returns a new
fleet whose cursor has advanced. The fleet's tensors live on one device,
chosen at creation (``device=None`` is the card); later calls move items
there. ``from_jax_state`` / ``to_numpy_state`` carry a fleet's exact state
between this package and the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import streaming
from repro_torch.core.sketch import GroupedQuantileSketch, PackedSketchState
from repro_torch.resilience import chaos

from .spec import FleetSpec, StreamCursor


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
               device=None) -> "QuantileFleet":
        """Fresh fleet at stream position 0 on ``device`` (None: the card;
        raises where there is none). ``seed`` or uint32 key words ``key``
        seed the counter RNG."""
        sk = GroupedQuantileSketch.create_lanes(
            spec.num_groups, spec.quantiles, algo=spec.algo, init=init,
            drift=spec.drift, device=device)
        if cursor is None:
            cursor = StreamCursor.create(seed=seed, key=key)
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
    def ingest(self, items) -> "QuantileFleet":
        """Ingest a [t, G] block (numpy or tensor); returns the fleet
        advanced t ticks. Bit-identical for any split of a stream into
        successive calls."""
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

    # ----------------------------------------------------------------- reads
    def query_view(self) -> Tuple[Tuple[np.ndarray, ...], np.ndarray, int,
                                  np.ndarray]:
        """Host-owned ``(m_planes, t_next, seed, lanes)``: copies of the
        layout's query planes, the cursor tick, the seed and absolute lane
        ids — the one gathering read behind ``estimate()``."""
        fields = self.spec.program.layout.query_fields
        m_planes = tuple(getattr(self.state, f).cpu().numpy().copy()
                         for f in fields)
        cur = self.cursor
        t_next = np.array(cur.t_offset, dtype=np.int32)
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
        values, ready to rebuild a JAX fleet at exactly this state."""
        p = self.state.packed()
        return PackedSketchState(*(None if x is None else x.cpu().numpy()
                                   for x in p)), self.cursor


def from_jax_state(spec: FleetSpec, packed, cursor,
                   device=None) -> QuantileFleet:
    """A port fleet that continues exactly where a JAX fleet stands.

    ``packed`` holds the JAX sketch's ``packed()`` fields (``m``,
    ``step_sign``, ``quantile``, ``m2``, ``step_sign2``) as numpy arrays
    (or tensors); ``cursor`` is the JAX ``StreamCursor`` as three ints
    (seed, t_offset, g_offset). The payload must match ``spec``'s lane
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
    seed, t_offset, g_offset = (int(x) for x in cursor)
    return QuantileFleet(state=sk, cursor=StreamCursor.create(
        seed=seed, t_offset=t_offset, g_offset=g_offset), spec=spec)
