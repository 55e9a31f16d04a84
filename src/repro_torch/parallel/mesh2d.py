"""2-D (data × lane) fleets: stream replicas over lane shards.

Port of the JAX package's ``parallel/mesh2d.py`` (DESIGN.md §15). The lane
axis splits as in ``group_sharding``; the data axis adds R replicas of
the same lanes, each fed a disjoint share of the stream, merged on read
and on ``sync`` by a pinned rule.

Chunk assignment: chunk c (absolute ticks [c·chunk_t, (c + 1)·chunk_t))
belongs to replica ``c mod R``, a function of the absolute tick and never
of call boundaries. A replica ingests its chunks at their true offsets,
so its state equals a single fleet that ingested exactly its chunks. A
call that starts or ends mid-chunk NaN-pads the partial rows, and a call
rounds its chunk count up to a multiple of R with all-NaN chunks, as the
JAX package does: NaN ticks are no-ops.

The pinned merge rule folds each plane by its invariant domain
(``StateLayout.invariants``) in replica order:

    finite (estimate heads):  running mean, acc += (x - acc) / (r + 1)
    step   (step planes):     elementwise max
    sign   (sign planes):     replica 0's value

It uses IEEE float32 elementwise operations only, so numpy on the host
and torch on a device give the same bits; no reduction of unspecified
order (``all_reduce``) appears.

Execution modes:
  * ``"devices"`` when the topology holds a device tuple: replica r's lane
    shard s owns its tensors on device ``r·lanes + s``; ingest is one
    dense kernel call per shard and slab; ``sync`` folds each lane
    shard's R replica tensors on replica 0's device and copies the result
    back to every replica.
  * ``"loop"`` otherwise: the R replicas' [L] tensors live on the fleet's
    one device and the replicas run one after another.

Both run ``core.streaming.ingest_slabs`` per replica, which is why they
give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rng as crng
from repro_torch.core.sketch import GroupedQuantileSketch, PackedSketchState

from .group_sharding import (ShardedGroupFleet, _ingest_stream, _seed,
                             _sketch_from_planes, pad_lane_fill)
from .topology import DATA_AXIS, LANE_AXIS, TopologySpec


def _divisor(xp, n: int, like):
    if xp is np:
        return np.float32(n)
    # A float32 tensor on the operands' device, never a Python number: CUDA
    # true division by a CPU scalar multiplies by its reciprocal, which is
    # not the IEEE quotient wherever 1/n is inexact (n = 3, 5, 6, ...).
    return torch.full((), n, dtype=torch.float32, device=like.device)


def _fold_domain(stack, domain: str, xp):
    """Fixed replica-order left fold of stack[R, ...] per invariant
    domain; ``xp`` is numpy or torch."""
    acc = stack[0]
    if domain == "sign":
        return acc
    for r in range(1, stack.shape[0]):
        if domain == "finite":
            acc = acc + (stack[r] - acc) / _divisor(xp, r + 1, acc)
        elif domain == "step":
            acc = xp.maximum(acc, stack[r])
        else:
            raise ValueError(f"unknown invariant domain {domain!r}")
    return acc


def merge_replica_planes(program, planes: Tuple, xp=np) -> Tuple:
    """THE pinned merge: fold each [R, ...] plane by its layout-declared
    invariant domain. ``xp`` selects numpy (host arrays) or torch (tensors
    on any device) — the same bits either way."""
    domains = dict(program.layout.invariants)
    return tuple(_fold_domain(p, domains[f], xp)
                 for f, p in zip(program.layout.plane_fields, planes))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2DFleet:
    """A lane fleet replicated R ways over a (data × lane) topology.

    ``replicas[r]`` is replica r's lanes as a ShardedGroupFleet: split over
    its row of the topology's devices (mode "devices"), or one [L] shard
    on the fleet's device (mode "loop"). ``num_groups`` counts real lanes.

    Replicas drift apart between syncs by design; ``merged()`` and
    ``estimate()`` answer through the pinned merge without touching state,
    and ``sync()`` writes the merged state back to every replica.
    """

    replicas: Tuple[ShardedGroupFleet, ...]
    num_groups: int
    topology: TopologySpec
    lanes_per_group: int = 1

    # ------------------------------------------------------------ properties
    @property
    def algo(self) -> str:
        return self.replicas[0].algo

    @property
    def program(self):
        return self.replicas[0].shards[0].program

    @property
    def data_replicas(self) -> int:
        return self.topology.data

    @property
    def padded_groups(self) -> int:
        """Lanes each replica holds, pad lanes included."""
        return self.replicas[0].padded_groups

    @property
    def shard_groups(self) -> int:
        return self.replicas[0].shard_groups

    @property
    def mode(self) -> str:
        """'devices' (per-device tensors) or 'loop' (one device)."""
        return "devices" if self.topology.on_devices else "loop"

    @property
    def device(self) -> torch.device:
        """Replica 0's first device, where merged reads land."""
        return self.replicas[0].device

    def memory_words(self) -> int:
        """Persistent words per lane per REPLICA (the data axis multiplies
        the footprint R-fold)."""
        return self.replicas[0].memory_words()

    def mesh(self) -> np.ndarray:
        return self.topology.mesh2d()

    # -------------------------------------------------------------- creation
    @staticmethod
    def from_sketch(sketch: GroupedQuantileSketch, topology: TopologySpec,
                    lanes_per_group: int = 1) -> "Mesh2DFleet":
        """Replicate a canonical [L] sketch across the data axis (every
        replica starts at it — a sync point). In loop mode the fleet lives
        on the sketch's device."""
        if sketch.num_groups % lanes_per_group:
            raise ValueError(f"sketch lanes {sketch.num_groups} not "
                             f"divisible by lanes_per_group="
                             f"{lanes_per_group}")
        return Mesh2DFleet._build([sketch] * topology.data, topology,
                                  lanes_per_group)

    @staticmethod
    def from_replica_planes(like: GroupedQuantileSketch, planes: Tuple,
                            quantile, topology: TopologySpec,
                            lanes_per_group: int = 1) -> "Mesh2DFleet":
        """Lay explicit per-replica [R, L] planes (arrays or tensors) out on
        ``topology`` with the same R — the elastic relayout: every
        replica's lanes carry over bit for bit, no merge happens. ``like``
        gives the program and, in loop mode, the device."""
        r = topology.data
        for p in planes:
            if p.shape[0] != r:
                raise ValueError(
                    f"replica planes carry R={p.shape[0]} but topology "
                    f"data={r} — resharding across a DIFFERENT replica "
                    "count passes through merged() (a sync point)")

        def row(x, i):
            return torch.as_tensor(x[i], dtype=torch.float32,
                                   device=like.device)

        sketches = [_sketch_from_planes(like.program,
                                        tuple(row(p, i) for p in planes),
                                        row(quantile, i))
                    for i in range(r)]
        return Mesh2DFleet._build(sketches, topology, lanes_per_group)

    @staticmethod
    def _build(sketches, topology: TopologySpec,
               lanes_per_group: int) -> "Mesh2DFleet":
        """Place R canonical [L] sketches, replica r from sketches[r]."""
        topology = topology.resolve()
        s = topology.lanes
        if topology.on_devices:
            rows = [topology.devices[r * s:(r + 1) * s]
                    for r in range(topology.data)]
        else:
            rows = [(sketches[0].device,)] * topology.data
        replicas = tuple(ShardedGroupFleet.from_sketch(
            sk, rows[r], lanes_per_group=lanes_per_group)
            for r, sk in enumerate(sketches))
        return Mesh2DFleet(replicas=replicas,
                           num_groups=sketches[0].num_groups,
                           topology=topology,
                           lanes_per_group=lanes_per_group)

    # ---------------------------------------------------------------- ingest
    def _pad_items(self, items) -> Tuple[torch.Tensor, int]:
        """[T, G] group columns, [T, L] lanes or [T, Gp] padded lanes as
        ShardedGroupFleet._pad_items gives them to every replica."""
        return self.replicas[0]._pad_items(items)

    def _slab_layout(self, t: int, t0: int, chunk_t: int):
        """Host-side chunk→replica assignment off the ABSOLUTE tick.

        Returns (lead, pad_rows, idx[R, S], offsets[R, S]): the call's rows
        sit behind ``lead`` NaN rows (t0 mod chunk_t — rows of the current
        chunk that earlier calls applied) and before ``pad_rows``, cut into
        chunk_t-row chunks whose count is a multiple of R; chunk j of this
        call goes to replica (c0 + j) mod R, c0 the absolute index of the
        call's first chunk. idx[r] lists replica r's chunks in tick order;
        offsets are the absolute (wrapped int32) tick of each one's row 0.
        """
        r_count = self.data_replicas
        lead = t0 % chunk_t
        base = t0 - lead
        total = lead + t
        n_chunks = -(-total // chunk_t)
        n_chunks = -(-n_chunks // r_count) * r_count
        pad_rows = n_chunks * chunk_t - total
        c0 = (base // chunk_t) % r_count
        k = np.arange(n_chunks // r_count, dtype=np.int64)
        idx = np.stack([((r - c0) % r_count) + k * r_count
                        for r in range(r_count)])
        offsets = ((np.asarray(base, np.int64) + idx * chunk_t)
                   & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)
        return lead, pad_rows, idx, offsets

    def ingest_array(self, items, key=None, chunk_t: int = 4096, *,
                     seed=None, t_offset: int = 0,
                     g_offset: int = 0) -> "Mesh2DFleet":
        """Chunks route to replicas by absolute tick; each replica ingests
        its slabs at their true offsets, with no data moving between
        replicas (they merge only on read and sync). ``t_offset`` is a host
        int. Invariant to how a stream is split into calls.

        A chunk that lies wholly inside ``items`` is a row view of it; a
        chunk cut by the call's edges is a NaN-filled copy, and the chunks
        that round the call up to a multiple of R share one all-NaN
        buffer."""
        if chunk_t <= 0:
            raise ValueError(f"chunk_t must be positive, got {chunk_t}")
        seed = _seed(key, seed)
        t0 = crng.wrap_i32(int(t_offset))
        x, q = self._pad_items(items)
        t = x.shape[0]
        if t == 0:
            return self
        lead, _, idx, offsets = self._slab_layout(t, t0, chunk_t)
        empty = []

        def chunk(j: int) -> torch.Tensor:
            a = j * chunk_t - lead
            if 0 <= a and a + chunk_t <= t:
                return x[a:a + chunk_t]
            lo, hi = max(a, 0), min(a + chunk_t, t)
            if lo >= hi:
                if not empty:
                    empty.append(torch.full((chunk_t, x.shape[1]),
                                            float("nan"), device=x.device))
                return empty[0]
            buf = torch.full((chunk_t, x.shape[1]), float("nan"),
                             device=x.device)
            buf[lo - a:hi - a] = x[lo:hi]
            return buf

        g0 = crng.wrap_i32(int(g_offset))
        replicas = tuple(
            rep._ingest_slabs([chunk(int(j)) for j in idx[r]],
                              [int(o) for o in offsets[r]], seed, g0, q)
            for r, rep in enumerate(self.replicas))
        return dataclasses.replace(self, replicas=replicas)

    def ingest_stream(self, chunks: Iterable, key=None, chunk_t: int = 4096,
                      *, seed=None, t_offset: int = 0, g_offset: int = 0,
                      skip_items: int = 0) -> "Mesh2DFleet":
        """Host-stream ingest with the crash-consistency contract of the
        other placements: the shared re-chunker yields exact [chunk_t, G]
        blocks, each landing wholly on one replica, and a dying source
        raises a resumable ``chaos.StreamInterrupted`` at a chunk
        boundary."""
        return _ingest_stream(self, chunks, _seed(key, seed), chunk_t,
                              t_offset, g_offset, skip_items)

    # ----------------------------------------------------------------- reads
    def replica_sketches(self) -> Tuple[GroupedQuantileSketch, ...]:
        """Each replica's real lanes as one [L] sketch on the fleet's
        device (copies)."""
        return tuple(rep.unshard(self.device) for rep in self.replicas)

    def replica_planes(self, fields=None) -> Tuple[np.ndarray, ...]:
        """Host [R, L] copies of the named planes (all layout planes by
        default), pad lanes dropped — the bit-preserving view."""
        per = [rep.host_planes(fields) for rep in self.replicas]
        return tuple(np.stack(p) for p in zip(*per))

    def merged_planes(self, fields: Optional[Tuple[str, ...]] = None
                      ) -> Tuple[np.ndarray, ...]:
        """Host [L] canonical planes through the pinned merge, folded in
        numpy. With ``fields`` only those planes move (estimate moves the
        query heads, never step or sign)."""
        layout = self.program.layout
        fields = layout.plane_fields if fields is None else fields
        domains = dict(layout.invariants)
        return tuple(_fold_domain(p, domains[f], np)
                     for f, p in zip(fields, self.replica_planes(fields)))

    def unshard(self) -> GroupedQuantileSketch:
        """The merged canonical [L] sketch on the fleet's device — what
        health scans and checkpoints read. Replica state is not changed
        (``sync`` writes it back)."""
        prog = self.program
        merged = tuple(torch.from_numpy(p.copy()).to(self.device)
                       for p in self.merged_planes())
        quantile = self.replicas[0].unshard().quantile
        return _sketch_from_planes(prog, merged, quantile)

    def merged(self) -> GroupedQuantileSketch:
        return self.unshard()

    def estimate(self, t_next=None) -> np.ndarray:
        """Merged per-lane estimates [L] (a window program needs the
        absolute tick ``t_next``; the facade threads it)."""
        prog = self.program
        return prog.run_query(self.merged_planes(prog.layout.query_fields),
                              t_next=t_next)

    # ------------------------------------------------------------------ sync
    def sync(self) -> "Mesh2DFleet":
        """Write the pinned-merged state back to every replica. For each
        lane shard, the R replicas' tensors are stacked on replica 0's
        device for that shard, folded there in replica order, and copied
        back to each replica's device. Equal to the numpy fold, and
        idempotent."""
        layout = self.program.layout
        domains = dict(layout.invariants)
        n_shards = len(self.replicas[0].shards)
        shards = [[None] * n_shards for _ in self.replicas]
        for s in range(n_shards):
            dev = self.replicas[0].shards[s].device
            folded = tuple(
                _fold_domain(torch.stack([
                    getattr(rep.shards[s], f).to(dev)
                    for rep in self.replicas]), domains[f], torch)
                for f in layout.plane_fields)
            for r, rep in enumerate(self.replicas):
                sh = rep.shards[s]
                shards[r][s] = sh.with_planes(
                    tuple(p.to(sh.device, copy=True) for p in folded))
        return dataclasses.replace(self, replicas=tuple(
            dataclasses.replace(rep, shards=tuple(shards[r]))
            for r, rep in enumerate(self.replicas)))

    # ------------------------------------------------------------------ grow
    def grow(self, fresh: GroupedQuantileSketch) -> "Mesh2DFleet":
        """Append ``fresh`` lanes (canonical [ΔL] state) to every replica
        without touching existing lanes: lane ids are absolute, so old
        lanes keep their uniform streams; new lanes start equal on every
        replica and diverge as chunks arrive. Not a sync point."""
        prog = self.program

        def cat(a, b):
            return torch.cat([a, b.to(a.device, torch.float32)])

        grown = [_sketch_from_planes(
            prog, tuple(cat(a, b) for a, b in zip(sk.planes(),
                                                   fresh.planes())),
            cat(sk.quantile, torch.broadcast_to(
                torch.as_tensor(fresh.quantile), (fresh.num_groups,))))
            for sk in self.replica_sketches()]
        return Mesh2DFleet._build(grown, self.topology, self.lanes_per_group)

    # -------------------------------------------------------- serialization
    def packed(self) -> PackedSketchState:
        """Checkpoint payload: the MERGED canonical lanes (a checkpoint is a
        sync point), so a restore onto ANY topology seeds every replica
        with the same state."""
        return self.unshard().packed()


__all__ = ["DATA_AXIS", "LANE_AXIS", "Mesh2DFleet", "TopologySpec",
           "merge_replica_planes", "pad_lane_fill"]
