"""Group-axis sharding: the fleet's flattened lane axis split over devices.

Port of the JAX package's ``parallel/group_sharding.py``. The paper's
GROUPBY setting makes lanes independent: a lane's trajectory depends only
on its own items and its own counter-hashed uniforms. So a fleet whose
lanes are split into S shards, one per device, ingests with one dense
kernel call per shard and slab and no traffic between devices; only the
reads (``estimate``, ``unshard``) gather.

Bit-exactness: uniforms key on the absolute (seed, tick, lane) triple, so
shard s, keyed at ``g_offset + s · shard_g`` (its first lane's absolute
id), hashes exactly the uniforms the unsharded fleet would: any shard
count, chunking and ragged lane count reproduces the single-device
trajectory bit for bit.

Ragged lane counts pad up to a multiple of S. Pad lanes sit at the global
tail (real lanes keep their ids), hold the layout's fill values and take
NaN items (bit-exact no-ops), and are dropped on read.

Each shard owns its tensors on its own device (``devices[s]``), never a
view of a shared buffer; a device may repeat in ``devices``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rng as crng
from repro_torch.core import streaming
from repro_torch.core.drift import is_windowed as drift_is_windowed
from repro_torch.core.sketch import GroupedQuantileSketch, PackedSketchState
from repro_torch.resilience import chaos

from .topology import LANE_AXIS, _device_array

GROUP_AXIS = LANE_AXIS


def group_mesh(num_devices: Optional[int] = None) -> np.ndarray:
    """A 1-D mesh of the first ``num_devices`` CUDA devices (all by
    default)."""
    avail = torch.cuda.device_count()
    n = num_devices or avail
    if n < 1 or n > avail:
        raise ValueError(f"group_mesh needs {n} devices, found {avail} CUDA "
                         "device(s)")
    return _device_array([torch.device("cuda", i) for i in range(n)], (n,))


def _mesh_devices(mesh) -> Tuple[torch.device, ...]:
    """A mesh (device sequence or array; None = every CUDA device) as a
    tuple of torch.devices."""
    if mesh is None:
        mesh = group_mesh()
    devs = tuple(torch.device(d)
                 for d in np.asarray(mesh, dtype=object).reshape(-1))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def pad_lane_fill(layout, field: str) -> float:
    """Dummy state for pad lanes: the program layout's fills, plus the
    quantile plane (not a layout plane — it rides every sketch)."""
    return 0.5 if field == "quantile" else layout.pad_fill(field)


def _sketch_from_planes(program, planes, quantile) -> GroupedQuantileSketch:
    """Assemble a sketch from a program-ordered plane tuple — the inverse
    of GroupedQuantileSketch.planes()."""
    fields = {"step": None, "sign": None, "m2": None, "step2": None,
              "sign2": None}
    fields.update(zip(program.layout.plane_fields, planes))
    return GroupedQuantileSketch(quantile=quantile, algo=program.algo,
                                 drift=program.drift, **fields)


def _seed(key, seed) -> int:
    if seed is None:
        if key is None:
            raise ValueError("need key= or seed=")
        seed = key
    return crng.seed_from_key(seed)


def _ingest_stream(fleet, chunks: Iterable, seed: int, chunk_t: int,
                   t_offset: int, g_offset: int, skip_items: int):
    """The placed fleets' host-stream loop: the shared re-chunker's exact
    [chunk_t, G] blocks through ``fleet.ingest_array`` at their absolute
    ticks. A dying source raises a resumable ``chaos.StreamInterrupted``
    whose ``state`` holds every fully-applied chunk; malformed input
    raises as it is."""
    cols = fleet.num_groups // fleet.lanes_per_group
    if skip_items:
        chunks = streaming.drop_leading_items(chunks, skip_items, cols)

    consumed = [0]

    def counted(src):
        for c in src:
            c = streaming._as_2d(c, cols)
            consumed[0] += c.shape[0]
            yield c

    applied = 0
    blocks = streaming.rechunk_blocks(counted(chunks), cols, chunk_t)
    while True:
        try:
            block, t0 = next(blocks)
        except StopIteration:
            break
        except (ValueError, TypeError):
            raise   # malformed input — not resumable
        except Exception as e:
            raise chaos.StreamInterrupted(
                f"stream source failed after {applied} applied "
                f"item(s): {e}", state=fleet, items_applied=applied) from e
        fleet = fleet.ingest_array(
            block, seed=seed, chunk_t=chunk_t,
            t_offset=crng.wrap_i32(int(t_offset) + int(t0)),
            g_offset=g_offset)
        applied = min(consumed[0], applied + chunk_t)
        try:
            chaos.count_event("ingest")
        except chaos.StreamFault as e:
            raise chaos.StreamInterrupted(
                f"stream fault after {applied} applied item(s): {e}",
                state=fleet, items_applied=applied) from e
    return fleet


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGroupFleet:
    """A GroupedQuantileSketch whose lane axis is split over devices.

    ``shards[s]`` holds lanes [s · shard_g, (s + 1) · shard_g) of the
    padded lane axis on ``devices[s]``; ``num_groups`` counts the real
    lanes. For a (G × Q) lane plane (``lanes_per_group`` = Q > 1) ingest
    takes [T, G] group columns: over several shards they are fanned out
    Q-fold before the split; a one-shard fleet hands the columns to the
    kernel, which fans them out by index (the same bits).
    """

    shards: Tuple[GroupedQuantileSketch, ...]
    num_groups: int
    devices: Tuple[torch.device, ...]
    lanes_per_group: int = 1

    # ------------------------------------------------------------ properties
    @property
    def algo(self) -> str:
        return self.shards[0].algo

    @property
    def mesh(self) -> np.ndarray:
        """The port's 1-D mesh: the shards' devices as an object array."""
        return _device_array(self.devices, (len(self.devices),))

    @property
    def device(self) -> torch.device:
        """The first shard's device, where gathers land."""
        return self.devices[0]

    @property
    def shard_groups(self) -> int:
        return self.shards[0].num_groups

    @property
    def padded_groups(self) -> int:
        return self.shard_groups * len(self.shards)

    def memory_words(self) -> int:
        """Persistent words per lane — the same as unsharded."""
        return self.shards[0].memory_words()

    # -------------------------------------------------------------- creation
    @staticmethod
    def create(num_groups: int, quantile=0.5, algo: str = "2u", init=0.0,
               mesh=None, drift=None) -> "ShardedGroupFleet":
        devices = _mesh_devices(mesh)
        sk = GroupedQuantileSketch.create(num_groups, quantile=quantile,
                                          algo=algo, init=init, drift=drift,
                                          device=devices[0])
        return ShardedGroupFleet.from_sketch(sk, devices)

    @staticmethod
    def from_sketch(sketch: GroupedQuantileSketch, mesh=None,
                    lanes_per_group: int = 1) -> "ShardedGroupFleet":
        """Split a sketch's lanes over ``mesh`` (a device sequence or
        array; None = every CUDA device). Every shard is a copy; the
        sketch is left as it was."""
        devices = _mesh_devices(mesh)
        g = sketch.num_groups
        if g % lanes_per_group:
            raise ValueError(f"sketch lanes {g} not divisible by "
                             f"lanes_per_group={lanes_per_group}")
        n = len(devices)
        gp = -(-g // n) * n
        w = gp // n
        program = sketch.program
        layout = program.layout

        def pieces(x, field):
            x = torch.broadcast_to(torch.as_tensor(
                x, dtype=torch.float32, device=sketch.device), (g,))
            if gp != g:
                x = torch.cat([x, torch.full(
                    (gp - g,), pad_lane_fill(layout, field),
                    dtype=torch.float32, device=sketch.device)])
            return [x[s * w:(s + 1) * w].to(d, copy=True)
                    for s, d in enumerate(devices)]

        planes = [pieces(getattr(sketch, f), f) for f in layout.plane_fields]
        quantile = pieces(sketch.quantile, "quantile")
        shards = tuple(_sketch_from_planes(program,
                                           tuple(p[s] for p in planes),
                                           quantile[s])
                       for s in range(n))
        return ShardedGroupFleet(shards=shards, num_groups=g,
                                 devices=devices,
                                 lanes_per_group=lanes_per_group)

    # ---------------------------------------------------------------- ingest
    def _pad_items(self, items) -> Tuple[torch.Tensor, int]:
        """(x, q): ``items`` as a float32 tensor on the first shard's device
        whose padded lane l reads column l // q. Accepts [T, G] group
        columns, [T, L] real lanes or [T, Gp] padded lanes; pad lanes read
        NaN."""
        x = items.to(torch.float32) if isinstance(items, torch.Tensor) \
            else torch.from_numpy(np.asarray(items, np.float32))
        if x.dim() == 1:
            x = x[:, None]
        gp = self.padded_groups
        q = self.lanes_per_group
        cols = self.num_groups // q
        ok = {self.num_groups, gp} | ({cols} if q > 1 else set())
        if x.dim() != 2 or x.shape[1] not in ok:
            raise ValueError(f"items shape {tuple(x.shape)} != [T, {cols}]")
        x = x.to(self.device)
        if q > 1 and x.shape[1] == cols:
            if len(self.shards) == 1:
                return x, q
            x = x.repeat_interleave(q, dim=1)
        if x.shape[1] != gp:
            x = torch.cat([x, torch.full((x.shape[0], gp - x.shape[1]),
                                         float("nan"), device=x.device)], 1)
        return x, 1

    def _ingest_slabs(self, slabs, offsets, seed: int, g_offset: int,
                      q: int) -> "ShardedGroupFleet":
        """Shard s ingests its columns of every slab (slab k at absolute
        tick ``offsets[k]``) through ``core.streaming.ingest_slabs``, keyed
        at its first lane's absolute id. ``slabs`` come from
        ``_pad_items`` (lane l reads column l // q)."""
        w = self.shard_groups
        cw = w // q
        shards = tuple(
            streaming.ingest_slabs(
                sh, [x[:, s * cw:(s + 1) * cw] for x in slabs], offsets,
                seed, crng.wrap_i32(g_offset + s * w), lanes_per_group=q)
            for s, sh in enumerate(self.shards))
        return dataclasses.replace(self, shards=shards)

    def ingest_array(self, items, key=None, chunk_t: int = 4096, *,
                     seed=None, t_offset: int = 0,
                     g_offset: int = 0) -> "ShardedGroupFleet":
        """Sharded ``core.streaming.ingest_array``: every shard runs its
        own [chunk_t, shard_g] kernel calls; no data moves between
        devices. ``t_offset`` is the absolute tick of items[0], ``g_offset``
        the absolute lane id of lane 0. Bit-identical to the unsharded
        call."""
        if chunk_t <= 0:
            raise ValueError(f"chunk_t must be positive, got {chunk_t}")
        seed = _seed(key, seed)
        x, q = self._pad_items(items)
        t0 = int(t_offset)
        rows = range(0, x.shape[0], chunk_t)
        return self._ingest_slabs([x[r:r + chunk_t] for r in rows],
                                  [crng.wrap_i32(t0 + r) for r in rows],
                                  seed, int(g_offset), q)

    def ingest_stream(self, chunks: Iterable, key=None, chunk_t: int = 4096,
                      *, seed=None, t_offset: int = 0, g_offset: int = 0,
                      skip_items: int = 0) -> "ShardedGroupFleet":
        """Sharded ``core.streaming.ingest_stream``: the same re-chunker,
        one sharded ingest per [chunk_t, G] block. A dying source raises a
        resumable ``chaos.StreamInterrupted`` whose ``state`` holds every
        fully-applied chunk; ``skip_items=err.items_applied`` replays only
        the rest, bit-exact."""
        return _ingest_stream(self, chunks, _seed(key, seed), chunk_t,
                              t_offset, g_offset, skip_items)

    # ----------------------------------------------------------------- reads
    def host_planes(self, fields=None) -> Tuple[np.ndarray, ...]:
        """Host-owned [L] copies of the named planes (all layout planes by
        default), pad lanes dropped."""
        layout = self.shards[0].program.layout
        fields = layout.plane_fields if fields is None else fields
        n = self.num_groups
        return tuple(torch.cat([getattr(sh, f).cpu() for sh in self.shards])
                     [:n].numpy() for f in fields)

    def estimate(self, t_next=None) -> np.ndarray:
        """Per-lane estimates [L]; only the program's query planes are
        gathered. A window program needs the absolute tick ``t_next``
        (``repro_torch.api.QuantileFleet`` threads it)."""
        prog = self.shards[0].program
        return prog.run_query(self.host_planes(prog.layout.query_fields),
                              t_next=t_next)

    def unshard(self, device=None) -> GroupedQuantileSketch:
        """The real lanes gathered into one sketch on ``device`` (None: the
        first shard's)."""
        device = self.device if device is None else torch.device(device)
        n = self.num_groups

        def take(f):
            return torch.cat([getattr(sh, f).to(device)
                              for sh in self.shards])[:n]

        prog = self.shards[0].program
        return _sketch_from_planes(
            prog, tuple(take(f) for f in prog.layout.plane_fields),
            take("quantile"))

    # -------------------------------------------------------- serialization
    def packed(self) -> PackedSketchState:
        """Checkpoint payload: 1-2 words per real lane."""
        return self.unshard().packed()

    @staticmethod
    def from_packed(p: PackedSketchState, mesh=None,
                    drift=None) -> "ShardedGroupFleet":
        """Re-place a saved payload onto ``mesh``. ``drift`` must restate
        the fleet's DriftConfig (the payload carries plane data only); a
        shadow-plane mismatch is refused."""
        has_shadow = getattr(p, "m2", None) is not None
        if has_shadow != drift_is_windowed(drift):
            raise ValueError(
                f"packed payload {'has' if has_shadow else 'lacks'} a window "
                f"shadow plane but drift={drift!r} — pass the fleet's "
                "original DriftConfig")
        devices = _mesh_devices(mesh)
        return ShardedGroupFleet.from_sketch(
            GroupedQuantileSketch.from_packed(p, drift=drift,
                                              device=devices[0]), devices)


__all__ = ["GROUP_AXIS", "ShardedGroupFleet", "group_mesh", "pad_lane_fill"]
