"""Chunked streaming ingest — unbounded streams over the dense kernel.

Port of the JAX package's ``core/streaming.py``. The uniforms key on the
absolute tick (a running ``t_offset`` threads through the chunks), so the
final state is bit-identical for any chunking and equal to one unchunked
ingest of the concatenated stream.

A stream is an iterable of [t_i, G] blocks, numpy arrays or torch tensors.
The re-chunker keeps a tensor block on the device it came on and hands on
chunk-aligned rows of it as views, without a copy; numpy rows are staged on
the host and copied to the sketch's device once per block.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.resilience import chaos

from . import rng as crng
from .sketch import GroupedQuantileSketch


def _as_2d(chunk, num_groups: int):
    """A [t, G] float32 block (numpy array or tensor, as given)."""
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.to(torch.float32)
    else:
        chunk = np.asarray(chunk, np.float32)
    if chunk.ndim == 1:
        if num_groups != 1:
            raise ValueError(
                f"1-D chunk for a {num_groups}-group sketch; pass [t, G] "
                "blocks")
        chunk = chunk[:, None]
    if chunk.ndim != 2 or chunk.shape[1] != num_groups:
        raise ValueError(f"chunk shape {tuple(chunk.shape)} != "
                         f"[t, {num_groups}]")
    return chunk


def drop_leading_items(chunks: Iterable, skip: int, num_groups: int):
    """Drop the first ``skip`` rows of a [t_i, G] block stream (the resume
    half of crash-consistent ingest)."""
    remaining = int(skip)
    if remaining < 0:
        raise ValueError(f"skip_items must be >= 0, got {skip}")
    for chunk in chunks:
        chunk = _as_2d(chunk, num_groups)
        if remaining:
            take = min(remaining, chunk.shape[0])
            remaining -= take
            if take == chunk.shape[0]:
                continue
            chunk = chunk[take:]
        yield chunk


def rechunk_blocks(chunks: Iterable, num_groups: int, chunk_t: int,
                   device=None):
    """Re-chunk a stream of [t_i, G] blocks into exact [chunk_t, G] blocks,
    yielding (block, t_offset) with t_offset the stream tick of block[0]
    relative to the stream start (int32-wrapped). The final partial block is
    NaN-padded (NaN ticks are bit-exact no-ops).

    Rows that arrive chunk-aligned in a tensor are yielded as views of it.
    Other rows are staged in a buffer on ``device`` (by default the device
    of the first chunk staged, host memory for numpy), so rows from any
    source are copied there once, and each staged block is yielded as a
    fresh copy: no yielded block aliases the staging buffer.
    """
    if chunk_t <= 0:
        raise ValueError(f"chunk_t must be positive, got {chunk_t}")
    buf = None
    fill = 0          # valid rows currently staged in buf
    t_offset = 0      # stream tick of the next block's row 0
    for chunk in chunks:
        chunk = _as_2d(chunk, num_groups)
        pos = 0
        n = chunk.shape[0]
        while pos < n:
            if fill == 0 and n - pos >= chunk_t \
                    and isinstance(chunk, torch.Tensor):
                yield chunk[pos:pos + chunk_t], crng.wrap_i32(t_offset)
                t_offset += chunk_t
                pos += chunk_t
                continue
            if buf is None:
                if device is None and isinstance(chunk, torch.Tensor):
                    device = chunk.device
                buf = (np.empty((chunk_t, num_groups), np.float32)
                       if device is None
                       else torch.empty((chunk_t, num_groups),
                                        dtype=torch.float32, device=device))
            take = min(chunk_t - fill, n - pos)
            rows = chunk[pos:pos + take]
            if isinstance(buf, torch.Tensor):
                buf[fill:fill + take] = torch.as_tensor(rows,
                                                        device=buf.device)
            else:
                buf[fill:fill + take] = (rows.cpu().numpy()
                                         if isinstance(rows, torch.Tensor)
                                         else rows)
            fill += take
            pos += take
            if fill == chunk_t:
                yield _copy(buf), crng.wrap_i32(t_offset)
                t_offset += chunk_t
                fill = 0
    if fill:
        buf[fill:] = float("nan")
        yield _copy(buf), crng.wrap_i32(t_offset)


def _copy(buf):
    return buf.clone() if isinstance(buf, torch.Tensor) else buf.copy()


def _to_device(block, device) -> torch.Tensor:
    if isinstance(block, torch.Tensor):
        return block.to(device)
    return torch.from_numpy(block).to(device)


def _apply_chunk(sk: GroupedQuantileSketch, chunk: torch.Tensor, seed,
                 t_offset, g_offset=0, lanes_per_group=1, plain=False):
    """One dense-kernel call over a [chunk_t, G] block at absolute
    ``t_offset`` for every registered program; ``plain`` runs the plain
    loop (``process_seeded``) instead, on the sketch's device."""
    from repro_torch.kernels import ops

    if plain:
        return sk.process_seeded(chunk, seed, t_offset=t_offset,
                                 g_offset=g_offset,
                                 lanes_per_group=lanes_per_group)
    planes = ops.frugal_update_auto(
        chunk, sk.planes(), sk.quantile, seed=seed, program=sk.program,
        t_offset=t_offset, g_offset=g_offset,
        lanes_per_group=lanes_per_group)
    return sk.with_planes(planes)


def ingest_stream(sketch: GroupedQuantileSketch, chunks: Iterable, seed,
                  chunk_t: int = 4096, g_offset: int = 0, t_offset: int = 0,
                  *, lanes_per_group: int = 1, skip_items: int = 0,
                  plain: bool = False) -> GroupedQuantileSketch:
    """Ingest an unbounded stream of [t_i, G] blocks in [chunk_t, G] kernel
    calls. ``seed`` is the int32 counter seed (``core.rng.seed_from_key``),
    ``t_offset`` the absolute tick of the first item, ``g_offset`` the
    absolute lane id of lane 0; ``lanes_per_group`` = Q drives a G·Q lane
    sketch from G-column blocks. ``plain=True`` applies each block with
    the plain loop instead of the kernel (the same bits).

    Crash consistency: if the chunk iterator raises mid-stream, the error is
    re-raised as a resumable ``chaos.StreamInterrupted`` whose ``state``
    holds every fully-applied chunk and whose ``items_applied`` counts the
    committed leading items; a partially staged block is discarded.
    Re-feeding the same stream with ``skip_items=items_applied`` ends
    bit-identical to the uninterrupted run.
    """
    seed = crng.seed_from_key(seed)
    num_cols = sketch.num_groups // lanes_per_group
    if num_cols * lanes_per_group != sketch.num_groups:
        raise ValueError(
            f"sketch lanes {sketch.num_groups} not divisible by "
            f"lanes_per_group={lanes_per_group}")
    if skip_items:
        chunks = drop_leading_items(chunks, skip_items, num_cols)

    consumed = [0]   # real rows handed to the re-chunker so far

    def counted(src):
        for c in src:
            c = _as_2d(c, num_cols)
            consumed[0] += c.shape[0]
            yield c

    applied = 0
    blocks = rechunk_blocks(counted(chunks), num_cols, chunk_t,
                            sketch.device)
    while True:
        try:
            with tracing.span("stream.next_block"):
                block, t0 = next(blocks)
        except StopIteration:
            break
        except (ValueError, TypeError):
            raise   # malformed input (chunk shape, chunk_t) — not resumable
        except Exception as e:
            raise chaos.StreamInterrupted(
                f"stream source failed after {applied} applied item(s): {e}",
                state=sketch, items_applied=applied) from e
        sketch = _apply_chunk(sketch, _to_device(block, sketch.device), seed,
                              crng.wrap_i32(t_offset + t0), g_offset,
                              lanes_per_group, plain)
        applied = min(consumed[0], applied + chunk_t)
        sketch = chaos.corrupt_sketch(sketch, t_offset + int(t0),
                                      t_offset + int(t0) + chunk_t)
        try:
            chaos.count_event("ingest")
        except chaos.StreamFault as e:
            raise chaos.StreamInterrupted(
                f"stream fault after {applied} applied item(s): {e}",
                state=sketch, items_applied=applied) from e
    return sketch


def ingest_array(sketch: GroupedQuantileSketch, items, seed,
                 chunk_t: int = 4096, g_offset: int = 0, *, t_offset=0,
                 lanes_per_group: int = 1,
                 plain: bool = False) -> GroupedQuantileSketch:
    """Ingest a [T, G] array in ``chunk_t``-row kernel calls (views, no
    copies; the tail is one shorter call), or with ``plain=True`` in
    plain-loop calls over the same rows. Bit-identical to
    ``ingest_stream`` over any chunking of ``items``."""
    if chunk_t <= 0:
        raise ValueError(f"chunk_t must be positive, got {chunk_t}")
    num_cols = sketch.num_groups // lanes_per_group
    if num_cols * lanes_per_group != sketch.num_groups:
        raise ValueError(
            f"sketch lanes {sketch.num_groups} not divisible by "
            f"lanes_per_group={lanes_per_group}")
    items = _to_device(_as_2d(items, num_cols), sketch.device)
    t = items.shape[0]
    seed = crng.seed_from_key(seed)
    offsets = t_offset + np.arange(0, t, chunk_t, dtype=np.int64)
    return ingest_slabs(sketch, [items[r:r + chunk_t]
                                 for r in range(0, t, chunk_t)],
                        offsets, seed, g_offset,
                        lanes_per_group=lanes_per_group, plain=plain)


def ingest_slabs(sketch: GroupedQuantileSketch, slabs, offsets, seed,
                 g_offset, *, lanes_per_group: int = 1, plain: bool = False
                 ) -> GroupedQuantileSketch:
    """Apply item slabs to ``sketch`` in order, slab k at absolute tick
    ``offsets[k]`` (wrapped to int32). NaN rows are no-ops, so slabs may be
    padded; each lane's slabs must arrive in stream order."""
    seed = crng.seed_from_key(seed)
    for slab, off in zip(slabs, offsets):
        sketch = _apply_chunk(sketch, _to_device(slab, sketch.device), seed,
                              crng.wrap_i32(int(off)), g_offset,
                              lanes_per_group, plain)
    return sketch
