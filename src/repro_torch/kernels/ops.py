"""Entry points of the ingest paths (the JAX package's ``kernels/ops.py``).

  * ``frugal_update_auto`` — one kernel launch over the whole [T, G] block
    (the JAX package's compiled path: B1 on a TPU, B4 on a GPU).
  * ``frugal_update_blocked`` — the same kernel launched once per
    ``block_t`` rows with the tick offset advanced (B2, the revisit grid),
    whose result must not depend on (block_g, block_t).
  * ``frugal_update_sparse`` — K events, in runs of one lane's events,
    against L resident lanes with per-lane clocks, in one launch (B3, the
    run kernel).

The two dense entry points take and return the program's plane tuple and
hand it to the kernel as it is: the kernel reads and writes the planes and
passes each (step, sign) pair through its packed word in registers, so the
bits are the serialized words' (``kernels.frugal_update.
frugal_program_dense_planes``) with no pass over the state around the
launch. They fan [T, G] items out to G·Q lanes (``lanes_per_group`` = Q)
by index on the device. The JAX padding contract (padded lanes dropped,
NaN-padded ticks as no-ops) holds without padded copies: the kernel masks
the ragged lane edge and stops its row loop at T. The sparse path keeps
its planes unpacked too.

Dispatch is by the tensors' device: CUDA runs the kernel, CPU the plain
version. On CUDA tensors ``frugal_update_auto`` takes its block size from
the roofline autotuner (``roofline.autotune``, priced for the tensors'
card) unless the caller passes one; ``block_override`` is the test seam
that forces blocks, or the tuner's blocks for a named HwSpec, on either
device. The result never depends on the blocks.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch import tracing
from repro_torch.core import rng as crng

from .frugal_update import (DEFAULT_BLOCK_G, frugal_program_dense_planes,
                            frugal_program_scatter)


def _as_seed(key=None, seed=None) -> int:
    if seed is not None:
        return crng.seed_from_key(seed)
    if key is None:
        raise ValueError("need key= or seed=")
    return crng.seed_from_key(key)


def _dense(items, planes, quantile, seed, t_offset, g_offset, program,
           lanes_per_group, block_g, block_t):
    planes = tuple(planes)
    device = planes[0].device
    if items.device != device:
        raise ValueError(f"items on {items.device}, state on {device}")
    with tracing.span("ops.pack"):
        items = items.to(torch.float32).contiguous()
        lanes = planes[0].shape[0]
        q = torch.broadcast_to(
            torch.as_tensor(quantile, dtype=torch.float32, device=device),
            (lanes,)).contiguous()
        planes = tuple(p.contiguous() for p in planes)
    t_len = items.shape[0]
    step = t_len if block_t is None else block_t
    # T = 0 still makes one call: it returns the planes through the
    # packed word, as every call does.
    for r0 in range(0, max(t_len, 1), max(step, 1)):
        planes = frugal_program_dense_planes(
            program, items[r0:r0 + step], planes, q, seed,
            t_offset=crng.wrap_i32(t_offset + r0), g_offset=g_offset,
            lanes_per_group=lanes_per_group, block_g=block_g)
    with tracing.span("ops.unpack"):
        return tuple(planes)


def frugal_update_blocked(items, planes, quantile, seed, t_offset=0,
                          g_offset=0, *, program,
                          block_g: int = DEFAULT_BLOCK_G, block_t: int = 256,
                          lanes_per_group: int = 1):
    """The dense ingest as launches of ``block_t`` rows, ``block_g``
    threads per CUDA block. Bit-identical for every block shape."""
    if block_t <= 0:
        raise ValueError(f"block_t must be positive, got {block_t}")
    return _dense(items, planes, quantile, crng.seed_from_key(seed),
                  t_offset, g_offset, program, lanes_per_group, block_g,
                  block_t)


# The block override: the test seam showing that tuned blocks are only
# another cut of the call. Kernel names are the JAX package's lowerings
# (Mosaic DMA, grid, Triton); each is B1 here.
_OVERRIDE_KERNELS = ("dma", "grid", "gpu")
_BLOCK_OVERRIDE = contextvars.ContextVar("block_override", default=None)


@contextlib.contextmanager
def block_override(block_g=None, block_t=None, *, autotune_hw=None,
                   kernel: str = "dma"):
    """Run ``frugal_update_auto`` with explicit blocks — or, when
    ``autotune_hw`` names an HwSpec (e.g. "gpu-h100"), with the blocks the
    roofline autotuner picks for that hardware — launched as ``block_t``-row
    launches of ``block_g`` threads a block on CUDA tensors, and as the
    plain version in the same ``block_t``-row walk on CPU tensors. A
    ``block_g`` passed to the call itself still wins. Deterministic, so
    tests can pin tuned-vs-default equality on the CPU."""
    if kernel not in _OVERRIDE_KERNELS:
        raise ValueError(f"kernel must be one of {_OVERRIDE_KERNELS}, got "
                         f"{kernel!r}")
    token = _BLOCK_OVERRIDE.set(dict(block_g=block_g, block_t=block_t,
                                     autotune_hw=autotune_hw))
    try:
        yield
    finally:
        _BLOCK_OVERRIDE.reset(token)


def _auto_blocks(program, shape, device, lanes_per_group, block_g):
    """(block_g, block_t) of a ``frugal_update_auto`` call over items of
    ``shape`` [T, G] on ``device``; block_t None is one launch. The tuner
    gives (DEFAULT_BLOCK_G, T) on hardware the registry cannot price."""
    # roofline.autotune imports this package: import it at call time
    from repro_torch.roofline.analysis import detect_hw, hw_for
    from repro_torch.roofline.autotune import autotune_blocks

    t_len, groups = shape
    ov = _BLOCK_OVERRIDE.get()
    if ov is not None:
        bg = bt = None
        if ov["autotune_hw"] is not None:
            bg, bt = autotune_blocks(program, groups, t_len, lanes_per_group,
                                     hw=hw_for(ov["autotune_hw"]))
        return (block_g or ov["block_g"] or bg or DEFAULT_BLOCK_G,
                ov["block_t"] or bt)
    if block_g is not None or device.type != "cuda":
        return block_g or DEFAULT_BLOCK_G, None
    return autotune_blocks(program, groups, t_len, lanes_per_group,
                           hw=detect_hw(device))[0], None


def frugal_update_auto(items, planes, quantile, key=None, *, seed=None,
                       program, t_offset=0, g_offset=0, lanes_per_group=1,
                       block_g=None):
    """The dense ingest as one launch over all of ``items``. ``key`` (an
    int or uint32 key words) or ``seed`` gives the counter seed.

    ``block_g=None`` takes the block size from the roofline autotuner
    (cached per family x layout x card x shape) on CUDA tensors; an
    explicit ``block_g`` is obeyed. Under ``block_override`` the
    override's blocks apply."""
    with tracing.span("ops.update_auto"):
        with tracing.span("ops.blocks"):
            block_g, block_t = _auto_blocks(program, items.shape,
                                            items.device, lanes_per_group,
                                            block_g)
        return _dense(items, planes, quantile, _as_seed(key, seed),
                      t_offset, g_offset, program, lanes_per_group, block_g,
                      block_t)


def frugal_update_sparse(lanes, items, mask, planes, ticks, quantile, seed,
                         scalars=(), *, program, g_offset=0, donate=False,
                         block_k: int = 128):
    """K events in one launch: slot j ticks lane ``lanes[j]`` once, in
    slot order within the lane. Returns the updated ``(planes, ticks)``.

    ``planes`` is the program's ordered unpacked plane tuple (each [L]),
    ``ticks`` the [L] int32 per-lane clock, ``quantile`` a scalar or [L]
    targets (read per lane). ``mask`` (or None: mask = item is not NaN)
    advances each slot's lane clock; a slot with mask 0 ticks with a NaN
    item and leaves its lane's state as a NaN tick does.

    Run contract (``kernels.frugal_update.frugal_program_scatter``): each
    lane's masked-in events are adjacent and in arrival order, and distinct
    runs of adjacent slots name distinct lanes, except runs of pads only. A
    round of distinct lanes is the case of runs of length 1. Nothing is
    padded here.

    ``donate=True`` updates the caller's plane and clock tensors in place
    (one kernel launch, O(K) traffic): any object holding them sees the
    new state. ``donate=False`` clones the planes and the clock first,
    one [L] copy per plane, and leaves the inputs untouched. CUDA tensors
    launch the run kernel, CPU tensors run its plain version.
    """
    planes = tuple(planes)
    device = planes[0].device
    lanes = torch.as_tensor(lanes, device=device).to(torch.int32)
    items = torch.as_tensor(items, device=device).to(torch.float32)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).to(
            torch.int32).contiguous()
    q = torch.as_tensor(quantile, dtype=torch.float32, device=device)
    scalars = tuple(int(v) for v in scalars) or program.scalar_values()
    if not donate:
        planes = tuple(p.clone() for p in planes)
        ticks = ticks.clone()
    return frugal_program_scatter(
        program, lanes.contiguous(), items.contiguous(), mask, planes, ticks,
        q.reshape(-1).contiguous(), seed, scalars, g_offset=g_offset,
        block_k=block_k)
