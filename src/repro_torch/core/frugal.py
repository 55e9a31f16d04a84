"""Frugal-1U and Frugal-2U updates over a batch of lanes, and the
program-generic [T, G] ingest loop.

Transcribed expression for expression from the JAX package's
``core/frugal.py`` (paper Algorithms 2 and 3, f(step) = 1), so that every
float32 operation rounds at the same place:

  * Frugal-1U: on item s, ``m += 1`` if ``s > m and u > 1 - q``,
    ``m -= 1`` if ``s < m and u > q``.
  * Frugal-2U: adaptive step with the overshoot clamp to the item, the
    direction-flip step reset, a move of 1 while step <= 0 and of
    ``ceil(step)`` otherwise.

NaN items compare false both ways, so a NaN tick is a no-op (the padding
contract). ``program_process_seeded`` is the plain PyTorch version of the
CUDA kernel and the CPU path of ``kernels.ops.frugal_update_auto``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import rng


class Frugal1UState(NamedTuple):
    """One unit of memory per lane (paper Algorithm 2)."""

    m: torch.Tensor


class Frugal2UState(NamedTuple):
    """Two units of memory (+ sign bit) per lane (paper Algorithm 3)."""

    m: torch.Tensor
    step: torch.Tensor
    sign: torch.Tensor


def _f32(q, like: torch.Tensor) -> torch.Tensor:
    # The target must be a float32 tensor before `1.0 - q`: a Python float
    # would be subtracted in double precision and round differently.
    return torch.as_tensor(q, dtype=torch.float32, device=like.device)


def frugal1u_update(state: Frugal1UState, items, rand,
                    quantile=0.5) -> Frugal1UState:
    """One Frugal-1U tick for every lane."""
    q = _f32(quantile, state.m)
    up = (items > state.m) & (rand > 1.0 - q)
    down = (items < state.m) & (rand > q)
    m = state.m + up.to(state.m.dtype) - down.to(state.m.dtype)
    return Frugal1UState(m=m)


def frugal2u_update(state: Frugal2UState, items, rand,
                    quantile=0.5) -> Frugal2UState:
    """One Frugal-2U tick for every lane (branch-free, both branches
    computed and selected with masks)."""
    m, step, sign = state
    q = _f32(quantile, m)
    up = (items > m) & (rand > 1.0 - q)
    down = (items < m) & (rand > q)

    # ---- increment branch (paper lines 4-14) ----
    step_u = step + torch.where(sign > 0, 1.0, -1.0)
    m_u = m + torch.where(step_u > 0, torch.ceil(step_u), 1.0)
    osh_u = m_u > items
    step_u = torch.where(osh_u, step_u + (items - m_u), step_u)
    m_u = torch.where(osh_u, items, m_u)
    step_u = torch.where((sign < 0) & (step_u > 1), 1.0, step_u)

    # ---- decrement branch (paper lines 15-26) ----
    step_d = step + torch.where(sign < 0, 1.0, -1.0)
    m_d = m - torch.where(step_d > 0, torch.ceil(step_d), 1.0)
    osh_d = m_d < items
    step_d = torch.where(osh_d, step_d + (m_d - items), step_d)
    m_d = torch.where(osh_d, items, m_d)
    step_d = torch.where((sign > 0) & (step_d > 1), 1.0, step_d)

    m_new = torch.where(up, m_u, torch.where(down, m_d, m))
    step_new = torch.where(up, step_u, torch.where(down, step_d, step))
    sign_new = torch.where(up, 1.0, torch.where(down, -1.0, sign))
    return Frugal2UState(m=m_new, step=step_new, sign=sign_new)


class TickCtx(NamedTuple):
    """What a lane program's tick may key on besides (planes, item, u).

    quantile — per-lane targets [L] (float32 tensor).
    t        — absolute stream tick, a Python int (int32-wrapped).
    seed     — the counter seed, a Python int.
    lanes    — absolute lane ids, [L] int32.
    scalars  — the program's int32 scalar operands, Python ints.
    """

    quantile: torch.Tensor
    t: int
    seed: int
    lanes: torch.Tensor
    scalars: Tuple[int, ...]


def program_process_seeded(program, planes, items: torch.Tensor, seed,
                           quantile=0.5, scalars=None,
                           return_trace: bool = False, t_offset: int = 0,
                           g_offset: int = 0, lanes_per_group: int = 1):
    """The program-generic [T, G] ingest loop over ticks, for any
    registered ``LaneProgram``.

    Tick i of ``items`` is absolute tick ``t_offset + i`` (int32 wrap);
    column c drives lanes ``c*Q .. c*Q + Q-1`` (Q = ``lanes_per_group``),
    whose absolute ids start at ``g_offset``. The uniform of lane l at tick
    t is ``counter_uniform(seed, t, g_offset + l)``, so the result does not
    depend on how a stream is chunked. Returns (planes, trace or None);
    trace rows come from the program's trace function.
    """
    t_len, g = items.shape
    lanes = g * lanes_per_group
    planes = tuple(planes)
    if planes[0].shape[0] != lanes:
        raise ValueError(
            f"state has {planes[0].shape[0]} lanes but items [{t_len}, {g}] "
            f"x lanes_per_group={lanes_per_group} needs {lanes}")
    device = planes[0].device
    g_ids = rng.wrap_i32(g_offset) + torch.arange(lanes, dtype=torch.int32,
                                                  device=device)
    q = torch.broadcast_to(_f32(quantile, planes[0]), (lanes,))
    if scalars is None:
        scalars = program.scalar_values()
    scalars = tuple(int(s) for s in scalars)
    seed = rng.wrap_i32(seed)
    trace = []
    for i in range(t_len):
        it = items[i]
        if lanes_per_group > 1:
            it = it.repeat_interleave(lanes_per_group)
        t_abs = rng.wrap_i32(t_offset + i)
        u = rng.counter_uniform(seed, t_abs, g_ids)
        ctx = TickCtx(quantile=q, t=t_abs, seed=seed, lanes=g_ids,
                      scalars=scalars)
        planes = program.run_tick(planes, it, u, ctx)
        if return_trace:
            trace.append(program.run_trace(planes, t_abs))
    if not return_trace:
        return planes, None
    if trace:
        return planes, torch.stack(trace)
    return planes, planes[0].new_empty((0, lanes))
