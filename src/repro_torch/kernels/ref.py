"""Independent torch transcriptions of the paper's algorithms, the oracles
of the kernel tests.

A loop of ticks over a [T, G] block, with no lane programs, no packing
and no tick code shared with ``core/frugal.py`` or ``core/program.py``
(the port's copy of the JAX package's ``kernels/ref.py``). Uniforms come
from the counter hash the kernels use (``core.rng``), keyed on
(seed, t_offset + t, g_offset + g), so these agree bit for bit with the
dense kernel and its plain version for any chunking. Test-only: no
production path runs this file.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng as crng


def _tick1u(m, s, r, quantile):
    """One Frugal-1U tick (paper Alg. 2)."""
    up = (s > m) & (r > 1.0 - quantile)
    down = (s < m) & (r > quantile)
    return m + up.to(m.dtype) - down.to(m.dtype)


def _tick2u(m, step, sign, s, r, quantile):
    """One Frugal-2U tick (paper Alg. 3)."""
    up = (s > m) & (r > 1.0 - quantile)
    down = (s < m) & (r > quantile)

    step_u = step + torch.where(sign > 0, 1.0, -1.0)
    m_u = m + torch.where(step_u > 0, torch.ceil(step_u), 1.0)
    osh_u = m_u > s
    step_u = torch.where(osh_u, step_u + (s - m_u), step_u)
    m_u = torch.where(osh_u, s, m_u)
    step_u = torch.where((sign < 0) & (step_u > 1), 1.0, step_u)

    step_d = step + torch.where(sign < 0, 1.0, -1.0)
    m_d = m - torch.where(step_d > 0, torch.ceil(step_d), 1.0)
    osh_d = m_d < s
    step_d = torch.where(osh_d, step_d + (m_d - s), step_d)
    m_d = torch.where(osh_d, s, m_d)
    step_d = torch.where((sign > 0) & (step_d > 1), 1.0, step_d)

    m2 = torch.where(up, m_u, torch.where(down, m_d, m))
    step2 = torch.where(up, step_u, torch.where(down, step_d, step))
    sign2 = torch.where(up, 1.0, torch.where(down, -1.0, sign))
    return m2, step2, sign2


def _operands(items, m, quantile, g_offset):
    # A float32 target: ``1.0 - q`` on a Python float would round in
    # double precision.
    q = torch.as_tensor(quantile, dtype=torch.float32, device=m.device)
    g_ids = crng.wrap_i32(g_offset) + torch.arange(
        items.shape[1], dtype=torch.int32, device=m.device)
    return q, g_ids


def frugal1u_ref_fused(items: torch.Tensor, m: torch.Tensor, quantile, seed,
                       *, t_offset: int = 0, g_offset: int = 0
                       ) -> torch.Tensor:
    """[T, G] sequential Frugal-1U with counter-hashed uniforms; returns
    m [G]."""
    q, g_ids = _operands(items, m, quantile, g_offset)
    seed = crng.wrap_i32(seed)
    for i in range(items.shape[0]):
        r = crng.counter_uniform(seed, crng.wrap_i32(t_offset + i), g_ids)
        m = _tick1u(m, items[i], r, q)
    return m


def frugal2u_ref_fused(items: torch.Tensor, m: torch.Tensor,
                       step: torch.Tensor, sign: torch.Tensor, quantile,
                       seed, *, t_offset: int = 0, g_offset: int = 0):
    """[T, G] sequential Frugal-2U with counter-hashed uniforms; returns
    (m, step, sign)."""
    q, g_ids = _operands(items, m, quantile, g_offset)
    seed = crng.wrap_i32(seed)
    for i in range(items.shape[0]):
        r = crng.counter_uniform(seed, crng.wrap_i32(t_offset + i), g_ids)
        m, step, sign = _tick2u(m, step, sign, items[i], r, q)
    return m, step, sign
