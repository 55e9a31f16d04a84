"""Batched frugal updates, the beyond-paper extension for tensor
telemetry (port of the JAX package's ``core/batched.py``).

A group that receives B items at once (a channel of a [batch, seq, C]
activation) takes one binomial mega-tick instead of B sequential ticks:
at the current estimate m, count n+ = #{s > m} and n- = #{s < m}, draw
U+ ~ Binomial(n+, q) and U- ~ Binomial(n-, 1 - q), and move by the
sqrt(B)-damped net (U+ - U-) / sqrt(B) times the unit (1 for 1U, the
adaptive step for 2U). E[move] = 0 exactly where F(m) = q: the paper's
fixed point. The damping keeps the feedback slope of the explicit step
small and caps a call's drift at sqrt(B) units.

Binomials use the normal approximation with continuity to [0, n]. The JAX
package draws the normals with ``jax.random.normal`` (threefry and XLA's
inverse error function); the port draws them from a ``torch.Generator``
seeded from the key words, so it meets the same distributional contract
(the fixed points, the bounded drift, the batch hull), not the JAX
package's bits.
"""
from __future__ import annotations

from typing import Union

import torch

from . import rng as crng
from .frugal import Frugal2UState


def _generator(key, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(crng.seed_from_key(key) & 0xFFFFFFFF)
    return gen


def _binomial_sample(key, n: torch.Tensor, p) -> torch.Tensor:
    """Approximate Binomial(n, p), shape n.shape: N(np, np(1-p)) rounded
    and clipped to [0, n]."""
    nf = n.to(torch.float32)
    mean = nf * p
    var = torch.clamp(nf * p * (1.0 - p), min=1e-6)
    z = torch.randn(n.shape, generator=_generator(key, n.device),
                    dtype=torch.float32, device=n.device)
    samp = torch.round(mean + z * torch.sqrt(var))
    return torch.minimum(torch.clamp(samp, min=0.0), nf)


def batched_frugal2u_update(state: Frugal2UState, items: torch.Tensor, key,
                            quantile: Union[float, torch.Tensor] = 0.5,
                            freeze_step: bool = False) -> Frugal2UState:
    """One binomial mega-tick ingesting ``items`` [B, G] (B items per
    group) at a fixed m; ``key``: uint32 key words (split in two, one
    for each direction's draw)."""
    dt = state.m.dtype
    q = torch.as_tensor(quantile, dtype=dt, device=state.m.device)
    b = items.shape[0]
    n_up = torch.sum(items > state.m[None, :], dim=0)
    n_dn = torch.sum(items < state.m[None, :], dim=0)
    k_up, k_dn = crng.split(key)
    u_up = _binomial_sample(k_up, n_up, q)
    u_dn = _binomial_sample(k_dn, n_dn, 1.0 - q)
    net = (u_up - u_dn) / max(float(b) ** 0.5, 1.0)   # damped tick count
    if freeze_step:
        return Frugal2UState(m=state.m + net, step=state.step,
                             sign=state.sign)

    # 2U dynamics, batched: same-direction streaks grow the step, a flip
    # shrinks or resets it (the paper's lines 5 and 11-13).
    direction = torch.sign(net)
    active = direction != 0
    same_dir = (direction == state.sign) & active
    step = torch.where(active, torch.where(same_dir, state.step + 1.0,
                                           state.step - 1.0), state.step)
    step = torch.where(active & ~same_dir & (step > 1), 1.0, step)
    unit = torch.where(step > 0, torch.ceil(step), 1.0)
    m = state.m + net * unit
    # Overshoot clamp to the batch's range (the analogue of lines 7-10).
    hi = torch.amax(items, dim=0)
    lo = torch.amin(items, dim=0)
    over = (direction > 0) & (m > hi)
    under = (direction < 0) & (m < lo)
    step = torch.where(over, step + (hi - m), step)
    step = torch.where(under, step + (m - lo), step)
    m = torch.where(over, hi, torch.where(under, lo, m))
    sign = torch.where(active, torch.where(direction > 0, 1.0, -1.0),
                       state.sign).to(dt)
    return Frugal2UState(m=m, step=step.to(dt), sign=sign)
