"""Gradient clipping: global-norm and frugal quantile clipping (port of
the JAX package's ``optim/clipping.py``).

Quantile clipping is the paper's sketch applied to the training loop: the
gradient norm of each top-level parameter block is a stream, a Frugal-2U
sketch (2 words per block) tracks its q95, and each block's gradients are
clipped to ``margin x q95-estimate`` once the sketch has seen
``warmup_steps`` steps. O(1) memory per block, against a window of past
norms for percentile-buffer clipping.

A block is a list of gradient tensors; its norm sums the squares of its
tensors in order. ``quantile_clip_scales`` is the frugal part alone, a
function of the block norms, so the sketch and the scales can be held to
the JAX package's bits on the JAX package's norms.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import rng as crng
from repro_torch.core.frugal import Frugal2UState, frugal2u_update


def global_norm(tensors: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (0.0 for an
    empty block, on ``device``)."""
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=device)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping."""
    norm = global_norm(grads)
    limit = torch.full_like(norm, max_norm)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.copy_((g * scale).to(g.dtype))
    return norm


class QuantileClipState(NamedTuple):
    """One Frugal-2U sketch over per-block grad-norm streams."""
    sketch: Frugal2UState   # [num_blocks] lanes, float32
    warmup: int             # steps seen (the sketch engages after a few)


def quantile_clip_init(num_blocks: int, init_norm: float = 1.0,
                       device=None) -> QuantileClipState:
    m = torch.full((num_blocks,), init_norm, dtype=torch.float32,
                   device=device)
    return QuantileClipState(
        sketch=Frugal2UState(m=m, step=torch.ones_like(m),
                             sign=torch.ones_like(m)),
        warmup=0)


def quantile_clip_scales(norms: torch.Tensor, state: QuantileClipState,
                         key, quantile: float = 0.95, margin: float = 2.0,
                         warmup_steps: int = 20
                         ) -> Tuple[torch.Tensor, QuantileClipState]:
    """One sketch tick on the block norms [G] with the uniforms of
    ``key`` (uint32 key words); returns (per-block scales, new state)."""
    rand = crng.tick_uniforms(key, norms.shape[0], device=norms.device)
    sketch = frugal2u_update(state.sketch, norms, rand, quantile)
    if state.warmup >= warmup_steps:
        thresh = torch.clamp(sketch.m * margin, min=1e-6)
        scales = torch.clamp(thresh / torch.clamp(norms, min=1e-9), max=1.0)
    else:
        scales = torch.ones_like(norms)
    return scales, QuantileClipState(sketch, state.warmup + 1)


def quantile_clip(grads_blocks: List[Sequence[torch.Tensor]],
                  state: QuantileClipState, key, quantile: float = 0.95,
                  margin: float = 2.0, warmup_steps: int = 20
                  ) -> Tuple[QuantileClipState, torch.Tensor]:
    """Clip each block, in place, to margin x (frugal q95 of its grad-norm
    history). Returns (new state, block norms [G])."""
    dev = state.sketch.m.device
    norms = torch.stack([global_norm(b, dev) for b in grads_blocks])
    scales, state = quantile_clip_scales(norms, state, key, quantile,
                                         margin, warmup_steps)
    for i, block in enumerate(grads_blocks):
        for g in block:
            g.copy_((g * scales[i]).to(g.dtype))
    return state, norms
