"""train_step / serve_step builders (port of the JAX package's
``train/steps.py``).

train_step = forward + CE loss (+ MoE aux) -> autograd grads -> frugal
quantile clip (or global norm) -> the optimizer -> frugal monitor ticks.
It runs eagerly: the gradients and the parameters are updated in place,
and the step returns a new ``TrainState`` around the same model.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import rng as crng
from repro_torch.monitor.registry import update_train_monitors
from repro_torch.optim import Optimizer
from repro_torch.optim.clipping import clip_by_global_norm, quantile_clip

from .train_state import TrainState, clip_blocks


def make_train_step(model, optimizer: Optimizer, clip_mode: str = "quantile",
                    max_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics); the metrics
    are 0-d tensors on the model's device."""
    keys, names = clip_blocks(model)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        rng, k_clip = crng.split(state.rng)
        model = state.params
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        loss, aux = model.loss(batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}

        qclip_state = state.qclip
        if clip_mode == "quantile" and qclip_state is not None:
            blocks = [[grads[n] for n in names[k]] for k in keys]
            qclip_state, block_norms = quantile_clip(blocks, qclip_state,
                                                     k_clip)
            gnorm = torch.sqrt(torch.sum(torch.square(block_norms)))
        else:
            gnorm = clip_by_global_norm(list(grads.values()), max_norm)

        opt_state = optimizer.update(grads, state.opt_state, params,
                                     state.step)
        model.zero_grad(set_to_none=True)     # free the gradients

        monitors = state.monitors
        if monitors is not None:
            monitors = update_train_monitors(monitors, aux["stats"])

        new_state = TrainState(params=model, opt_state=opt_state,
                               step=state.step + 1, rng=rng,
                               monitors=monitors, qclip=qclip_state)
        metrics = {"loss": loss.detach(), "ce_loss": aux["ce_loss"],
                   "aux_loss": aux["aux_loss"], "grad_norm": gnorm}
        return new_state, metrics

    return train_step


def make_serve_step(model, encdec_memory: bool = False):
    """Returns serve_step(tokens, caches, pos): one decode token for the
    whole batch; with ``encdec_memory``, serve_step(tokens, caches, pos,
    memory) for an encoder-decoder, ``memory`` from its ``encode``."""
    if encdec_memory:
        def serve_step(tokens, caches, pos, memory):
            return model.decode_step(tokens, caches, pos, memory)
    else:
        def serve_step(tokens, caches, pos):
            return model.decode_step(tokens, caches, pos)
    return serve_step
