"""AdamW and Lion (port of the JAX package's ``optim/optimizer.py``).

The moments mirror the parameters: a dict keyed by the model's parameter
names (``named_parameters()``), float32 tensors on the parameters' device.
``update`` writes the new parameters and moments into their tensors in
place (the JAX package returns new trees; a full-width model has no room
for a second copy of its moments) and returns the new optimizer state.
Each in-place operation rounds where the JAX expression's does.

The bias corrections divide by a float32 tensor on the operands' device:
on CUDA, PyTorch turns a division by a Python number or a CPU scalar into
a multiplication by its reciprocal, which is not the IEEE quotient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple

import torch


class AdamWState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor          # 0-d int32, on the parameters' device


class LionState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    count: torch.Tensor


def _zeros(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _count(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    return AdamWState(mu=_zeros(params), nu=_zeros(params),
                      count=_count(params))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> AdamWState:
    """One AdamW step: ``params`` and the moments updated in place, the
    new state returned."""
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m = state.mu[k].mul_(b1).add_((1 - b1) * g)
        v = state.nu[k].mul_(b2).add_((1 - b2) * torch.square(g))
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
    return AdamWState(mu=state.mu, nu=state.nu, count=count)


def lion_init(params: Mapping[str, torch.Tensor]) -> LionState:
    return LionState(mu=_zeros(params), count=_count(params))


@torch.no_grad()
def lion_update(grads: Mapping[str, torch.Tensor], state: LionState,
                params: Mapping[str, torch.Tensor], lr, b1: float = 0.9,
                b2: float = 0.99, weight_decay: float = 0.1) -> LionState:
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m = state.mu[k]
        update = torch.sign(b1 * m + (1 - b1) * g) \
            + weight_decay * p.to(torch.float32)
        m.mul_(b2).add_((1 - b2) * g)
        p.copy_(p.to(torch.float32) - lr * update)
    return LionState(mu=state.mu, count=state.count + 1)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Thin dispatcher so the trainer is optimizer-agnostic."""
    kind: str = "adamw"
    lr_fn: Callable = None
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95

    def init(self, params: Mapping[str, torch.Tensor]):
        return adamw_init(params) if self.kind == "adamw" \
            else lion_init(params)

    def update(self, grads, state, params, step: int):
        """``params`` (name -> tensor) updated in place; returns the new
        optimizer state."""
        lr = self.lr_fn(step) if self.lr_fn else 3e-4
        if self.kind == "adamw":
            return adamw_update(grads, state, params, lr, b1=self.b1,
                                b2=self.b2, weight_decay=self.weight_decay)
        return lion_update(grads, state, params, lr, b1=self.b1,
                           b2=self.b2, weight_decay=self.weight_decay)
