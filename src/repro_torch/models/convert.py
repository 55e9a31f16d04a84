"""Weights carried across from the JAX package.

``params_from_numpy(cfg, tree)`` takes the JAX package's ``CausalLM``
parameter pytree with numpy leaves (``jax.tree.map(np.asarray, params)``)
and returns the port's ``CausalLM`` computing what the JAX model computes:
each stacked unit of ``stack`` (a leading ``n_units`` axis per unit kind)
becomes one layer module, in the order the JAX scan runs them.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device

from .blocks import stage_unit_kinds
from .causal_lm import CausalLM

TOP_LEVEL = ("embed", "final_norm", "lm_head", "pos")


def _tensors(node, device, unit=None):
    """A nested dict of numpy leaves -> the same of tensors on ``device``
    (copies), taking index ``unit`` of each leaf's leading axis when
    given."""
    if isinstance(node, Mapping):
        return {k: _tensors(v, device, unit) for k, v in node.items()}
    a = np.asarray(node)
    return torch.from_numpy(np.array(a if unit is None else a[unit])).to(
        device)


def params_from_numpy(cfg, tree: Mapping, device=None) -> CausalLM:
    """The JAX package's parameter tree (numpy leaves) as a port model on
    ``device`` (None: the card; raises where there is none)."""
    dev = resolve_device(device)
    if tree.get("shared_block"):
        raise NotImplementedError("a shared attention block (zamba2) is "
                                  "ROADMAP A item 6")
    _, n_units, unit_kinds = stage_unit_kinds(cfg)
    out = {k: _tensors(tree[k], dev) for k in TOP_LEVEL if k in tree}
    out["layers"] = [_tensors(p, dev) for p in tree.get("prefix", [])]
    stack = tree.get("stack", [])
    out["layers"] += [_tensors(stack[j], dev, u) for u in range(n_units)
                      for j in range(len(unit_kinds))]
    return CausalLM(cfg, out)
