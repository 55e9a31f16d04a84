"""Model registry: config -> model instance (port of the JAX package's
``models/model.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.platform import resolve_device

from .causal_lm import CausalLM, init_tree


def build_model(cfg, device=None,
                generator: Optional[torch.Generator] = None) -> CausalLM:
    """A ``CausalLM`` of ``cfg`` with fresh parameters on ``device`` (None:
    the card; raises where there is none).

    The initialisers keep the JAX package's shapes and scales; the values
    come from ``generator`` (default: seed 0 on the device), so they
    follow the same distributions, not JAX's threefry bits. To run the
    JAX package's own weights use ``convert.params_from_numpy``.

    Builds the attention-only, MoE, MLA, SSM (rwkv6) and hybrid (zamba2)
    families; the encoder-decoder raises NotImplementedError (ROADMAP A
    item 2)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder; that family is ROADMAP A "
            "item 2")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return CausalLM(cfg, init_tree(cfg, generator, dev))
