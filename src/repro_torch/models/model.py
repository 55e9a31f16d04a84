"""Model registry: config -> model instance (port of the JAX package's
``models/model.py``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.platform import resolve_device

from . import causal_lm, encdec
from .causal_lm import CausalLM
from .encdec import EncDecLM


def build_model(cfg, device=None,
                generator: Optional[torch.Generator] = None
                ) -> Union[CausalLM, EncDecLM]:
    """A ``CausalLM`` of ``cfg`` (an ``EncDecLM`` for an encoder-decoder)
    with fresh parameters on ``device`` (None: the card; raises where there
    is none).

    The initialisers keep the JAX package's shapes and scales; the values
    come from ``generator`` (default: seed 0 on the device), so they
    follow the same distributions, not JAX's threefry bits. To run the
    JAX package's own weights use ``convert.params_from_numpy``.

    On ``device="meta"`` nothing is drawn and no generator is made: every
    parameter has the shape and dtype of the CPU path's and no storage
    (the dry run's abstract model, ``launch.specs.abstract_params``).
    """
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if cfg.is_encdec:
        return EncDecLM(cfg, encdec.init_tree(cfg, generator, dev))
    return CausalLM(cfg, causal_lm.init_tree(cfg, generator, dev))
