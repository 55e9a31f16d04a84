"""Feed-forward blocks: gated (SiLU / GeLU GLU), plain GELU, squared ReLU
(port of the JAX package's ``models/layers/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .embedding import normal


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # minitron/nemotron squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown act {name}")


def mlp_init(gen, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32, device=None):
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    p = {"w_in": normal(gen, (d_model, d_ff), s_in, dtype, device),
         "w_out": normal(gen, (d_ff, d_model), s_out, dtype, device)}
    if gated:
        p["w_gate"] = normal(gen, (d_model, d_ff), s_in, dtype, device)
    return p


def mlp(params, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Weights cast to the activation dtype per call, as the JAX package
    casts them."""
    dt = x.dtype
    h = torch.matmul(x, params["w_in"].to(dt))
    if gated:
        g = torch.matmul(x, params["w_gate"].to(dt))
        h = _act(act, g) * h
    else:
        h = _act(act, h)
    return torch.matmul(h, params["w_out"].to(dt))
