"""Normalization layers and logit softcapping (port of the JAX package's
``models/layers/norm.py``).

The scale is stored in residual form for every config: the layer
multiplies by ``1 + scale`` and a fresh scale is zeros. Both norms compute
in float32 and cast back to the input's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + params["scale"].float())).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf * (1.0 + params["scale"].float()) + params["bias"].float()
    return out.to(dt)


def norm_init(cfg, d: int, dtype=torch.float32, device=None):
    if cfg.norm_type == "layernorm":
        return layernorm_init(d, dtype, device)
    return rmsnorm_init(d, dtype, device)


def apply_norm(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
