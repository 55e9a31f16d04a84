"""Block composition: layer kinds -> residual blocks -> the decoder stack
(port of the JAX package's ``models/blocks.py``).

The JAX package runs a stage's units under ``lax.scan`` over parameters
stacked on a leading axis; the port holds one module per layer
(``causal_lm.CausalLM``) and runs them in a Python loop, in the scan's
order. ``stage_unit_kinds`` is ported whole, so every config names its
stack; the block functions cover the attention kinds (``attn``,
``attn_local``, ``attn_global``), MLA (``mla``: deepseek's dense prefix),
the MoE kinds (``moe``: GQA attention and experts; ``mla_moe``), the
recurrent kinds (``mamba``: a mamba2 mixer alone, no MLP; ``rwkv``: time
mix and channel mix, both weight sets under ``tm``) and the
encoder-decoder's (``enc_attn``: bidirectional self-attention at scale
hd^-0.5, no softcap; ``dec_cross``: causal self-attention at the default
chunk, cross-attention over the encoder's ``memory`` under ``norm_x``,
then the MLP).

Per-block telemetry (``_stats``: activation absmax and rms, and for the
MoE kinds the router's aux loss, expert load and drop fraction) is
returned beside the activations, as the JAX package returns it from the
scan.

Decode updates a layer's cache dict in place: attention writes one
position of its KV, the recurrent kinds copy their new state over the
old (every row advances, whatever its token).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .layers import attention as attn_lib
from .layers import mamba2 as mamba_lib
from .layers import mla as mla_lib
from .layers import moe as moe_lib
from .layers import rwkv6 as rwkv_lib
from .layers.mlp import mlp, mlp_init
from .layers.norm import apply_norm, norm_init

ATTENTION_KINDS = ("attn", "attn_local", "attn_global")
MOE_KINDS = ("moe", "mla_moe")          # the kinds that route to experts
RECURRENT_KINDS = ("mamba", "rwkv")
ENCDEC_KINDS = ("enc_attn", "dec_cross")
PORTED_KINDS = ATTENTION_KINDS + ("mla",) + MOE_KINDS + RECURRENT_KINDS \
    + ENCDEC_KINDS


def _check_kind(kind: str):
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")


# --------------------------------------------------------------------- kinds
def kind_window(cfg, kind: str) -> int:
    if kind == "attn_local":
        return cfg.window_pattern[0] if cfg.window_pattern else 4096
    return 0


def block_init(gen, cfg, kind: str, dtype=torch.float32,
               device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """One residual block's parameters (the JAX package's tree and
    scales; the values come from ``gen``)."""
    _check_kind(kind)
    p = {"norm1": norm_init(cfg, cfg.d_model, dtype, device)}
    if kind == "mamba":
        p["mamba"] = mamba_lib.mamba2_init(gen, cfg, dtype, device)
        return p
    if kind == "rwkv":
        p["tm"] = rwkv_lib.rwkv6_init(gen, cfg, dtype, device)
        p["norm2"] = norm_init(cfg, cfg.d_model, dtype, device)
        return p
    if kind.startswith("mla"):
        p["attn"] = mla_lib.mla_init(gen, cfg, dtype, device)
    else:
        p["attn"] = attn_lib.attention_init(gen, cfg, dtype, device)
    if kind == "dec_cross":
        p["cross"] = attn_lib.cross_attention_init(gen, cfg, dtype, device)
        p["norm_x"] = norm_init(cfg, cfg.d_model, dtype, device)
    p["norm2"] = norm_init(cfg, cfg.d_model, dtype, device)
    if kind in MOE_KINDS:
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, device)
    else:
        d_ff = (cfg.first_dense_d_ff or cfg.d_ff) if kind == "mla" \
            else cfg.d_ff
        p["mlp"] = mlp_init(gen, cfg.d_model, d_ff, cfg.gated_mlp, dtype,
                            device)
    if cfg.post_norms and kind in ATTENTION_KINDS:
        p["post_norm1"] = norm_init(cfg, cfg.d_model, dtype, device)
        p["post_norm2"] = norm_init(cfg, cfg.d_model, dtype, device)
    return p


def _stats(x: torch.Tensor, extra: Optional[Dict] = None
           ) -> Dict[str, torch.Tensor]:
    xf = x.float()
    s = {"absmax": xf.abs().max(), "rms": xf.square().mean().sqrt()}
    if extra:
        s.update(extra)
    return s


def _feed_forward(params, x, cfg, kind: str, decode: bool):
    """The block's second residual: the MLP, or the experts for the MoE
    kinds with their stats (decode keeps only ``expert_load``, as the
    JAX package's does)."""
    h = apply_norm(cfg, params["norm2"], x)
    if kind not in MOE_KINDS:
        m = mlp(params["mlp"], h, cfg.act, cfg.gated_mlp)
        if cfg.post_norms and kind in ATTENTION_KINDS:
            m = apply_norm(cfg, params["post_norm2"], m)
        return x + m, None
    mo, aux = moe_lib.moe_block(params["moe"], h, cfg)
    keys = ("expert_load",) if decode else \
        ("aux_loss", "expert_load", "drop_fraction")
    return x + mo, {k: aux[k] for k in keys}


def block_apply(params, x: torch.Tensor, cfg, kind: str, cos=None,
                sin=None, q_offset: int = 0, memory=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence residual block (``memory``: the encoder's output,
    which ``dec_cross`` attends)."""
    _check_kind(kind)
    h = apply_norm(cfg, params["norm1"], x)
    if kind == "mamba":
        x = x + mamba_lib.mamba2_forward(params["mamba"], h, cfg)
        return x, _stats(x)
    if kind == "rwkv":
        tm, _, _ = rwkv_lib.rwkv6_timemix_chunked(params["tm"], h, cfg)
        x = x + tm
        h = apply_norm(cfg, params["norm2"], x)
        cm, _ = rwkv_lib.rwkv6_channelmix(params["tm"], h, cfg)
        x = x + cm
        return x, _stats(x)
    if kind == "enc_attn":                      # bidirectional
        a = attn_lib.cross_attention(params["attn"], h, h, cfg,
                                     chunk=cfg.attn_chunk)
    elif kind == "dec_cross":
        x = x + attn_lib.attention(params["attn"], h, cfg, cos, sin,
                                   q_offset=q_offset)
        h = apply_norm(cfg, params["norm_x"], x)
        a = attn_lib.cross_attention(params["cross"], h, memory, cfg,
                                     chunk=cfg.attn_chunk)
    elif kind.startswith("mla"):
        a = mla_lib.mla_attention(params["attn"], h, cfg, cos, sin,
                                  q_offset=q_offset, chunk=cfg.attn_chunk)
    else:
        a = attn_lib.attention(params["attn"], h, cfg, cos, sin,
                               window=kind_window(cfg, kind),
                               q_offset=q_offset, chunk=cfg.attn_chunk)
    if cfg.post_norms and kind in ATTENTION_KINDS:
        a = apply_norm(cfg, params["post_norm1"], a)
    x, extra = _feed_forward(params, x + a, cfg, kind, decode=False)
    return x, _stats(x, extra)


# ------------------------------------------------------------- decode blocks
def block_cache_init(cfg, kind: str, batch: int, max_len: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """{"k", "v"} [B, L, Hkv, hd] for the attention kinds and ``moe``;
    {"ckv" [B, L, kv_lora_rank], "kr" [B, L, qk_rope_dim]} for MLA; the
    recurrent state for ``mamba`` ({"ssm", "conv"}, float32) and ``rwkv``
    ({"wkv"} float32, {"x_tm", "x_cm"} [B, 1, D] in ``dtype``);
    ``dec_cross`` caches its self-attention's {"k", "v"} only."""
    _check_kind(kind)
    if kind == "enc_attn":
        raise ValueError("the encoder's layers run no decode steps")
    if kind == "mamba":
        return mamba_lib.mamba2_init_cache(cfg, batch, torch.float32, device)
    if kind == "rwkv":
        n = cfg.rwkv_head_size
        nh = cfg.d_model // n
        return {"wkv": torch.zeros((batch, nh, n, n), dtype=torch.float32,
                                   device=device),
                "x_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                    device=device),
                "x_cm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                    device=device)}
    if kind.startswith("mla"):
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_decode(params, x: torch.Tensor, cache, pos: int, cfg, kind: str,
                 cos=None, sin=None, memory=None):
    """One-token decode through a residual block; the cache is updated in
    place and returned. ``dec_cross`` recomputes its cross-attention's K
    and V from ``memory`` at every call, as the JAX package does."""
    _check_kind(kind)
    if kind == "enc_attn":
        raise ValueError("the encoder's layers run no decode steps")
    h = apply_norm(cfg, params["norm1"], x)
    if kind in RECURRENT_KINDS:
        if kind == "mamba":
            out, new = mamba_lib.mamba2_decode(params["mamba"], h, cache, cfg)
            x = x + out
        else:
            tm, wkv, x_tm = rwkv_lib.rwkv6_timemix_decode(
                params["tm"], h, cfg, cache["wkv"], cache["x_tm"])
            x = x + tm
            h = apply_norm(cfg, params["norm2"], x)
            cm, x_cm = rwkv_lib.rwkv6_channelmix(params["tm"], h, cfg,
                                                 cache["x_cm"])
            x = x + cm
            new = {"wkv": wkv, "x_tm": x_tm, "x_cm": x_cm}
        for k, v in new.items():
            cache[k].copy_(v)
        return x, cache, _stats(x)
    if kind.startswith("mla"):
        a, ckv, kr = mla_lib.mla_decode(
            params["attn"], h, cache["ckv"], cache["kr"], pos, cfg, cos,
            sin, chunk=cfg.decode_chunk)
        cache = dict(cache, ckv=ckv, kr=kr)
    else:
        a, ck, cv = attn_lib.attention_decode(
            params["attn"], h, cache["k"], cache["v"], pos, cfg, cos, sin,
            window=kind_window(cfg, kind), chunk=cfg.decode_chunk)
        cache = dict(cache, k=ck, v=cv)
    if cfg.post_norms and kind in ATTENTION_KINDS:
        a = apply_norm(cfg, params["post_norm1"], a)
    x = x + a
    if kind == "dec_cross":
        h = apply_norm(cfg, params["norm_x"], x)
        x = x + attn_lib.cross_attention(params["cross"], h, memory, cfg,
                                         chunk=cfg.attn_chunk)
    x, extra = _feed_forward(params, x, cfg, kind, decode=True)
    return x, cache, _stats(x, extra)


# ------------------------------------------------------------------ modules
class Params(nn.Module):
    """A parameter tree keyed as the JAX package's pytree: each tensor
    leaf becomes a Parameter, each dict a child ``Params``; ``p["wq"]``
    reads a leaf or a child, so the layer functions take a module or a
    plain dict of tensors alike."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(name, Params(v))
            else:
                self.register_parameter(name, nn.Parameter(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Block(Params):
    """One residual block of ``kind``: the port's counterpart of one unit
    slice of the JAX package's stacked parameters."""

    def __init__(self, cfg, kind: str, tree: Mapping):
        _check_kind(kind)
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind

    def forward(self, x, cos=None, sin=None, q_offset: int = 0,
                memory=None):
        return block_apply(self, x, self.cfg, self.kind, cos, sin, q_offset,
                           memory)

    def decode(self, x, cache, pos: int, cos=None, sin=None, memory=None):
        return block_decode(self, x, cache, pos, self.cfg, self.kind, cos,
                            sin, memory)


# ------------------------------------------------------------------- stages
def stage_unit_kinds(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """Returns (prefix_kinds, n_units, unit_kinds) for the decoder stack:
    unstacked leading layers (deepseek's first dense layer), then n_units
    repetitions of unit_kinds."""
    if cfg.layer_pattern:                       # hybrid (zamba2)
        unit = tuple(cfg.layer_pattern)
        if cfg.num_layers % len(unit):
            raise ValueError(f"{cfg.num_layers} layers do not tile {unit}")
        return (), cfg.num_layers // len(unit), unit
    if cfg.family == "ssm":
        return (), cfg.num_layers, ("rwkv",)
    if cfg.moe_experts:
        attn_kind = "mla_moe" if cfg.use_mla else "moe"
        prefix = ("mla",) * cfg.moe_first_dense if cfg.use_mla \
            else ("attn",) * cfg.moe_first_dense
        return prefix, cfg.num_layers - cfg.moe_first_dense, (attn_kind,)
    if cfg.window_pattern:                      # gemma2 local/global
        unit = tuple("attn_local" if w else "attn_global"
                     for w in cfg.window_pattern)
        if cfg.num_layers % len(unit):
            raise ValueError(f"{cfg.num_layers} layers do not tile {unit}")
        return (), cfg.num_layers // len(unit), unit
    return (), cfg.num_layers, ("attn",)


def layer_kinds(cfg) -> Tuple[str, ...]:
    """Every layer's kind in the order the JAX package runs them: the
    prefix, then unit by unit."""
    prefix, n_units, unit = stage_unit_kinds(cfg)
    return tuple(prefix) + tuple(unit) * n_units


def stack_stats(stats, unit_kinds) -> list:
    """Per-layer stats of the stacked layers -> the JAX scan's layout: one
    dict per unit kind, each statistic stacked over the units (scalars to
    [n_units], an expert load [E] to [n_units, E])."""
    n = len(unit_kinds)
    return [{k: torch.stack([st[k] for st in stats[j::n]])
             for k in stats[j]} for j in range(n)]
