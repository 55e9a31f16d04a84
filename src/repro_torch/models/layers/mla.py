"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; port of
the JAX package's ``models/layers/mla.py``).

KV is compressed to a rank-``kv_lora_rank`` latent c_kv plus one shared
RoPE key head; per-head K_nope and V are up-projected from the latent. The
decode cache holds only (c_kv, k_rope): 512 + 64 floats a token for
V2-Lite against 2 x 16 x 128 for the same heads under plain attention.
Attention itself is the chunked online-softmax core of ``attention``
(which allows a value width other than the key's).

V2-Lite has no q compression (its published q_lora_rank is null).
"""
from __future__ import annotations

from typing import Optional

import torch

from .attention import _chunk_attend
from .embedding import normal
from .rope import apply_rope


def mla_init(gen, cfg, dtype=torch.float32, device=None):
    """The JAX package's tree (wq, wd_kv, wu_k, wu_v, wo), shapes and
    scales; the values come from ``gen``."""
    d, h, dc = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = d ** -0.5
    return {"wq": normal(gen, (d, h * (dn + dr)), s, dtype, device),
            # the latent and the shared rope key
            "wd_kv": normal(gen, (d, dc + dr), s, dtype, device),
            "wu_k": normal(gen, (dc, h * dn), dc ** -0.5, dtype, device),
            "wu_v": normal(gen, (dc, h * dv), dc ** -0.5, dtype, device),
            "wo": normal(gen, (h * dv, d), (h * dv) ** -0.5, dtype,
                         device)}


def _project_qkv(params, x, cfg, cos, sin):
    b, s, _ = x.shape
    h, dc = cfg.num_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    dt = x.dtype
    q = torch.matmul(x, params["wq"].to(dt)).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv_kr = torch.matmul(x, params["wd_kv"].to(dt))
    c_kv, k_rope = ckv_kr[..., :dc], ckv_kr[..., dc:]
    if cos is not None:
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _expand_latent(params, c_kv, cfg):
    """Up-project the latent into per-head K_nope / V."""
    b, s, _ = c_kv.shape
    h, dn, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    dt = c_kv.dtype
    k_nope = torch.matmul(c_kv, params["wu_k"].to(dt)).reshape(b, s, h, dn)
    v = torch.matmul(c_kv, params["wu_v"].to(dt)).reshape(b, s, h, dv)
    return k_nope, v


def _heads(q_nope, q_rope, k_nope, k_rope):
    """Full q [B, Sq, H, 1, dn+dr] and k [B, Skv, H, dn+dr], the shared
    rope key broadcast over the heads (MLA has per-head K/V: one q head
    per kv head)."""
    b, skv, h, _ = k_nope.shape
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, skv, h, k_rope.shape[-1])], dim=-1)
    return q.unsqueeze(3), k


def mla_attention(params, x: torch.Tensor, cfg,
                  cos: Optional[torch.Tensor] = None,
                  sin: Optional[torch.Tensor] = None, *,
                  q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Full-sequence MLA (training / prefill)."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _project_qkv(params, x, cfg, cos, sin)
    k_nope, v = _expand_latent(params, c_kv, cfg)
    qg, k = _heads(q_nope, q_rope, k_nope, k_rope)
    q_pos = q_offset + torch.arange(s, device=x.device)
    out = _chunk_attend(qg, k, v, q_pos, kv_valid_len=s + q_offset,
                        causal=True, window=0, cap=0.0,
                        scale=(dn + dr) ** -0.5, chunk=chunk)
    out = out.reshape(b, s, h * dv)
    return torch.matmul(out, params["wo"].to(x.dtype))


def mla_decode(params, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, pos: int, cfg,
               cos: Optional[torch.Tensor] = None,
               sin: Optional[torch.Tensor] = None, *, chunk: int = 2048):
    """One decode step with the compressed cache: write the new latent
    and rope key at ``pos`` (ckv [B, L, kv_lora_rank], kr [B, L,
    qk_rope_dim], in place) and attend over the cache up to it. Returns
    (out, cache_ckv, cache_kr).

    The write starts at ``pos`` clamped into [0, L - S1], as the JAX
    package's ``dynamic_update_slice`` clamps; the query positions and
    the valid length stay ``pos`` unclamped. Like the reference, every
    step expands the whole latent cache into per-head K/V (the absorbed
    matmul form is not used)."""
    b, s1, _ = x.shape
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    dt = x.dtype
    q_nope, q_rope, c_kv_new, k_rope_new = _project_qkv(params, x, cfg,
                                                        cos, sin)
    at = min(max(int(pos), 0), cache_ckv.shape[1] - s1)
    cache_ckv[:, at:at + s1] = c_kv_new.to(cache_ckv.dtype)
    cache_kr[:, at:at + s1] = k_rope_new.to(cache_kr.dtype)
    k_nope, v = _expand_latent(params, cache_ckv.to(dt), cfg)
    qg, k = _heads(q_nope, q_rope, k_nope, cache_kr.to(dt))
    q_pos = pos + torch.arange(s1, device=x.device)
    out = _chunk_attend(qg, k, v, q_pos, kv_valid_len=pos + s1, causal=True,
                        window=0, cap=0.0, scale=(dn + dr) ** -0.5,
                        chunk=chunk)
    out = out.reshape(b, s1, h * dv)
    return torch.matmul(out, params["wo"].to(dt)), cache_ckv, cache_kr
