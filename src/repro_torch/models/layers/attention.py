"""Attention: the GQA / MQA core as an online softmax over KV chunks,
sliding-window and logit-softcap variants, cross-attention and the KV-cache
decode step (port of the JAX package's ``models/layers/attention.py``).

Plain tensor operations, as in the JAX package, which computes attention
outside any Pallas kernel: a Python loop over KV chunks carries the
FlashAttention recurrence (running max, denominator and accumulator in
float32), and a single chunk runs its body once.

Numerics follow the reference: score and value products take their
operands upcast to float32 (``preferred_element_type=float32``: a product
of two bf16 values is exact in float32), the softmax weights are rounded
to the value dtype before the value product, and masked scores are
``NEG_INF = -1e30``, never ``-inf``.

Layout: q [B, S, Hq, D]; k/v [B, S, Hkv, D]; GQA groups the q heads over
the kv heads without repeating KV.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .embedding import normal
from .norm import softcap as _softcap
from .rope import apply_rope

NEG_INF = -1e30


def attention_init(gen, cfg, dtype=torch.float32, device=None):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    s = d ** -0.5
    return {"wq": normal(gen, (d, hq * hd), s, dtype, device),
            "wk": normal(gen, (d, hkv * hd), s, dtype, device),
            "wv": normal(gen, (d, hkv * hd), s, dtype, device),
            "wo": normal(gen, (hq * hd, d), (hq * hd) ** -0.5, dtype,
                         device)}


def _chunk_attend(q, k, v, q_pos, kv_valid_len, *, causal: bool,
                  window: int, cap: float, scale: float, chunk: int,
                  kv_pos_offset=0) -> torch.Tensor:
    """Blockwise online-softmax attention over KV chunks.

    q [B, Sq, Hkv, R, D] (R q heads per kv head), k/v [B, Skv, Hkv, D],
    q_pos [Sq] absolute positions; kv positions at or past
    ``kv_valid_len`` are masked. Returns [B, Sq, Hkv, R, Dv]."""
    b, sq, hkv, r, _ = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    chunk = min(chunk, skv)
    pad = (-skv) % chunk
    if pad:  # padded slots are masked by kv_valid_len
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = (skv + pad) // chunk
    qf = (q * scale).to(q.dtype).float()
    dev = q.device
    acc = torch.zeros((b, hkv, r, sq, dv), dtype=torch.float32, device=dev)
    mx = torch.full((b, hkv, r, sq), NEG_INF, dtype=torch.float32,
                    device=dev)
    den = torch.zeros((b, hkv, r, sq), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        kv_pos = kv_pos_offset + j * chunk + torch.arange(chunk, device=dev)
        s_ = torch.einsum("bqhrd,bchd->bhrqc", qf, kj.float())
        if cap:
            s_ = _softcap(s_, cap)
        mask = kv_pos[None, :] < kv_valid_len                  # [1, C]
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
        s_ = s_.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(mx, s_.amax(-1))
        p = torch.exp(s_ - m_new[..., None])
        corr = torch.exp(mx - m_new)
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhrqc,bchd->bhrqd", p.to(vj.dtype).float(), vj.float())
        mx = m_new
    out = acc / torch.clamp(den[..., None], min=1e-30)        # [B,Hkv,R,Sq,D]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _blocked_local_attend(q, k, v, *, window: int, cap: float,
                          scale: float) -> torch.Tensor:
    """Exact sliding-window attention in window-sized q blocks: block i's
    queries attend kv blocks i-1 and i, so position p sees (p-w, p].
    q [B, S, Hkv, R, D]; returns the same shape."""
    b, s, hkv, r, d = q.shape
    w = window
    if s % w:
        raise ValueError(f"sequence {s} is no multiple of the window {w}")
    nb = s // w
    qb = (q * scale).reshape(b, nb, w, hkv, r, d)
    kb = k.reshape(b, nb, w, hkv, d)
    vb = v.reshape(b, nb, w, hkv, d)
    k_prev = F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    k2 = torch.cat([k_prev, kb], dim=2)                      # [b,nb,2w,hkv,d]
    v2 = torch.cat([v_prev, vb], dim=2)
    s_ = torch.einsum("bzihrd,bzjhd->bzhrij", qb.float(), k2.float())
    if cap:
        s_ = _softcap(s_, cap)
    dev = q.device
    ii = torch.arange(w, device=dev)[:, None]
    jj = torch.arange(2 * w, device=dev)[None, :]
    mask = (jj > ii) & (jj <= ii + w)                        # (p-w, p]
    blk0 = (torch.arange(nb, device=dev) > 0)[None, :, None, None, None,
                                              None]
    mask_full = mask[None, None, None, None] & (
        blk0 | (jj >= w)[None, None, None, None])            # zero-pad guard
    s_ = s_.masked_fill(~mask_full, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bzhrij,bzjhd->bzihrd", p.to(v2.dtype).float(),
                       v2.float())
    return out.reshape(b, s, hkv, r, d).to(q.dtype)


def _project(params, x, memory=None):
    """q from x; k and v from ``memory`` (x itself when None), each in
    x's dtype with the weights cast per call."""
    dt = x.dtype
    src = x if memory is None else memory
    q = torch.matmul(x, params["wq"].to(dt))
    k = torch.matmul(src, params["wk"].to(dt))
    v = torch.matmul(src, params["wv"].to(dt))
    return q, k, v


def attention(params, x: torch.Tensor, cfg,
              cos: Optional[torch.Tensor] = None,
              sin: Optional[torch.Tensor] = None, *, window: int = 0,
              q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Full-sequence causal self-attention (training / prefill)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project(params, x)
    q, k, v = (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
               v.reshape(b, s, hkv, hd))
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = cfg.attn_scale if cfg.attn_scale else hd ** -0.5
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    if (window and cfg.local_block_attn and q_offset == 0
            and s % window == 0 and s >= 2 * window):
        out = _blocked_local_attend(qg, k, v, window=window,
                                    cap=cfg.attn_softcap, scale=scale)
    else:
        q_pos = q_offset + torch.arange(s, device=x.device)
        out = _chunk_attend(qg, k, v, q_pos, kv_valid_len=s + q_offset,
                            causal=True, window=window,
                            cap=cfg.attn_softcap, scale=scale, chunk=chunk)
    out = out.reshape(b, s, hq * hd)
    return torch.matmul(out, params["wo"].to(x.dtype))


def attention_decode(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg,
                     cos: Optional[torch.Tensor] = None,
                     sin: Optional[torch.Tensor] = None, *,
                     window: int = 0, chunk: int = 2048):
    """One decode step: write the new KV at ``pos`` and attend over the
    cache up to it. x [B, S1, D]; cache [B, L, Hkv, hd], updated in place
    and returned.

    The write starts at ``pos`` clamped into [0, L - S1], as the JAX
    package's ``dynamic_update_slice`` clamps; the positions of the query
    and the valid length stay ``pos`` unclamped."""
    b, s1, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q, k, v = _project(params, x)
    q, k, v = (q.reshape(b, s1, hq, hd), k.reshape(b, s1, hkv, hd),
               v.reshape(b, s1, hkv, hd))
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    max_len = cache_k.shape[1]
    at = min(max(int(pos), 0), max_len - s1)
    cache_k[:, at:at + s1] = k.to(cache_k.dtype)
    cache_v[:, at:at + s1] = v.to(cache_v.dtype)
    scale = cfg.attn_scale if cfg.attn_scale else hd ** -0.5
    qg = q.reshape(b, s1, hkv, hq // hkv, hd)
    q_pos = pos + torch.arange(s1, device=x.device)
    if window and cfg.local_decode_slice and max_len > window:
        # A local layer attends only the last `window` positions: read a
        # window-sized slice of the cache (the write above lands in the
        # full cache).
        start = min(max(pos + s1 - window, 0), max_len - window)
        out = _chunk_attend(
            qg, cache_k[:, start:start + window].to(dt),
            cache_v[:, start:start + window].to(dt), q_pos,
            kv_valid_len=pos + s1, causal=True, window=window,
            cap=cfg.attn_softcap, scale=scale, chunk=chunk,
            kv_pos_offset=start)
    else:
        out = _chunk_attend(
            qg, cache_k.to(dt), cache_v.to(dt), q_pos,
            kv_valid_len=pos + s1, causal=True, window=window,
            cap=cfg.attn_softcap, scale=scale, chunk=chunk)
    out = out.reshape(b, s1, hq * hd)
    return torch.matmul(out, params["wo"].to(dt)), cache_k, cache_v


def cross_attention(params, x: torch.Tensor, memory: torch.Tensor, cfg, *,
                    chunk: int = 1024) -> torch.Tensor:
    """Decoder-side cross-attention over encoder memory (no mask, no
    rope)."""
    b, s, _ = x.shape
    sm = memory.shape[1]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project(params, x, memory)
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    out = _chunk_attend(
        qg, k.reshape(b, sm, hkv, hd), v.reshape(b, sm, hkv, hd),
        torch.arange(s, device=x.device), kv_valid_len=sm, causal=False,
        window=0, cap=0.0, scale=hd ** -0.5, chunk=chunk)
    out = out.reshape(b, s, hq * hd)
    return torch.matmul(out, params["wo"].to(x.dtype))
