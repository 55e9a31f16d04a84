"""Mamba2 (SSD) layer, the chunked state-space duality form
(arXiv:2405.21060) of Zamba2's backbone (arXiv:2411.15242); port of the
JAX package's ``models/layers/mamba2.py``.

Training and prefill run the chunked SSD: an intra-chunk quadratic term
plus a state carried across chunks. The JAX package carries it with
``lax.scan``; the port with a Python loop over chunks, which returns the
state before each chunk as the scan does. Decode is the O(1) recurrent
state [B, H, P, N]. Both are plain tensor operations, as in the JAX
package, which computes them outside any Pallas kernel.

Casts follow the reference statement by statement: projections and the
conv in the activation dtype (weights cast per call), the SSD in float32
on x, B and C cast from it, the gated RMSNorm in float32. ``D`` repeats
each head's value ``headdim`` times (``jnp.repeat``, which is
``repeat_interleave``, not ``Tensor.repeat``). One difference by design:
the causal decay matrix has the reference's values, but a finite
gradient where a masked exponent overflows (a chunk whose decays sum
past 88), where the reference's is NaN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .embedding import normal


def _dims(cfg):
    """(d_inner, state, headdim, heads)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, cfg.ssm_headdim, d_in // cfg.ssm_headdim


def mamba2_init(gen, cfg, dtype=torch.float32, device=None):
    """The JAX package's tree, shapes and scales (``A_log``, ``dt_bias``
    and ``norm_scale`` zeros, ``D`` ones); the values come from ``gen``."""
    d = cfg.d_model
    d_in, n, _, nh = _dims(cfg)
    s = d ** -0.5
    return {
        # projections for z (gate), x, B, C, dt
        "in_proj": normal(gen, (d, 2 * d_in + 2 * n + nh), s, dtype, device),
        "out_proj": normal(gen, (d_in, d), d_in ** -0.5, dtype, device),
        "conv_w": normal(gen, (cfg.conv_kernel, d_in + 2 * n), 0.1, dtype,
                         device),
        "A_log": torch.zeros((nh,), dtype=dtype, device=device),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "norm_scale": torch.zeros((d_in,), dtype=dtype, device=device),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """(z, xBC, dt) of the input projection."""
    d_in, n, _, nh = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n],
            zxbcdt[..., -nh:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv over time, then SiLU. xbc [B, S, C], w [K, C];
    ``state``: the previous K-1 inputs [B, K-1, C] (zeros when None).
    Returns (out, the last K-1 inputs)."""
    k = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                          # [B,S+K-1,C]
    s = xbc.shape[1]
    out = 0
    for i in range(k):                  # Python's sum: the taps in order
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_state


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD. x [b, l, h, p]; dt [b, l, h]; A [h]; B, C [b, l, n].
    Returns y [b, l, h, p] and the final state [b, h, p, n]."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"length {l} is no multiple of the chunk {chunk}")
    nc = l // chunk
    a = dt * A[None, None, :]                                # log-decay < 0
    xr = x.reshape(b, nc, chunk, h, p)
    ar = a.reshape(b, nc, chunk, h)
    Br = B.reshape(b, nc, chunk, n)
    Cr = C.reshape(b, nc, chunk, n)
    dtr = dt.reshape(b, nc, chunk, h)

    a_cum = torch.cumsum(ar, dim=2)                          # [b,nc,c,h]
    # intra-chunk (diagonal block): L[i, j] = exp(a_cum[i] - a_cum[j]), i >= j
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # [b,nc,i,j,h]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # exp where causal, else 0, with a finite gradient where a masked
    # exponent overflows (the reference's where(causal, exp(seg), 0) has
    # 0 x inf = NaN there)
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bzin,bzjn->bzij", Cr, Br)             # [b,nc,i,j]
    y_diag = torch.einsum("bzij,bzijh,bzjh,bzjhp->bzihp", cb, L, dtr, xr)

    # per-chunk input -> state contribution
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # [b,nc,c,h]
    chunk_states = torch.einsum("bzcn,bzch,bzch,bzchp->bzhpn", Br,
                                decay_to_end, dtr, xr)       # [b,nc,h,p,n]
    chunk_decay = torch.exp(a_cum[:, :, -1, :])              # [b,nc,h]

    # inter-chunk recurrence (the scan): the state BEFORE each chunk
    state = x.new_zeros((b, h, p, n))
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, z, :, None, None] + chunk_states[:, z]
    prev_states = torch.stack(prev, dim=1)                   # [b,nc,h,p,n]

    # contribution of the carried-in state to each position
    state_decay = torch.exp(a_cum)                           # [b,nc,c,h]
    y_off = torch.einsum("bzcn,bzch,bzhpn->bzchp", Cr, state_decay,
                         prev_states)
    return (y_diag + y_off).reshape(b, l, h, p), state


def _gated_norm_out(params, y, z, dt_):
    """Gated RMSNorm (norm before out_proj), then the output projection."""
    yn = y * F.silu(z)
    var = yn.float().square().mean(-1, keepdim=True)
    yn = (yn.float() * torch.rsqrt(var + 1e-6)
          * (1.0 + params["norm_scale"].float())).to(dt_)
    return torch.matmul(yn, params["out_proj"].to(dt_))


def mamba2_forward(params, x_in: torch.Tensor, cfg) -> torch.Tensor:
    """Training / prefill forward. x_in [B, S, D] -> [B, S, D]."""
    b, s, _ = x_in.shape
    d_in, n, hp, nh = _dims(cfg)
    dt_ = x_in.dtype
    zxbcdt = torch.matmul(x_in, params["in_proj"].to(dt_))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, _ = _causal_conv(xbc, params["conv_w"].to(dt_))
    xs, B, C = xbc[..., :d_in], xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # [b,s,nh]
    A = -torch.exp(params["A_log"].float())                      # [nh]
    xh = xs.reshape(b, s, nh, hp)
    # pad the sequence to a chunk multiple (zero dt: no contribution)
    pad = (-s) % cfg.ssm_chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, _ = _ssd_chunked(xh.float(), dt, A, B.float(), C.float(),
                        cfg.ssm_chunk)
    y = y[:, :s].reshape(b, s, d_in).to(dt_)
    y = y + xs * params["D"].to(dt_).repeat_interleave(hp)[None, None, :]
    return _gated_norm_out(params, y, z, dt_)


def mamba2_init_cache(cfg, batch: int, dtype=torch.float32, device=None):
    """{"ssm" [B, H, P, N], "conv" [B, K-1, d_inner + 2N]}, zeros."""
    d_in, n, hp, nh = _dims(cfg)
    return {"ssm": torch.zeros((batch, nh, hp, n), dtype=dtype,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_in + 2 * n),
                                dtype=dtype, device=device)}


def mamba2_decode(params, x_in: torch.Tensor, cache, cfg):
    """One-token recurrent step. x_in [B, 1, D]. Returns (out [B, 1, D],
    the new {"ssm", "conv"} in the cache's dtypes); the cache is not
    written."""
    b = x_in.shape[0]
    d_in, n, hp, nh = _dims(cfg)
    dt_ = x_in.dtype
    zxbcdt = torch.matmul(x_in, params["in_proj"].to(dt_))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    # conv state update
    conv_in = torch.cat([cache["conv"].to(dt_), xbc], dim=1)
    w = params["conv_w"].to(dt_)
    xbc = F.silu(torch.sum(conv_in * w[None, :, :], dim=1, keepdim=True))
    new_conv = conv_in[:, 1:]

    xs, B, C = xbc[..., :d_in], xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())[:, 0]
    A = -torch.exp(params["A_log"].float())
    dec = torch.exp(dt * A[None, :])                                # [b,nh]
    xh = xs.reshape(b, nh, hp).float()
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B[:, 0].float(), xh)
    state = cache["ssm"].float() * dec[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), state)
    y = y.reshape(b, 1, d_in).to(dt_)
    y = y + xs * params["D"].to(dt_).repeat_interleave(hp)[None, None, :]
    out = _gated_norm_out(params, y, z, dt_)
    return out, {"ssm": state.to(cache["ssm"].dtype),
                 "conv": new_conv.to(cache["conv"].dtype)}
