"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with a
data-dependent decay, and channel-mix (port of the JAX package's
``models/layers/rwkv6.py``).

Time-mix recurrence per head (head size N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u k_t)^T v_t)     (bonus u on the current token)
with w_t = exp(-exp(w0 + LoRA(x_t))) in (0, 1), per channel.

Training and prefill run the chunked form: the decay-weighted quadratic
term inside a chunk, a state carried across chunks (a Python loop over
chunks in place of the JAX package's ``lax.scan``). ``rwkv_factorized``
selects H1, the subchunk-exact 3-factor form without the [c, c, n] decay
tensor. Decode is the O(1) state update. All of it is plain tensor
operations, as in the JAX package, which computes it outside any Pallas
kernel.

Casts follow the reference: the five token-shift lerps, the projections
and the decay LoRA in the activation dtype, the decay logit cast to
float32 only after its sum, the WKV state and the per-head groupnorm in
float32 (population variance, ``correction=0``, as ``jnp.var``).

One difference by design: the masked exponentials of the chunked forms
(``_masked_exp``) give the reference's values, but a finite gradient
where a masked exponent overflows; the reference's is NaN there, which
a full-width rwkv6 reaches on its first training step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .embedding import normal

LORA = 64           # the decay LoRA's width


def rwkv6_init(gen, cfg, dtype=torch.float32, device=None):
    """The JAX package's tree, shapes and scales (every ``mix_*`` 0.5,
    ``w0`` -2, ``ln_scale`` zeros); the values come from ``gen``."""
    d = cfg.d_model
    n = cfg.rwkv_head_size
    nh = d // n
    s = d ** -0.5

    def full(v):
        return torch.full((d,), v, dtype=dtype, device=device)

    return {
        # time-mix
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": normal(gen, (d, d), s, dtype, device),
        "wk": normal(gen, (d, d), s, dtype, device),
        "wv": normal(gen, (d, d), s, dtype, device),
        "wg": normal(gen, (d, d), s, dtype, device),
        "wo": normal(gen, (d, d), s, dtype, device),
        "w0": full(-2.0),                                  # base decay logit
        "w_lora_a": normal(gen, (d, LORA), s, dtype, device),
        "w_lora_b": normal(gen, (LORA, d), LORA ** -0.5, dtype, device),
        "u": normal(gen, (nh, n), 0.1, dtype, device),     # bonus
        "ln_scale": torch.zeros((d,), dtype=dtype, device=device),
        # channel-mix
        "cmix_k": full(0.5),
        "ck": normal(gen, (d, cfg.d_ff), s, dtype, device),
        "cv": normal(gen, (cfg.d_ff, d), cfg.d_ff ** -0.5, dtype, device),
    }


def _masked_exp(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(x) where ``mask``, else 0: the JAX package's ``where(mask,
    exp(x), 0)``, the same values. Its gradient stays finite where a
    masked exponent overflows (the reference's is 0 x inf = NaN there: a
    chunk whose decays sum past 88)."""
    return torch.exp(x.masked_fill(~mask, float("-inf")))


def _factorized_intra(rc, kc, vc, wc, wcum, u, chunk: int, sub: int):
    """H1: the intra-chunk time-mix without the [c, c, n] decay tensor.

    rc / kc / vc / wc / wcum: [nc, b, h, c, n] (wc the log decay, wcum its
    inclusive cumsum). The chunk splits into P = c / sub subchunks: the
    exact pairwise form inside each ([P, u, u, n]), and 3-factor bridges
    across them, every exponent <= 0. Returns (y_intra + y_cross,
    y_bonus), each [nc, b, h, c, n]."""
    z, b, h, c, n = rc.shape
    if c % sub:
        raise ValueError(f"chunk {c} is no multiple of the subchunk {sub}")
    P = c // sub
    shp = (z, b, h, P, sub, n)
    r_s, k_s, v_s = (t.reshape(shp) for t in (rc, kc, vc))
    w_s = wc.reshape(shp)
    wq_s = wcum.reshape(shp)
    dev = rc.device

    # ---- exact within-subchunk pairs (strictly lower triangular)
    ii = torch.arange(sub, device=dev)
    strict_s = (ii[:, None] > ii[None, :])[None, None, None, None, :, :]
    di = wq_s[..., :, None, :] - wq_s[..., None, :, :] - w_s[..., :, None, :]
    dec = _masked_exp(di, strict_s[..., None])
    att_d = torch.einsum("zbhpin,zbhpijn,zbhpjn->zbhpij", r_s, dec, k_s)
    y_diag = torch.einsum("zbhpij,zbhpjm->zbhpim", att_d, v_s)

    # ---- cross-subchunk 3-factor bridges (all exponents <= 0)
    # base[p]: the cumulative log decay to the end of subchunk p-1 (0 at 0)
    base = F.pad(wq_s[..., -1, :], (0, 0, 1, 0))[..., :-1, :]
    rd = r_s * torch.exp(wq_s - w_s - base[..., None, :])        # T1 <= 0
    end = wq_s[..., -1, :]                                       # [z,b,h,P,n]
    kt = k_s * torch.exp(end[..., None, :] - wq_s)               # T3 <= 0
    pp = torch.arange(P, device=dev)
    pq_mask = pp[:, None] > pp[None, :]
    bridge = _masked_exp(base[..., :, None, :] - end[..., None, :, :],
                         pq_mask[None, None, None, :, :, None])     # T2
    t1 = torch.einsum("zbhpqn,zbhqjn->zbhpqjn", bridge, kt)      # [.,P,P,u,n]
    att_x = torch.einsum("zbhpin,zbhpqjn->zbhpiqj", rd, t1)      # [.,P,u,P,u]
    y_cross = torch.einsum("zbhpiqj,zbhqjm->zbhpim", att_x, v_s)

    y = (y_diag + y_cross).reshape(z, b, h, c, n)
    y_bonus = torch.einsum("zbhin,hn,zbhin,zbhim->zbhim", rc, u, kc, vc)
    return y, y_bonus


def _token_shift(x: torch.Tensor, last=None) -> torch.Tensor:
    """x [B, S, D] -> the previous token's x (zeros, or ``last``, at
    t = 0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _project(params, x, x_prev, cfg):
    """(r, k, v, g in x's dtype; w, the float32 decay in (0, 1))."""
    dt = x.dtype

    def mix(name):
        m = params[f"mix_{name}"].to(dt)
        return x * m + x_prev * (1.0 - m)

    r = torch.matmul(mix("r"), params["wr"].to(dt))
    k = torch.matmul(mix("k"), params["wk"].to(dt))
    v = torch.matmul(mix("v"), params["wv"].to(dt))
    g = F.silu(torch.matmul(mix("g"), params["wg"].to(dt)))
    lora = torch.matmul(torch.matmul(mix("w"), params["w_lora_a"].to(dt)),
                        params["w_lora_b"].to(dt))
    w_logit = params["w0"].to(dt) + lora
    # w in (0, 1): exp(-exp(logit)), a data-dependent per-channel decay
    w = torch.exp(-torch.exp(w_logit.float()))
    return r, k, v, g, w


def _heads(x, nh: int, n: int):
    b, s, _ = x.shape
    return x.reshape(b, s, nh, n)


def _group_norm_out(params, y, g, dt):
    """Per-head groupnorm of y [B, S, H, N] (float32), then the gate and
    the output projection in ``dt``."""
    b, s = y.shape[:2]
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 1e-5)
    y = y.reshape(b, s, -1).to(dt) * (1.0 + params["ln_scale"].to(dt))
    y = y * g
    return torch.matmul(y, params["wo"].to(dt))


def rwkv6_timemix_chunked(params, x, cfg, state=None, x_last=None):
    """The chunked parallel form. x [B, S, D]; ``state`` [B, H, N, N] the
    carried WKV state (zeros when None), ``x_last`` [B, 1, D] for the
    token shift. Returns (y, the new state, the new x_last)."""
    b, s, d = x.shape
    n = cfg.rwkv_head_size
    nh = d // n
    chunk = min(cfg.ssm_chunk or 128, s) or s
    dt = x.dtype

    x_prev = _token_shift(x, x_last)
    r, k, v, g, w = _project(params, x, x_prev, cfg)
    rh = _heads(r, nh, n).float()
    kh = _heads(k, nh, n).float()
    vh = _heads(v, nh, n).float()
    wh = _heads(torch.log(torch.clamp(w, min=1e-38)), nh, n)   # log-decay < 0
    u = params["u"].float()                                    # [H, N]

    pad = (-s) % chunk
    if pad:
        rh, kh, vh, wh = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (rh, kh, vh, wh))
    sp = s + pad
    nc = sp // chunk

    def chunks(t):                                             # [nc,b,h,c,n]
        return t.reshape(b, nc, chunk, nh, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = chunks(rh), chunks(kh), chunks(vh), chunks(wh)
    if state is None:
        state = torch.zeros((b, nh, n, n), dtype=torch.float32,
                            device=x.device)

    # ---- phase 1 (chunk-parallel): intra-chunk attention and bonus, and
    # each chunk's contribution to the state
    wcum = torch.cumsum(wc, dim=3)                             # [nc,b,h,c,n]
    if cfg.rwkv_factorized:
        y_intra, y_bonus = _factorized_intra(rc, kc, vc, wc, wcum, u, chunk,
                                             cfg.rwkv_subchunk)
    else:
        # token j reaching i (j < i) decays strictly between them:
        # exp(wcum[i] - wcum[j] - w[i]), as decode does
        ii = torch.arange(chunk, device=x.device)
        strict = (ii[:, None] > ii[None, :])[None, None, None, :, :]
        di = wcum[:, :, :, :, None, :] - wcum[:, :, :, None, :, :] \
            - wc[:, :, :, :, None, :]
        decay = _masked_exp(di, strict[..., None])
        att = torch.einsum("zbhin,zbhijn,zbhjn->zbhij", rc, decay, kc)
        y_intra = torch.einsum("zbhij,zbhjm->zbhim", att, vc)
        y_bonus = torch.einsum("zbhin,hn,zbhin,zbhim->zbhim", rc, u, kc, vc)
    dk = torch.exp(wcum[:, :, :, -1:, :] - wcum)               # decay j->end
    chunk_states = torch.einsum("zbhjn,zbhjn,zbhjm->zbhnm", kc, dk, vc)
    chunk_decay = torch.exp(wcum[:, :, :, -1, :])              # [nc,b,h,n]

    # ---- phase 2 (sequential): carry the [b, h, n, n] state across
    # chunks, keeping the state before each
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[z][..., None] + chunk_states[z]
    prev_states = torch.stack(prev)

    # ---- phase 3 (chunk-parallel): the carried state's contribution
    dstate = torch.exp(wcum - wc)                              # [nc,b,h,c,n]
    y_state = torch.einsum("zbhin,zbhin,zbhnm->zbhim", rc, dstate,
                           prev_states)

    yc = y_intra + y_bonus + y_state                           # [nc,b,h,c,m]
    y = yc.permute(1, 0, 3, 2, 4).reshape(b, sp, nh, n)[:, :s]
    return _group_norm_out(params, y, g, dt), state, x[:, -1:]


def rwkv6_timemix_decode(params, x, cfg, state, x_last):
    """The O(1) decode step. x [B, 1, D]; state [B, H, N, N] float32.
    Returns (y, the new state, the new x_last)."""
    d = x.shape[-1]
    n = cfg.rwkv_head_size
    nh = d // n
    r, k, v, g, w = _project(params, x, x_last, cfg)
    rh = _heads(r, nh, n)[:, 0].float()                        # [b,h,n]
    kh = _heads(k, nh, n)[:, 0].float()
    vh = _heads(v, nh, n)[:, 0].float()
    whh = _heads(w, nh, n)[:, 0]                               # in (0, 1)
    u = params["u"].float()
    kv = torch.einsum("bhn,bhm->bhnm", kh, vh)
    y = torch.einsum("bhn,bhnm->bhm", rh, state + u[None, :, :, None] * kv)
    state = state * whh[..., None] + kv
    return _group_norm_out(params, y[:, None], g, x.dtype), state, x


def rwkv6_channelmix(params, x, cfg, x_last=None):
    """Channel-mix: a token-shifted relu^2 MLP. Returns (out, the new
    x_last)."""
    dt = x.dtype
    x_prev = _token_shift(x, x_last)
    m = params["cmix_k"].to(dt)
    xk = x * m + x_prev * (1.0 - m)
    h = torch.matmul(xk, params["ck"].to(dt))
    h = torch.square(F.relu(h))
    return torch.matmul(h, params["cv"].to(dt)), x[:, -1:]
