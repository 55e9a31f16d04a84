"""The port's Multi-head Latent Attention (``repro_torch.models.layers.mla``)
against the JAX package's, on the CPU.

Weights and inputs from numpy seeds at ``reduce_for_smoke`` widths
(d_model 128, 4 heads, kv_lora_rank 32, qk 16 + 16, v 16), RoPE angles of
the rope slice: ``mla_attention`` over 20 tokens in one KV chunk and in
chunks of 8, at a q offset, and its gradients; ``mla_decode`` over 12
steps into a 10-row compressed cache, so the last two writes clamp to the
last row as the JAX package's ``dynamic_update_slice`` clamps (outputs and
both caches compared every step). Tolerance: 1e-5 absolute (float32
outputs of size about 1); gradients within 1e-5 x max |g|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models.layers import mla as jmla
from repro.models.layers import rope as jrope
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.layers import mla as tmla
from repro_torch.models.layers import rope as trope

TOL = 1e-5
ARCH = "deepseek-v2-lite-16b"


def cfgs():
    return jreduce(jget_config(ARCH)), reduce_for_smoke(get_config(ARCH))


def mla_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, dc = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {"wq": rng.normal(0, d ** -.5, (d, h * (dn + dr))),
         "wd_kv": rng.normal(0, d ** -.5, (d, dc + dr)),
         "wu_k": rng.normal(0, dc ** -.5, (dc, h * dn)),
         "wu_v": rng.normal(0, dc ** -.5, (dc, h * dv)),
         "wo": rng.normal(0, (h * dv) ** -.5, (h * dv, d))}
    return {k: v.astype(np.float32) for k, v in p.items()}


def angles(cfg, pos):
    pos = np.asarray(pos, np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), cfg.qk_rope_dim,
                               cfg.rope_theta)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), cfg.qk_rope_dim,
                               cfg.rope_theta)
    return (jc, js), (tc, ts)


def t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("chunk,q_offset", [(1024, 0), (8, 0), (8, 3)],
                         ids=["one-chunk", "chunked", "offset"])
def test_mla_attention_matches_jax(chunk, q_offset):
    jcfg, tcfg = cfgs()
    p = mla_params(jcfg, 1)
    s = 20
    x = np.random.default_rng(2).normal(0, 1, (2, s, jcfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(q_offset, q_offset + s), (2, s))
    (jc, js), (tc, ts) = angles(jcfg, pos)

    def jfn(p, x):
        return jmla.mla_attention(p, x, jcfg, jc, js, q_offset=q_offset,
                                  chunk=chunk)

    want, vjp = jax.vjp(jfn, p, jnp.asarray(x))
    tp = {k: t(v, True) for k, v in p.items()}
    tx = t(x, True)
    got = tmla.mla_attention(tp, tx, tcfg, tc, ts, q_offset=q_offset,
                             chunk=chunk)
    close(got, want)
    cot = np.random.default_rng(3).normal(0, 1, want.shape) \
        .astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    for name, g in list(jgp.items()) + [("x", jgx)]:
        mine = tx.grad if name == "x" else tp[name].grad
        scale = float(np.abs(np.asarray(g)).max())
        assert float(np.abs(mine.numpy() - np.asarray(g)).max()) \
            <= TOL * scale, name


def test_mla_decode_matches_jax_and_clamps_past_max_len():
    """12 decode steps of a batch of 2 into a 10-row cache: steps 10 and
    11 write the last row (the write clamps), while their query positions
    and valid lengths run on."""
    jcfg, tcfg = cfgs()
    p = mla_params(jcfg, 4)
    tp = {k: t(v) for k, v in p.items()}
    rng = np.random.default_rng(5)
    max_len = 10
    jckv = jnp.zeros((2, max_len, jcfg.kv_lora_rank))
    jkr = jnp.zeros((2, max_len, jcfg.qk_rope_dim))
    tckv = torch.zeros((2, max_len, tcfg.kv_lora_rank))
    tkr = torch.zeros((2, max_len, tcfg.qk_rope_dim))
    for pos in range(12):
        x = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
        (jc, js), (tc, ts) = angles(jcfg, np.full((2, 1), pos))
        jo, jckv, jkr = jmla.mla_decode(p, jnp.asarray(x), jckv, jkr, pos,
                                        jcfg, jc, js, chunk=4)
        with torch.no_grad():
            to, tckv, tkr = tmla.mla_decode(tp, t(x), tckv, tkr, pos, tcfg,
                                            tc, ts, chunk=4)
        close(to, jo)
        close(tckv, jckv)
        close(tkr, jkr)
    assert tckv.shape == (2, max_len, tcfg.kv_lora_rank)


def test_mla_init_keeps_jax_shapes_and_scales():
    jcfg, tcfg = cfgs()
    jp = jmla.mla_init(jax.random.PRNGKey(0), jcfg)
    tp = tmla.mla_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: v.shape for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    dc = tcfg.kv_lora_rank
    for name, scale in (("wq", tcfg.d_model ** -.5), ("wu_k", dc ** -.5)):
        assert abs(float(tp[name].std()) / scale - 1) < 0.1, name


def test_mla_decode_in_bf16_writes_the_cache_dtype():
    """bf16 activations into a float32 cache: the write casts to the
    cache's dtype, the output stays bf16 (no value contract here beyond
    finiteness: the bf16 bound is the models' test's)."""
    _, tcfg = cfgs()
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = {k: t(v) for k, v in mla_params(tcfg, 6).items()}
    ckv = torch.zeros((1, 4, tcfg.kv_lora_rank))
    kr = torch.zeros((1, 4, tcfg.qk_rope_dim))
    _, (tc, ts) = angles(tcfg, np.zeros((1, 1)))
    x = torch.ones((1, 1, tcfg.d_model), dtype=torch.bfloat16)
    with torch.no_grad():
        out, ckv, kr = tmla.mla_decode(tp, x, ckv, kr, 0, tcfg, tc, ts)
    assert out.dtype == torch.bfloat16 and ckv.dtype == torch.float32
    assert bool(torch.isfinite(out.float()).all()) and ckv[0, 0].abs().sum() > 0
