"""The port's rwkv6 layer (``repro_torch.models.layers.rwkv6``) against the
JAX package's, on the CPU.

Weights: the JAX ``rwkv6_init`` tree of the reduced rwkv6 (d_model 128,
4 heads of 32, d_ff 224, LoRA 64) with every leaf redrawn
(``make_torch_port_golden.redraw_params``: the initialiser's ``mix_* =
0.5``, ``w0 = -2`` and ``ln_scale = 0`` would hide a swapped lerp or a
sample variance). Inputs from numpy seeds, float32.

Tolerances, relative to the JAX output's max |value|:

* the chunked time-mix at chunks 16 and 32 (sequences of 40: padded),
  with and without a carried state and token shift, and the H1
  factorized form at subchunks 4, 8 and 16 (the port's counterparts of
  ``tests/test_perf_variants.py``'s H1 cases): CHUNK_REL = 1e-5, the gap
  XLA's non-sequential CPU cumsum leaves, measured at most 4.5e-7; the
  port's H1 against the port's baseline within 2e-3 absolute, the JAX
  test's bound;
* the recurrent decode and the channel mix (no cumsum): DECODE_REL =
  1e-5 for each step's output and state, measured at most 9.3e-7 (the
  port's decode against its own chunked form: 7.7e-7);
* bf16 activations, the same functions on the same bf16-rounded inputs:
  each output in bf16 (r, k, v, g, the time-mix and channel-mix
  outputs) within BF16_REL = 1.5e-2, about 4 bf16 ulps, measured at
  most 7.3e-3 (the gate's SiLU and what it feeds: the two packages round
  a bf16 chain of elementwise ops at different points); each float32
  output computed from bf16 operands (the decay w, the WKV state) within
  F32_OF_BF16_REL = 1e-6, measured at most 1.5e-7. That bound holds the
  cast of the decay logit after its bf16 sum (a cast before the sum
  moves w by 2.8e-3 and the state by 2.5e-3).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models.layers import rwkv6 as jr6
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.layers import rwkv6 as tr6

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

CHUNK_REL, DECODE_REL, H1_ABS = 1e-5, 1e-5, 2e-3
BF16_REL, F32_OF_BF16_REL = 1.5e-2, 1e-6
S = 40


def cfgs(**kw):
    return (dataclasses.replace(jreduce(jget_config("rwkv6-1.6b")), **kw),
            dataclasses.replace(reduce_for_smoke(get_config("rwkv6-1.6b")),
                                **kw))


JCFG, CFG = cfgs()
NH, N = CFG.d_model // CFG.rwkv_head_size, CFG.rwkv_head_size
_P = {}


def params(seed=1):
    if seed not in _P:
        tree = jax.tree.map(np.asarray, jr6.rwkv6_init(
            jax.random.PRNGKey(0), JCFG))
        _P[seed] = golden.redraw_params(tree, seed)
    return _P[seed]


def both(p):
    return (jax.tree.map(jnp.asarray, p),
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def t(x):
    return torch.from_numpy(np.array(x))


def x_in(seed, shape=(2, S)):
    return np.random.default_rng(seed).normal(
        0, 1, shape + (CFG.d_model,)).astype(np.float32)


def close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


def test_redrawn_leaves_break_the_initialiser_symmetries():
    p = params()
    mixes = [p[f"mix_{c}"] for c in "rkvwg"] + [p["cmix_k"]]
    assert all(0 < m.min() and m.max() < 1 for m in mixes)
    assert not np.allclose(p["mix_r"], p["mix_k"])
    assert np.abs(p["ln_scale"]).max() > 0 and p["w0"].std() > 0.1
    assert p["w_lora_a"].shape == (CFG.d_model, tr6.LORA)


def test_project_matches_jax():
    jp, tp = both(params())
    x, xp = x_in(2), x_in(3)
    jo = jr6._project(jp, jnp.asarray(x), jnp.asarray(xp), JCFG)
    to = tr6._project(tp, t(x), t(xp), CFG)
    for a, b in zip(to, jo):
        close_rel(a, b, DECODE_REL)
    w = to[-1]
    assert w.dtype == torch.float32 and 0 < float(w.min()) \
        and float(w.max()) < 1


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("chunk", [16, 32])
def test_timemix_chunked_matches_jax(chunk, carry):
    """S = 40 at chunk 16 (3 chunks, 8 pad) and 32 (2 chunks, 24 pad);
    ``carried`` starts from a random state and token-shift input."""
    jcfg, tcfg = cfgs(ssm_chunk=chunk)
    jp, tp = both(params())
    x = x_in(4)
    rng = np.random.default_rng(5)
    st = rng.normal(0, 1, (2, NH, N, N)).astype(np.float32) if carry \
        else None
    last = rng.normal(0, 1, (2, 1, CFG.d_model)).astype(np.float32) \
        if carry else None
    jy, jst, jlast = jr6.rwkv6_timemix_chunked(
        jp, jnp.asarray(x), jcfg, None if st is None else jnp.asarray(st),
        None if last is None else jnp.asarray(last))
    ty, tst, tlast = tr6.rwkv6_timemix_chunked(
        tp, t(x), tcfg, None if st is None else t(st),
        None if last is None else t(last))
    close_rel(ty, jy, CHUNK_REL)
    close_rel(tst, jst, CHUNK_REL)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


@pytest.mark.parametrize("sub", [4, 8, 16])
def test_factorized_timemix_matches_jax_and_baseline(sub):
    """H1 at chunk 16 over 48 tokens (``test_perf_variants.py``'s shape):
    the port's factorized form against the JAX package's within
    CHUNK_REL, and against the port's baseline within H1_ABS."""
    jcfg, tcfg = cfgs(ssm_chunk=16, rwkv_factorized=True, rwkv_subchunk=sub)
    jp, tp = both(params())
    x = x_in(6, (1, 48))
    jy, jst, _ = jr6.rwkv6_timemix_chunked(jp, jnp.asarray(x), jcfg)
    ty, tst, _ = tr6.rwkv6_timemix_chunked(tp, t(x), tcfg)
    close_rel(ty, jy, CHUNK_REL)
    close_rel(tst, jst, CHUNK_REL)
    base, _, _ = tr6.rwkv6_timemix_chunked(
        tp, t(x), dataclasses.replace(tcfg, rwkv_factorized=False))
    np.testing.assert_allclose(ty.numpy(), base.numpy(), rtol=H1_ABS,
                               atol=H1_ABS)


def test_timemix_decode_steps_match_jax():
    """12 steps, each from the JAX package's previous state and x_last:
    output, state and x_last within DECODE_REL (x_last exact)."""
    jp, tp = both(params())
    x = x_in(7, (2, 12))
    st = jnp.zeros((2, NH, N, N), jnp.float32)
    last = jnp.zeros((2, 1, CFG.d_model), jnp.float32)
    for i in range(12):
        jy, jst, jlast = jr6.rwkv6_timemix_decode(
            jp, jnp.asarray(x[:, i:i + 1]), JCFG, st, last)
        ty, tst, tlast = tr6.rwkv6_timemix_decode(
            tp, t(x[:, i:i + 1]), CFG, t(st), t(last))
        close_rel(ty, jy, DECODE_REL)
        close_rel(tst, jst, DECODE_REL)
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
        st, last = jst, jlast
    assert float(jnp.abs(st).max()) > 0.0


def test_decode_steps_follow_the_chunked_form():
    """The port's 12 decode steps against its own chunked form over the
    same 12 tokens (one chunk of 12): outputs and the final state within
    CHUNK_REL."""
    _, tp = both(params())
    x = t(x_in(8, (1, 12)))
    full, st_full, _ = tr6.rwkv6_timemix_chunked(tp, x, CFG)
    st = torch.zeros((1, NH, N, N))
    last = torch.zeros((1, 1, CFG.d_model))
    outs = []
    for i in range(12):
        y, st, last = tr6.rwkv6_timemix_decode(tp, x[:, i:i + 1], CFG, st,
                                               last)
        outs.append(y)
    close_rel(torch.cat(outs, 1), full.numpy(), CHUNK_REL)
    close_rel(st, st_full.numpy(), CHUNK_REL)


@pytest.mark.parametrize("shifted", [False, True], ids=["zeros", "x_last"])
def test_channelmix_matches_jax(shifted):
    jp, tp = both(params())
    x = x_in(9)
    last = x_in(10, (2, 1)) if shifted else None
    jo, jlast = jr6.rwkv6_channelmix(
        jp, jnp.asarray(x), JCFG, None if last is None else jnp.asarray(last))
    to, tlast = tr6.rwkv6_channelmix(tp, t(x), CFG,
                                     None if last is None else t(last))
    close_rel(to, jo, DECODE_REL)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


def test_groupnorm_is_the_population_variance():
    """``jnp.var`` divides by N: a sample variance would move every
    output."""
    _, tp = both(params())
    y = torch.from_numpy(np.random.default_rng(11).normal(
        0, 1, (1, 3, NH, N)).astype(np.float32))
    g = torch.ones((1, 3, CFG.d_model))
    got = tr6._group_norm_out(tp, y, g, torch.float32)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = ((y - mu) / torch.sqrt(var + 1e-5)).reshape(1, 3, -1)
    want = (yn * (1 + tp["ln_scale"])) @ tp["wo"]
    close_rel(got, want.numpy(), 1e-5)


@pytest.mark.parametrize("factorized", [False, True], ids=["baseline", "h1"])
def test_overflowing_masked_decay_keeps_a_finite_gradient(factorized):
    """Channels whose decays sum past 88 inside a chunk of 16 (w0 = 2, no
    LoRA: |log w| = e^2 = 7.4 a token, while w stays far above float32's
    smallest normal) overflow a masked exponent: the JAX package's
    gradient is NaN there (0 x inf), the port's is finite, and the
    forward values agree within CHUNK_REL. On the redrawn weights, where
    nothing overflows, the input gradients agree within 1e-4 x max|g|."""
    jcfg, tcfg = cfgs(ssm_chunk=16, rwkv_factorized=factorized,
                      rwkv_subchunk=8)
    x = x_in(12, (1, 32))
    for hot, want_nan in ((False, False), (True, True)):
        p = dict(params())
        if hot:
            p["w0"] = p["w0"].copy()
            p["w0"][:3] = 2.0
            p["w_lora_b"] = np.zeros_like(p["w_lora_b"])
        jp, tp = both(p)

        def jloss(x):
            return jnp.sum(jr6.rwkv6_timemix_chunked(jp, x, jcfg)[0] ** 2)

        jy = jr6.rwkv6_timemix_chunked(jp, jnp.asarray(x), jcfg)[0]
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
        tx = t(x).requires_grad_(True)
        ty = tr6.rwkv6_timemix_chunked(tp, tx, tcfg)[0]
        (ty ** 2).sum().backward()
        close_rel(ty, jy, CHUNK_REL)
        assert np.isnan(jg).any() == want_nan
        assert bool(torch.isfinite(tx.grad).all())
        if not want_nan:
            close_rel(tx.grad, jg, 1e-4)


def bf16_case(case):
    """(the JAX package's outputs, the port's) of one layer function on
    bf16 inputs: x and the token-shift input 2 x S, a random float32
    state for decode (12 steps, each from the JAX package's previous
    state)."""
    jcfg, tcfg = cfgs(dtype="bfloat16")
    jp, tp = both(params())
    x, xp = x_in(4), x_in(3)
    jx, jxp = jnp.asarray(x, jnp.bfloat16), jnp.asarray(xp, jnp.bfloat16)
    tx, txp = t(x).bfloat16(), t(xp).bfloat16()
    if case == "project":
        return (jr6._project(jp, jx, jxp, jcfg),
                tr6._project(tp, tx, txp, tcfg))
    if case.startswith(("chunk", "h1")):
        kw = dict(ssm_chunk=16, rwkv_factorized=True,
                  rwkv_subchunk=int(case[5:])) if case.startswith("h1") \
            else dict(ssm_chunk=int(case[5:]))
        jc, tc = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
        jy, jst, _ = jr6.rwkv6_timemix_chunked(jp, jx, jc, None, jxp[:, :1])
        ty, tst, _ = tr6.rwkv6_timemix_chunked(tp, tx, tc, None, txp[:, :1])
        return (jy, jst), (ty, tst)
    if case == "channelmix":
        return (jr6.rwkv6_channelmix(jp, jx, jcfg, jxp[:, :1])[:1],
                tr6.rwkv6_channelmix(tp, tx, tcfg, txp[:, :1])[:1])
    st = np.random.default_rng(5).normal(0, 1, (2, NH, N, N)) \
        .astype(np.float32)
    want, got = [], []
    for i in range(12):
        jy, jst, _ = jr6.rwkv6_timemix_decode(
            jp, jx[:, i:i + 1], jcfg, jnp.asarray(st), jxp[:, i:i + 1])
        ty, tst, _ = tr6.rwkv6_timemix_decode(
            tp, tx[:, i:i + 1], tcfg, t(st), txp[:, i:i + 1])
        want += [jy, jst]
        got += [ty, tst]
        st = np.asarray(jst)
    return want, got


@pytest.mark.parametrize("case", ["project", "chunk16", "chunk32", "h1sub4",
                                  "h1sub8", "decode", "channelmix"])
def test_bf16_layers_match_jax_within_stated_bounds(case):
    """Each output in the JAX package's dtype, bf16 ones within BF16_REL
    and float32 ones within F32_OF_BF16_REL of its max |value|."""
    want, got = bf16_case(case)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        bf16 = w.dtype == jnp.bfloat16
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        w = np.asarray(w.astype(jnp.float32))
        err = float(np.abs(g.float().numpy() - w).max())
        scale = float(np.abs(w).max())
        assert scale > 0.0
        assert err <= (BF16_REL if bf16 else F32_OF_BF16_REL) * scale, \
            (case, err, scale)
