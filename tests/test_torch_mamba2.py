"""The port's mamba2 layer (``repro_torch.models.layers.mamba2``) against
the JAX package's, on the CPU.

Weights: the JAX ``mamba2_init`` tree of the reduced zamba2 (d_model 128,
d_inner 256 in 16 heads of 16, state 16, conv 4, chunk 32) with every
leaf redrawn (``make_torch_port_golden.redraw_params``: the initialiser's
``A_log = 0``, ``D = 1``, ``dt_bias = 0`` and ``norm_scale = 0`` would
hide a tiled ``D`` or a wrong ``dt`` slice). Inputs from numpy seeds,
float32.

Tolerances, relative to the JAX output's max |value|:

* the conv (no cumsum): CONV_REL = 1e-6, measured 8.2e-8;
* the chunked forms, which take ``exp`` of cumsum differences (XLA's CPU
  cumsum is not sequential, torch's is): CHUNK_REL = 1e-5, measured
  5.7e-7 (``_ssd_chunked``) and 4.8e-7 (``mamba2_forward``);
* the recurrent decode (no cumsum): each step's output and state within
  DECODE_REL = 1e-5 of the JAX step's on the same cache, measured
  5.3e-7;
* bf16 activations, the same functions on the same bf16-rounded inputs:
  ``mamba2_forward`` and each decode step's output and ``ssm`` state
  within BF16_REL = 2e-2, measured at most 8.3e-3 (2 bf16 ulps: the two
  packages round the conv's bf16 products and sums at different points,
  and the SSD carries that into its float32 state); the decode's
  ``conv`` state, bf16-rounded inputs in float32, bit for bit. At this
  bound a cast moved by one bf16 rounding inside the layer (the conv
  weight left in float32, the ``D`` skip added before the cast) is not
  told apart from that rounding.
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
from repro.models.layers import mamba2 as jm2
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.layers import mamba2 as tm2

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

CONV_REL, CHUNK_REL, DECODE_REL = 1e-6, 1e-5, 1e-5
BF16_REL = 2e-2
JCFG = jreduce(jget_config("zamba2-2.7b"))
CFG = reduce_for_smoke(get_config("zamba2-2.7b"))
D_IN = CFG.ssm_expand * CFG.d_model
NH = D_IN // CFG.ssm_headdim


def params(seed=1):
    tree = jax.tree.map(np.asarray, jm2.mamba2_init(jax.random.PRNGKey(0),
                                                    JCFG))
    return golden.redraw_params(tree, seed)


def t(x):
    return torch.from_numpy(np.array(x))


def close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


def test_config_widths():
    assert (D_IN, NH, CFG.ssm_state, CFG.ssm_chunk, CFG.conv_kernel) == \
        (256, 16, 16, 32, 4)
    p = params()
    assert p["A_log"].max() < 2.0 and p["D"].std() > 0.1
    assert not np.allclose(p["dt_bias"], 0.0)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state"])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(2)
    c = D_IN + 2 * CFG.ssm_state
    x = rng.normal(0, 1, (2, 9, c)).astype(np.float32)
    w = params()["conv_w"]
    st = rng.normal(0, 1, (2, CFG.conv_kernel - 1, c)).astype(np.float32) \
        if with_state else None
    jo, js = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    to, ts = tm2._causal_conv(t(x), t(w), None if st is None else t(st))
    close_rel(to, jo, CONV_REL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.shape == (2, CFG.conv_kernel - 1, c)


def ssd_inputs(seq, seed):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, NH, CFG.ssm_headdim, CFG.ssm_state
    x = rng.normal(0, 1, (b, seq, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, seq, h)))).astype(np.float32)
    A = -np.exp(rng.normal(-1, 0.3, h)).astype(np.float32)
    B = rng.normal(0, 1, (b, seq, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, seq, n)).astype(np.float32)
    pad = (-seq) % CFG.ssm_chunk
    if pad:        # zero dt past the end, as mamba2_forward pads
        x, dt, B, C = (np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                       for a in (x, dt, B, C))
    return x, dt, A, B, C


@pytest.mark.parametrize("seq", [96, 75], ids=["multiple", "padded"])
def test_ssd_chunked_matches_jax(seq):
    """Three chunks of 32 (the carry crosses two boundaries); 75 padded to
    96 with zero dt, as the forward pads."""
    x, dt, A, B, C = ssd_inputs(seq, 3)
    jy, jst = jm2._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                               CFG.ssm_chunk)
    ty, tst = tm2._ssd_chunked(*(t(a) for a in (x, dt, A, B, C)),
                               CFG.ssm_chunk)
    close_rel(ty[:, :seq], np.asarray(jy)[:, :seq], CHUNK_REL)
    close_rel(tst, jst, CHUNK_REL)
    with pytest.raises(ValueError, match="multiple"):
        tm2._ssd_chunked(*(t(a)[:, :seq - 1] if a.ndim > 1 else t(a)
                           for a in (x, dt, A, B, C)), CFG.ssm_chunk)


@pytest.mark.parametrize("seq", [64, 45], ids=["multiple", "padded"])
def test_mamba2_forward_matches_jax(seq):
    p = params()
    x = np.random.default_rng(4).normal(0, 1, (2, seq, CFG.d_model)) \
        .astype(np.float32)
    jo = jm2.mamba2_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            JCFG)
    to = tm2.mamba2_forward({k: t(v) for k, v in p.items()}, t(x), CFG)
    assert to.shape == (2, seq, CFG.d_model) and to.dtype == torch.float32
    close_rel(to, jo, CHUNK_REL)


def test_mamba2_decode_steps_match_jax():
    """12 decode steps from a zero cache, each fed the JAX package's
    previous cache (so each step is held alone): output, ``ssm`` and
    ``conv`` within DECODE_REL; the caches float32."""
    p = params()
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: t(v) for k, v in p.items()}
    x = np.random.default_rng(5).normal(0, 1, (2, 12, CFG.d_model)) \
        .astype(np.float32)
    jc = jm2.mamba2_init_cache(JCFG, 2)
    tc = tm2.mamba2_init_cache(CFG, 2)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    for i in range(12):
        jo, jc_new = jm2.mamba2_decode(jp, jnp.asarray(x[:, i:i + 1]), jc,
                                       JCFG)
        to, tc_new = tm2.mamba2_decode(tp, t(x[:, i:i + 1]),
                                       {k: t(v) for k, v in jc.items()}, CFG)
        close_rel(to, jo, DECODE_REL)
        for k in ("ssm", "conv"):
            assert tc_new[k].dtype == torch.float32
            close_rel(tc_new[k], jc_new[k], DECODE_REL)
        jc = jc_new
    assert float(np.abs(np.asarray(jc["ssm"])).max()) > 0.0


def test_mamba2_decode_carries_bf16_conv_in_a_float32_cache():
    """At bf16 activations the conv state holds bf16-rounded inputs in a
    float32 cache, as the reference's ``new_conv.astype(cache dtype)``."""
    p = {k: t(v) for k, v in params().items()}
    cache = tm2.mamba2_init_cache(CFG, 1)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, 1, CFG.d_model)).astype(np.float32)).to(torch.bfloat16)
    out, new = tm2.mamba2_decode(p, x, cache, CFG)
    assert out.dtype == torch.bfloat16
    assert new["conv"].dtype == new["ssm"].dtype == torch.float32
    assert torch.equal(new["conv"], new["conv"].to(torch.bfloat16).float())


def test_overflowing_masked_decay_keeps_a_finite_gradient():
    """Heads whose log decays sum past 88 inside a chunk (A = -e^3, dt
    about 1) overflow the masked exponent of L: the JAX package's
    gradient is NaN there, the port's finite, the forward values within
    CHUNK_REL. Where nothing overflows, the gradients of dt agree within
    1e-4 x max|g|."""
    for hot in (False, True):
        x, dt, A, B, C = ssd_inputs(64, 13)
        if hot:
            A = A.copy()
            A[:2] = -np.exp(3.0)

        def jloss(dt):
            y, st = jm2._ssd_chunked(jnp.asarray(x), dt, *(
                jnp.asarray(a) for a in (A, B, C)), CFG.ssm_chunk)
            return jnp.sum(y ** 2) + jnp.sum(st ** 2)

        jg = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
        tdt = t(dt).requires_grad_(True)
        ty, tst = tm2._ssd_chunked(t(x), tdt, *(t(a) for a in (A, B, C)),
                                   CFG.ssm_chunk)
        ((ty ** 2).sum() + (tst ** 2).sum()).backward()
        jy, _ = jm2._ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                 CFG.ssm_chunk)
        close_rel(ty, jy, CHUNK_REL)
        assert np.isnan(jg).any() == hot
        assert bool(torch.isfinite(tdt.grad).all())
        if not hot:
            close_rel(tdt.grad, jg, 1e-4)


def bf16_rel(got, want):
    """max |got - want| over max |want|, got the port's bf16 or float32
    tensor, want the JAX package's array of the same dtype."""
    assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                         else torch.float32)
    want = np.asarray(want.astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("case", ["forward-64", "forward-45", "decode"])
def test_bf16_mamba2_matches_jax_within_stated_bound(case):
    """bf16 inputs: the forward (64 tokens, and 45 padded) or 12 decode
    steps, each from the JAX package's previous cache, within BF16_REL;
    the decode's conv state bit for bit."""
    p = params()
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: t(v) for k, v in p.items()}
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    tcfg = dataclasses.replace(CFG, dtype="bfloat16")
    seq = int(case.split("-")[1]) if case != "decode" else 12
    x = np.random.default_rng(4).normal(0, 1, (2, seq, CFG.d_model)) \
        .astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), t(x).bfloat16()
    if case != "decode":
        rel = bf16_rel(tm2.mamba2_forward(tp, tx, tcfg),
                       jm2.mamba2_forward(jp, jx, jcfg))
        assert rel <= BF16_REL, rel
        return
    jc = jm2.mamba2_init_cache(jcfg, 2)
    for i in range(seq):
        jo, jn = jm2.mamba2_decode(jp, jx[:, i:i + 1], jc, jcfg)
        to, tn = tm2.mamba2_decode(tp, tx[:, i:i + 1],
                                   {k: t(v) for k, v in jc.items()}, tcfg)
        for got, want in ((to, jo), (tn["ssm"], jn["ssm"])):
            rel = bf16_rel(got, want)
            assert rel <= BF16_REL, (i, rel)
        np.testing.assert_array_equal(tn["conv"].numpy(),
                                      np.asarray(jn["conv"]))
        jc = jn
