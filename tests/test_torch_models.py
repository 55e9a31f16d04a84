"""The port's model zoo (``repro_torch.models``) against the JAX package's,
on the CPU.

Layers on the same numpy inputs through both packages: RMSNorm and
LayerNorm, softcap, RoPE / M-RoPE / the sinusoidal table, the three MLP
activations gated and plain, and attention at full length, at decode
(the cache write clamped past max_len), under a sliding window, with a
logit softcap, blocked-local, decode from a window slice, and cross.
Tolerance: 1e-5 absolute in float32; the bf16 attention case within
2e-2 absolute (a few bf16 ulps of outputs of size about 1), stated where
it is checked.

The five attention-only configs, reduced (``reduce_for_smoke``), with the
JAX package's parameters carried across by ``params_from_numpy``:
``forward`` logits and per-block stats, 8 ``decode_step``s and greedy
tokens. Tolerance: 1e-4 absolute on logits (float32); tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import blocks as jblocks
from repro.models.layers import attention as jattn
from repro.models.layers import mlp as jmlp
from repro.models.layers import norm as jnorm
from repro.models.layers import rope as jrope
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import blocks
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norm as tnorm
from repro_torch.models.layers import rope as trope

ARCHS = ("yi-6b", "gemma2-9b", "granite-20b", "minitron-4b", "qwen2-vl-2b")
F32_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2


def t(x, dtype=None):
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


def tree_t(tree):
    return {k: t(v) for k, v in tree.items()}


def close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def cfgs(arch="yi-6b", **kw):
    """(JAX config, port config), reduced, with the same overrides."""
    return (dataclasses.replace(jreduce(jget_config(arch)), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **kw))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 48)).astype(np.float32)
    p = {"scale": rng.normal(0, .2, 48).astype(np.float32),
         "bias": rng.normal(0, .2, 48).astype(np.float32)}
    if kind == "rms":
        want = jnorm.rmsnorm(p, jnp.asarray(x), 1e-6)
        got = tnorm.rmsnorm(tree_t(p), t(x), 1e-6)
    else:
        want = jnorm.layernorm(p, jnp.asarray(x), 1e-5)
        got = tnorm.layernorm(tree_t(p), t(x), 1e-5)
    close(got, want)
    tx = t(x)
    close(tnorm.softcap(tx, 2.5), jnorm.softcap(jnp.asarray(x), 2.5))
    assert tnorm.softcap(tx, 0.0) is tx


def test_rope_mrope_sinusoidal_match_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    x = rng.normal(0, 1, (2, 7, 3, 32)).astype(np.float32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 32, 5e6)
    tc, ts = trope.rope_angles(t(pos), 32, 5e6)
    close(tc, jc)
    close(ts, js)
    close(trope.apply_rope(t(x), tc, ts),
          jrope.apply_rope(jnp.asarray(x), jc, js))
    pos3 = rng.integers(0, 300, (2, 3, 7)).astype(np.int32)
    jc, js = jrope.mrope_angles(jnp.asarray(pos3), 32, 1e6, (4, 6, 6))
    tc, ts = trope.mrope_angles(t(pos3), 32, 1e6, (4, 6, 6))
    close(tc, jc)
    close(ts, js)
    close(trope.sinusoidal_embedding(50, 24),
          jrope.sinusoidal_embedding(50, 24))
    np.testing.assert_array_equal(
        trope.positions_from_segment(3, 4, 5).numpy(),
        np.asarray(jrope.positions_from_segment(3, 4, 5)))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu2", False)])
def test_mlp_matches_jax(act, gated):
    rng = np.random.default_rng(2)
    p = {"w_in": rng.normal(0, .1, (32, 64)),
         "w_out": rng.normal(0, .1, (64, 32))}
    if gated:
        p["w_gate"] = rng.normal(0, .1, (32, 64))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
    close(tmlp.mlp(tree_t(p), t(x), act, gated),
          jmlp.mlp(p, jnp.asarray(x), act, gated))


def attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    return {"wq": rng.normal(0, d ** -.5, (d, hq * hd)),
            "wk": rng.normal(0, d ** -.5, (d, hkv * hd)),
            "wv": rng.normal(0, d ** -.5, (d, hkv * hd)),
            "wo": rng.normal(0, (hq * hd) ** -.5, (hq * hd, d))}


ATTN_CASES = {
    # name: (config overrides, window, sequence, chunk)
    "full": ({}, 0, 20, 1024),
    "chunked": ({}, 0, 21, 8),
    "window": ({}, 5, 20, 8),
    "softcap": ({"attn_softcap": 2.0, "attn_scale": 0.25}, 0, 20, 1024),
    "blocked-local": ({"local_block_attn": True, "attn_softcap": 3.0}, 4,
                      16, 1024),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(case):
    kw, window, s, chunk = ATTN_CASES[case]
    jcfg, tcfg = cfgs(**kw)
    p = {k: v.astype(np.float32) for k, v in attn_params(jcfg, 3).items()}
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jc, js = jrope.rope_angles(jnp.asarray(pos), jcfg.head_dim, 1e4)
    tc, ts = trope.rope_angles(t(pos), tcfg.head_dim, 1e4)
    want = jattn.attention(p, jnp.asarray(x), jcfg, jc, js, window=window,
                           chunk=chunk)
    got = tattn.attention(tree_t(p), t(x), tcfg, tc, ts, window=window,
                          chunk=chunk)
    close(got, want)


def test_attention_bf16_within_stated_bound():
    """bf16 activations: operands upcast to float32 in both products, the
    weights rounded to bf16 before the value product. The two packages'
    bf16 matmuls may round differently, so the bound is a few bf16 ulps
    of outputs of size about 1: BF16_TOL = 2e-2 absolute."""
    jcfg, tcfg = cfgs(dtype="bfloat16", attn_softcap=5.0)
    p = {k: v.astype(np.float32) for k, v in attn_params(jcfg, 5).items()}
    x = np.random.default_rng(6).normal(0, 1, (2, 12, jcfg.d_model)) \
        .astype(np.float32)
    want = jattn.attention(p, jnp.asarray(x, jnp.bfloat16), jcfg, window=5,
                           chunk=4)
    got = tattn.attention(tree_t(p), t(x, torch.bfloat16), tcfg, window=5,
                          chunk=4)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)


@pytest.mark.parametrize("case", ["global", "window-slice", "past-max-len"])
def test_attention_decode_matches_jax(case):
    """Decode steps into a cache of 12 rows: the JAX package's write clamps
    its start into the cache, and so does the port's (``past-max-len``
    decodes at positions 10-15)."""
    kw, window = {}, 0
    if case == "window-slice":
        kw, window = {"local_decode_slice": True}, 4
    jcfg, tcfg = cfgs(**kw)
    p = {k: v.astype(np.float32) for k, v in attn_params(jcfg, 7).items()}
    rng = np.random.default_rng(8)
    hkv, hd, max_len = jcfg.num_kv_heads, jcfg.head_dim, 12
    jk = jnp.zeros((2, max_len, hkv, hd))
    jv = jnp.zeros((2, max_len, hkv, hd))
    tk = torch.zeros((2, max_len, hkv, hd))
    tv = torch.zeros((2, max_len, hkv, hd))
    start = 10 if case == "past-max-len" else 0
    for pos in range(start, start + 6):
        x = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
        pp = np.full((2, 1), pos, np.int32)
        jc, js = jrope.rope_angles(jnp.asarray(pp), hd, 1e4)
        tc, ts = trope.rope_angles(t(pp), hd, 1e4)
        jo, jk, jv = jattn.attention_decode(p, jnp.asarray(x), jk, jv, pos,
                                            jcfg, jc, js, window=window)
        to, tk, tv = tattn.attention_decode(tree_t(p), t(x), tk, tv, pos,
                                            tcfg, tc, ts, window=window)
        close(to, jo)
        close(tk, jk)
        close(tv, jv)


def test_cross_attention_matches_jax():
    jcfg, tcfg = cfgs()
    p = {k: v.astype(np.float32) for k, v in attn_params(jcfg, 9).items()}
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (2, 6, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(0, 1, (2, 11, jcfg.d_model)).astype(np.float32)
    close(tattn.cross_attention(tree_t(p), t(x), t(mem), tcfg, chunk=4),
          jattn.cross_attention(p, jnp.asarray(x), jnp.asarray(mem), jcfg,
                                chunk=4))


# ------------------------------------------------------------------ models
_MODELS = {}


def models(arch):
    """(JAX model, its params, the port's model from them, port config)."""
    if arch not in _MODELS:
        jcfg, tcfg = cfgs(arch)
        jm = jbuild_model(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
        _MODELS[arch] = (jm, params, tm, tcfg)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_kinds_match_jax(arch):
    jcfg, tcfg = cfgs(arch)
    assert blocks.stage_unit_kinds(tcfg) == jblocks.stage_unit_kinds(jcfg)
    full = get_config(arch)
    assert blocks.stage_unit_kinds(full) == \
        jblocks.stage_unit_kinds(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jm, params, tm, cfg = models(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    kw = {}
    if cfg.pos_type == "mrope":
        kw["positions"] = rng.integers(0, 40, (2, 3, 13)).astype(np.int32)
    jl, jst = jm.forward(params, tokens=jnp.asarray(toks),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tl, tst = tm(t(toks), **{k: t(v) for k, v in kw.items()})
        last, _ = tm(t(toks), last_only=True,
                     **{k: t(v) for k, v in kw.items()})
    assert tl.dtype == torch.float32 and tl.shape == (2, 13, cfg.vocab_size)
    close(tl, jl, LOGIT_TOL)
    close(last, np.asarray(jl)[:, -1:], LOGIT_TOL)
    assert len(tst["stack"]) == len(jst["stack"])
    for ts, js in zip(tst["stack"], jst["stack"]):
        assert set(ts) == set(js)
        for k in ts:
            close(ts[k], js[k], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_greedy_tokens_match_jax(arch):
    """8 decode steps of a batch of 2 into a 16-row cache, logits within
    LOGIT_TOL; then greedy generation of 6 tokens from each package's own
    argmax, equal token for token."""
    jm, params, tm, cfg = models(arch)
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 8)) \
        .astype(np.int32)
    jdec = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    for pos in range(8):
        jl, jc = jdec(params, jnp.asarray(toks[:, pos:pos + 1]), jc, pos)
        tl, tc = tm.decode_step(t(toks[:, pos:pos + 1]), tc, pos)
        close(tl, jl, LOGIT_TOL)
    jt, tt = toks[:, -1:], toks[:, -1:]
    jgen, tgen = [], []
    for pos in range(8, 14):
        jl, jc = jdec(params, jnp.asarray(jt), jc, pos)
        tl, tc = tm.decode_step(t(tt), tc, pos)
        jt = np.argmax(np.asarray(jl, np.float32)[:, 0], -1)[:, None] \
            .astype(np.int32)
        tt = np.argmax(tl[:, 0].numpy(), -1)[:, None].astype(np.int32)
        jgen.append(jt)
        tgen.append(tt)
    np.testing.assert_array_equal(np.concatenate(tgen, 1),
                                  np.concatenate(jgen, 1))


@pytest.mark.parametrize("local_slice", [False, True])
def test_decode_past_a_local_window_matches_jax(local_slice):
    """The reduced gemma2 with a local window of 4 (``window_pattern=(4,
    0)``), with and without ``local_decode_slice``: 14 decode steps of a
    batch of 2 into a 16-row cache, so the local layers decode 10
    positions past their window; logits within LOGIT_TOL of the JAX
    model's at every step."""
    jcfg, tcfg = cfgs("gemma2-9b", window_pattern=(4, 0),
                      local_decode_slice=local_slice)
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    assert [layer.kind for layer in tm.layers][:2] == \
        ["attn_local", "attn_global"]
    toks = np.random.default_rng(14).integers(0, tcfg.vocab_size, (2, 14)) \
        .astype(np.int32)
    jdec = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    for pos in range(14):
        jl, jc = jdec(params, jnp.asarray(toks[:, pos:pos + 1]), jc, pos)
        tl, tc = tm.decode_step(t(toks[:, pos:pos + 1]), tc, pos)
        close(tl, jl, LOGIT_TOL)


def test_embeds_path_matches_jax():
    """The VLM stub path: embeddings in, M-RoPE positions given."""
    jm, params, tm, cfg = models("qwen2-vl-2b")
    rng = np.random.default_rng(13)
    emb = rng.normal(0, .02, (2, 9, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 30, (2, 3, 9)).astype(np.int32)
    jl, _ = jm.forward(params, embeds=jnp.asarray(emb),
                       positions=jnp.asarray(pos))
    with torch.no_grad():
        tl, _ = tm(embeds=t(emb), positions=t(pos))
    close(tl, jl, LOGIT_TOL)


def test_params_from_numpy_carries_every_leaf():
    jm, params, tm, cfg = models("gemma2-9b")
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    np.testing.assert_array_equal(
        tm.layers[3]["attn"]["wq"].detach().numpy(),
        np.asarray(params["stack"][1]["attn"]["wq"][1]))
    assert [layer.kind for layer in tm.layers] == \
        ["attn_local", "attn_global"] * 2


# ------------------------------------------------------------- build_model
def test_build_model_keeps_jax_shapes_and_scales():
    """A distributional contract, not JAX's threefry bits: the same tree
    and shapes as the JAX package's init, each weight's sample std within
    10% of its scale, norms zeros, and the same generator seed giving the
    same weights."""
    jcfg, cfg = cfgs("granite-20b")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(3)
    m = build_model(cfg, device="cpu", generator=gen)
    ref = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    got = dict(m.named_parameters())
    want = dict(ref.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.shape == want[name].shape and p.dtype == torch.float32
        if "norm" in name:
            assert not p.detach().any(), name
            continue
        fan_in = p.shape[0]
        scale = 0.02 if name.startswith(("embed", "pos")) else \
            fan_in ** -0.5
        assert abs(float(p.detach().std()) / scale - 1) < 0.1, name
    again = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "olmoe-1b-7b",
                                  "zamba2-2.7b", "rwkv6-1.6b",
                                  "whisper-large-v3"])
def test_families_not_ported_raise(arch):
    cfg = reduce_for_smoke(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 6"):
        build_model(cfg, device="cpu")


def test_build_model_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(reduce_for_smoke(get_config("yi-6b")))
