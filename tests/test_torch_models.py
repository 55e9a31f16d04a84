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

The five attention-only configs and the two MoE configs (olmoe-1b-7b:
GQA and experts; deepseek-v2-lite-16b: MLA, experts with shared ones and
a dense MLA prefix layer), reduced (``reduce_for_smoke``), with the JAX
package's parameters carried across by ``params_from_numpy``: ``forward``
logits and per-block stats, 8 ``decode_step``s and greedy tokens.
Tolerance: 1e-4 absolute on logits (float32); tokens equal. For the MoE
configs the routing comes first and must be identical: each unit's
``expert_load`` and ``drop_fraction`` bit for bit, the prefix's stats
present as in JAX; then ``aux_loss`` within 1e-5 relative. Decode
against the teacher-forced forward at capacity factor 16.0 (no token
drops), as ``tests/test_arch_smoke.py`` holds the JAX package: within
2e-2, and each decode step within 1e-4 of the JAX package's.

The recurrent configs (zamba2-2.7b: mamba2 with one shared attention
block; rwkv6-1.6b, and rwkv6 in its H1 factorized form at subchunk 8),
reduced, with every leaf of the JAX package's tree redrawn
(``make_torch_port_golden.redraw_params``) and carried across:
``forward`` logits and the whole stats tree within SSM_REL = 1e-5 x
max|value| (measured at most 3.7e-6: XLA's CPU cumsum is not
sequential), each decode step's logits within 1e-5 relative of the JAX
package's (measured at most 3.6e-6), the port's decode against its own
forward over 12 tokens from a fresh one-row cache (16 for H1, whose
chunk must divide by its subchunk) within ``test_arch_smoke.py``'s 2e-2,
greedy tokens equal; zamba2's shared block one module at its 2
positions, its gradient the sum of its uses'; fresh weights in the JAX
package's tree, the shared block drawn once. In bf16 activations: the
logits within BF16_SSM_LOGIT_REL (twice the measured gap, which is as
large as each package's own bf16 error against its float32 logits),
and the port's decode-versus-forward gap over 40 tokens at most twice
the JAX package's own.
"""
import copy
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

ARCHS = ("yi-6b", "gemma2-9b", "granite-20b", "minitron-4b", "qwen2-vl-2b")
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
SSM_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")
# name -> (arch, config overrides): the golden file's three models
SSM_MODELS = {name: (arch, dict(rwkv_factorized=True,
                                rwkv_subchunk=golden.SSM_SUBCHUNK)
                     if factorized else {})
              for name, (arch, factorized) in golden.SSM_MODELS.items()}
SSM_REL = 1e-5
# bf16 activations: the port's logits against the JAX package's over
# max |logit|, twice the measured 5.0e-2 (zamba2) and 7.9e-2 (rwkv6, and
# H1); each package's own bf16 logits differ from its float32 ones by as
# much (JAX 5.4e-2 and 1.4e-1, the port 5.0e-2 and 6.1e-2).
BF16_SSM_LOGIT_REL = {"zamba2-2.7b": 1e-1, "rwkv6-1.6b": 1.6e-1,
                      "rwkv6-1.6b-factorized": 1.6e-1}
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


def models(arch, **kw):
    """(JAX model, its params, the port's model from them, port config)."""
    key = (arch,) + tuple(sorted(kw.items()))
    if key not in _MODELS:
        jcfg, tcfg = cfgs(arch, **kw)
        jm = jbuild_model(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
        _MODELS[key] = (jm, params, tm, tcfg)
    return _MODELS[key]


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + SSM_ARCHS)
def test_stage_kinds_match_jax(arch):
    jcfg, tcfg = cfgs(arch)
    assert blocks.stage_unit_kinds(tcfg) == jblocks.stage_unit_kinds(jcfg)
    full = get_config(arch)
    assert blocks.stage_unit_kinds(full) == \
        jblocks.stage_unit_kinds(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_stats_tree_matches_jax(arch):
    """The whole stats tree of a forward over 2 x 48 tokens (capacity 13
    of 12 expected a sequence: some assignments drop): the same keys and
    shapes (deepseek's ``prefix0`` holds only absmax and rms; the stack's
    expert load is [n_units, E]), the routing bit for bit, the rest
    within LOGIT_TOL, and ``_collect_aux_loss`` within 1e-5 relative."""
    from repro.models.causal_lm import _collect_aux_loss as jcollect
    from repro_torch.models.causal_lm import _collect_aux_loss as tcollect

    jm, params, tm, cfg = models(arch)
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 48)) \
        .astype(np.int32)
    _, jst = jm.forward(params, tokens=jnp.asarray(toks))
    with torch.no_grad():
        _, tst = tm(t(toks))
    assert list(tst) == list(jst)
    assert ("prefix0" in tst) == (arch == "deepseek-v2-lite-16b")
    for name in tst:
        if name == "stack":
            assert len(tst[name]) == len(jst[name]) == 1
            got, want = tst[name][0], jst[name][0]
        else:
            got, want = tst[name], jst[name]
            assert set(got) == {"absmax", "rms"}
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            if k in ("expert_load", "drop_fraction"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]), k)
            elif k == "aux_loss":
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-5)
            else:
                close(got[k], want[k], LOGIT_TOL)
    load = tst["stack"][0]["expert_load"]
    assert load.shape == (2, cfg.moe_experts)
    assert float(tst["stack"][0]["drop_fraction"].max()) > 0.0
    np.testing.assert_allclose(float(tcollect(tst)), float(jcollect(jst)),
                               rtol=1e-5)
    assert float(tcollect(tst)) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward_and_jax(arch):
    """At capacity factor 16.0 nothing drops, so the one-token decode path
    must reproduce the teacher-forced forward (``test_arch_smoke.py``'s
    tolerance, 2e-2); each decode step's logits also within LOGIT_TOL of
    the JAX package's decode."""
    jm, params, tm, cfg = models(arch, capacity_factor=16.0)
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (1, 8)) \
        .astype(np.int32)
    with torch.no_grad():
        fwd, _ = tm(t(toks))
    jdec = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(1, 8), tm.init_cache(1, 8)
    if cfg.use_mla:
        assert set(tc[0]) == {"ckv", "kr"} and set(tc[-1]) == {"ckv", "kr"}
        assert tc[0]["ckv"].shape == (1, 8, cfg.kv_lora_rank)
    else:
        assert set(tc[0]) == {"k", "v"}
    outs = []
    for pos in range(8):
        jl, jc = jdec(params, jnp.asarray(toks[:, pos:pos + 1]), jc, pos)
        tl, tc = tm.decode_step(t(toks[:, pos:pos + 1]), tc, pos)
        close(tl, jl, LOGIT_TOL)
        outs.append(tl[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               rtol=2e-2, atol=2e-2)


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


def test_params_from_numpy_carries_prefix_and_stacked_experts():
    """deepseek's unstacked dense prefix becomes layer 0, the stacked MoE
    leaves ([n_units, E, ...]) one slice per layer."""
    jm, params, tm, cfg = models("deepseek-v2-lite-16b")
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert [layer.kind for layer in tm.layers] == ["mla", "mla_moe",
                                                   "mla_moe"]
    np.testing.assert_array_equal(
        tm.layers[0]["mlp"]["w_in"].detach().numpy(),
        np.asarray(params["prefix"][0]["mlp"]["w_in"]))
    np.testing.assert_array_equal(
        tm.layers[2]["moe"]["w_out"].detach().numpy(),
        np.asarray(params["stack"][0]["moe"]["w_out"][1]))
    np.testing.assert_array_equal(
        tm.layers[1]["moe"]["shared"]["w_gate"].detach().numpy(),
        np.asarray(params["stack"][0]["moe"]["shared"]["w_gate"][0]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_build_model_moe_keeps_jax_tree(arch):
    """Fresh weights of a MoE config: the parameter names and shapes of
    the JAX package's init carried across, float32."""
    jm, params, ref, cfg = models(arch)
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(4))
    want = {k: tuple(v.shape) for k, v in ref.named_parameters()}
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == want
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_build_model_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(reduce_for_smoke(get_config("yi-6b")))


# ------------------------------------------------------------- recurrent
_SSM = {}


def ssm_models(name, dtype="float32"):
    """(JAX model, redrawn params as JAX arrays, the port's model from
    them, port config) of a reduced recurrent config in ``dtype``
    activations."""
    if (name, dtype) not in _SSM:
        arch, kw = SSM_MODELS[name]
        jcfg, tcfg = cfgs(arch, dtype=dtype, **kw)
        jm = jbuild_model(jcfg)
        params = golden.redraw_params(
            jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), 31)
        tm = params_from_numpy(tcfg, params, device="cpu")
        _SSM[name, dtype] = (jm, jax.tree.map(jnp.asarray, params), tm,
                             tcfg)
    return _SSM[name, dtype]


def close_rel(got, want, rel=SSM_REL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_forward_and_stats_match_jax(name):
    """2 x 40 tokens (padded to a chunk multiple in every mamba2 layer):
    the logits, and every unit kind's absmax and rms stacked over units,
    as the JAX scan returns them."""
    jm, params, tm, cfg = ssm_models(name)
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 40)) \
        .astype(np.int32)
    jl, jst = jm.forward(params, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tl, tst = tm(t(toks))
    close_rel(tl, jl)
    assert list(tst) == list(jst) == ["stack"]
    assert len(tst["stack"]) == len(jst["stack"]) == len(tm.unit_kinds)
    for ts, js in zip(tst["stack"], jst["stack"]):
        assert sorted(ts) == sorted(js) == ["absmax", "rms"]
        for k in ts:
            assert tuple(ts[k].shape) == js[k].shape == (tm.n_units,)
            close_rel(ts[k], js[k])


def decode_len(cfg):
    """12 tokens, as ``test_arch_smoke.py``; 16 for H1, whose one chunk
    must divide by its subchunk."""
    return 16 if cfg.rwkv_factorized else 12


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_decode_matches_jax_and_own_forward(name):
    """A fresh one-row cache fed the tokens one by one: each step's logits
    within SSM_REL of the JAX package's decode, and all of them within
    2e-2 of the port's own teacher-forced forward."""
    jm, params, tm, cfg = ssm_models(name)
    n = decode_len(cfg)
    toks = np.random.default_rng(18).integers(0, cfg.vocab_size, (1, n)) \
        .astype(np.int32)
    with torch.no_grad():
        fwd, _ = tm(t(toks))
    jdec = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(1, n), tm.init_cache(1, n)
    want = {"mamba": {"ssm", "conv"}, "rwkv": {"wkv", "x_tm", "x_cm"},
            "attn": {"k", "v"}}
    for layer, c in zip(tm.layers, tc):
        assert set(c) == want[layer.kind]
    outs = []
    for pos in range(n):
        jl, jc = jdec(params, jnp.asarray(toks[:, pos:pos + 1]), jc, pos)
        tl, tc2 = tm.decode_step(t(toks[:, pos:pos + 1]), tc, pos)
        assert all(a[k] is b[k] for a, b in zip(tc2, tc) for k in b)
        tc = tc2                                          # in place
        close_rel(tl, jl)
        outs.append(tl[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_greedy_tokens_match_jax(name):
    """A batch of 2: 8 prompt steps, then 6 greedy tokens from each
    package's own argmax, equal token for token."""
    jm, params, tm, cfg = ssm_models(name)
    toks = np.random.default_rng(19).integers(0, cfg.vocab_size, (2, 8)) \
        .astype(np.int32)
    jdec = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    for pos in range(8):
        jl, jc = jdec(params, jnp.asarray(toks[:, pos:pos + 1]), jc, pos)
        tl, tc = tm.decode_step(t(toks[:, pos:pos + 1]), tc, pos)
    jt = tt = toks[:, -1:]
    jgen, tgen = [], []
    for pos in range(8, 14):
        jt = np.argmax(np.asarray(jl, np.float32)[:, 0], -1)[:, None] \
            .astype(np.int32)
        tt = np.argmax(tl[:, 0].numpy(), -1)[:, None].astype(np.int32)
        jgen.append(jt)
        tgen.append(tt)
        jl, jc = jdec(params, jnp.asarray(jt), jc, pos)
        tl, tc = tm.decode_step(t(tt), tc, pos)
    np.testing.assert_array_equal(np.concatenate(tgen, 1),
                                  np.concatenate(jgen, 1))


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_bf16_forward_within_measured_bound(name):
    """bf16 activations, 2 x 40 tokens: the port's logits within
    BF16_SSM_LOGIT_REL of the JAX package's, relative to max |logit|."""
    jm, params, tm, cfg = ssm_models(name, "bfloat16")
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 40)) \
        .astype(np.int32)
    jl, _ = jm.forward(params, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = tm(t(toks))
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    jl = np.asarray(jl)
    err = float(np.abs(tl.float().numpy() - jl).max())
    assert err <= BF16_SSM_LOGIT_REL[name] * float(np.abs(jl).max()), err


def bf16_decode_gap(dec, fwd, init_cache, toks):
    """max |decode - forward| over max |forward|: a fresh one-row cache
    fed ``toks`` one by one against the forward over all of them."""
    f = np.asarray(fwd(toks), np.float32)
    cache, outs = init_cache(toks.shape[1]), []
    for pos in range(toks.shape[1]):
        logits, cache = dec(toks[:, pos:pos + 1], cache, pos)
        outs.append(np.asarray(logits, np.float32)[:, 0])
    return float(np.abs(np.stack(outs, 1) - f).max() / np.abs(f).max())


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_bf16_decode_vs_forward_gap_as_jax(name):
    """bf16 activations, 40 tokens (two chunks at zamba2's reduced chunk
    of 32): each package's decode against its own forward. The port's gap
    is at most twice the JAX package's; both are printed (run with -s).
    Measured: zamba2 2.5e-2 against JAX's 2.6e-2, rwkv6 5.7e-3 against
    3.8e-3, H1 5.7e-3 against 6.9e-3."""
    jm, params, tm, cfg = ssm_models(name, "bfloat16")
    toks = np.random.default_rng(18).integers(0, cfg.vocab_size, (1, 40)) \
        .astype(np.int32)
    jdec = jax.jit(jm.decode_step)

    def jstep(x, cache, pos):
        logits, cache = jdec(params, jnp.asarray(x), cache, pos)
        return logits.astype(jnp.float32), cache

    def tstep(x, cache, pos):
        logits, cache = tm.decode_step(t(x), cache, pos)
        return logits.float(), cache

    jgap = bf16_decode_gap(
        jstep, lambda x: jm.forward(params, tokens=jnp.asarray(x))[0]
        .astype(jnp.float32), lambda n: jm.init_cache(1, n), toks)
    with torch.no_grad():
        tgap = bf16_decode_gap(tstep, lambda x: tm(t(x))[0].float(),
                               lambda n: tm.init_cache(1, n), toks)
    print(f"{name}: bf16 decode vs forward over 40 tokens, max |difference|"
          f" / max |logit|: the JAX package {jgap:.3e}, the port {tgap:.3e}")
    assert 0.0 < tgap <= 2.0 * jgap, (tgap, jgap)


def test_shared_block_is_one_module_with_the_summed_gradient():
    """zamba2's attention positions hold the ``shared_block`` module
    itself; ``named_parameters`` lists it once, under the JAX key; its
    gradient equals the sum of the gradients of untied copies, one per
    use."""
    jm, params, tm, cfg = ssm_models("zamba2-2.7b")
    shared = [i for i, layer in enumerate(tm.layers)
              if layer is tm.shared_block]
    assert shared == [0, 6] and tm.layers[0].kind == "attn"
    names = [n for n, _ in tm.named_parameters()]
    assert any(n.startswith("shared_block.attn.") for n in names)
    assert not any(n.startswith(("layers.0.", "layers.6.")) for n in names)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert params["stack"][0] == {}

    tied = copy.deepcopy(tm)
    untied = copy.deepcopy(tm)
    for i in shared:
        untied.layers[i] = copy.deepcopy(tm.shared_block)
    rng = np.random.default_rng(20)
    batch = {"tokens": t(rng.integers(0, cfg.vocab_size, (2, 16))
                         .astype(np.int32)),
             "targets": t(rng.integers(0, cfg.vocab_size, (2, 16))
                          .astype(np.int32))}
    for m in (tied, untied):
        m.loss(batch)[0].backward()
    for name, p in tied.shared_block.named_parameters():
        want = sum(dict(untied.layers[i].named_parameters())[name].grad
                   for i in shared)
        assert float(p.grad.abs().max()) > 0.0, name
        torch.testing.assert_close(p.grad, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_build_model_recurrent_keeps_jax_tree(arch):
    """Fresh weights: the parameter names and shapes of the JAX package's
    init carried across, float32, the initialiser's constants as JAX sets
    them, and zamba2's shared block drawn once."""
    jcfg, cfg = cfgs(arch)
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    ref = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(6))
    want = {k: tuple(v.shape) for k, v in ref.named_parameters()}
    got = dict(m.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(p.dtype == torch.float32 for p in got.values())
    consts = {"A_log": 0.0, "D": 1.0, "dt_bias": 0.0, "norm_scale": 0.0,
              "mix_r": 0.5, "mix_k": 0.5, "mix_v": 0.5, "mix_w": 0.5,
              "mix_g": 0.5, "cmix_k": 0.5, "w0": -2.0, "ln_scale": 0.0}
    for name, p in got.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in consts:
            assert bool((p == consts[leaf]).all()), name
    if cfg.shared_attention:
        assert m.layers[0] is m.layers[6] is m.shared_block
