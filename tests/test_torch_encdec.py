"""The port's encoder-decoder (``repro_torch.models.encdec.EncDecLM``, the
blocks' ``enc_attn`` / ``dec_cross`` kinds, the ``encdec_memory`` serve
step, the clip's and the monitors' groups, the launcher's frames batch)
against the JAX package's, on the CPU.

Every case runs the reduced whisper-large-v3 (``reduce_for_smoke``: 2 + 2
layers, d_model 128, 4 heads of 32, d_ff 256, vocab 512, 64 frames) at
``attn_chunk`` CHUNK = 16, below the frame count, so that the encoder's
and the cross-attention's online softmax crosses chunks. Every leaf of
the JAX tree is redrawn first (``make_torch_port_golden.redraw_params``):
the initialiser's zero norms would hide ordering bugs. The same numpy
inputs go through both packages, in float32 unless stated.

Contracts and tolerances:

* ``enc_attn`` and ``dec_cross`` through ``block_apply`` (40 frames: two
  whole chunks and a padded one) and ``block_decode`` (4 steps, the cache
  too): within BLOCK_REL = 1e-5 x max|out|. The encoder's layers have no
  decode step in either package.
* ``encode``, ``forward`` (logits and the decoder's stats, the only stats
  either package returns) within BLOCK_REL x max|value|; ``loss`` within
  LOSS_REL = 1e-6 relative.
* 12 decode steps through ``make_serve_step(model, encdec_memory=True)``
  against the JAX package's: logits within DECODE_TOL = 1e-5 absolute,
  greedy tokens equal; the port's decode against its own ``forward``
  within 1e-5 x max|logit|.
* Parameters and a JAX-made ``TrainState`` carried to the port and back
  bit for bit, and a port checkpoint restored by the JAX package with an
  equal manifest.
* The quantile clip's six groups (the JAX tree's sorted top-level keys);
  the monitors' ``dec_layers`` groups, as the JAX package's
  ``eval_shape`` counts them, also where ``num_layers`` differs.
* ``create_train_state`` equal to the JAX package's (key words, clip and
  fleet planes, cursors); step-1 gradients within GRAD_TOL = 1e-4 x
  max|g|; STEPS train steps with each loss within STEP_REL = 1e-5 and
  grad norm within STEP_REL relative, the clip's and both activation
  fleets' sign planes and the fleets' cursors bit for bit, m and step
  within STATS_REL = 1e-5 x |m| a lane.
* In bf16 activations the logits within BF16_REL x max|logit| of the JAX
  package's (twice the measured gap, stated where it is checked).
* The port's ``ServeEngine`` refuses an ``EncDecLM`` (ValueError), where
  the JAX engine fails at its first decode call (TypeError: no memory).
* ``launch.train --arch whisper-large-v3 --device cpu`` trains, dies at
  ``--die-at-step`` (a subprocess) and resumes from its checkpoint (its
  ``main`` in this process).
* ``sinusoidal_pos`` equal to the JAX package's within BLOCK_REL x max,
  at offset 0 and past it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild_model
from repro.models.layers import embedding as jemb
from repro.monitor import registry as jmon
from repro.optim import Optimizer as JOptimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro.train import create_train_state as jcreate_train_state
from repro.train import make_serve_step as jmake_serve_step
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import rng as trng
from repro_torch.models import EncDecLM, build_model, params_from_numpy
from repro_torch.models import blocks
from repro_torch.models.convert import (flat_from_tree,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.layers import embedding as temb
from repro_torch.monitor import registry as tmon
from repro_torch.optim import Optimizer, warmup_cosine
from repro_torch.serve import ServeEngine
from repro_torch.train import (create_train_state, make_serve_step,
                               make_train_step)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.train_state import clip_blocks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH = "whisper-large-v3"
CHUNK = 16
SEED = 41                     # numpy seed of the redrawn weights
BLOCK_REL = 1e-5
LOSS_REL = 1e-6
DECODE_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_REL = STATS_REL = 1e-5
STEPS = 3
LR = (1e-3, 10, 30)
# bf16 activations: the port's logits against the JAX package's over
# max |logit|, twice the largest measured over four input seeds (1.0e-2;
# 8.7e-3 at the seed checked); each package's own bf16 logits differ
# from its float32 ones by as much (7e-3 to 1.0e-2).
BF16_REL = 2e-2
TOP = ("dec_norm", "dec_pos", "dec_stack", "embed", "enc_norm",
       "enc_stack")


def cfgs(**kw):
    """(JAX config, port config): the reduced whisper at CHUNK."""
    kw = dict(attn_chunk=CHUNK, **kw)
    return (dataclasses.replace(jreduce(jget_config(ARCH)), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **kw))


def t(x):
    return torch.from_numpy(np.array(x))


def tree_t(node):
    if isinstance(node, dict):
        return {k: tree_t(v) for k, v in node.items()}
    return t(node)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def bits(x):
    return np.asarray(host(x), np.float32).view(np.int32)


def close_rel(got, want, rel=BLOCK_REL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(host(got).astype(np.float32) - want).max())
    assert err <= rel * float(np.abs(want).max()), err
    return err


def inputs(cfg, seed, b=2, s=10, frames=None):
    """(frames [b, S_enc, D] float32, tokens, targets [b, s] int32)."""
    rng = np.random.default_rng(seed)
    fr = rng.normal(0, 1, (b, frames or cfg.enc_seq_len, cfg.d_model))
    tok, tgt = (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
                for _ in range(2))
    return fr.astype(np.float32), tok, tgt


_M = {}


def models(dtype="float32"):
    """(JAX model, redrawn params as JAX arrays, port model, port cfg).
    The parameters are float32 whatever ``dtype`` (the activations') is,
    so every dtype shares one redrawn tree."""
    if dtype not in _M:
        jcfg, tcfg = cfgs(dtype=dtype)
        jm = jbuild_model(jcfg)
        if "tree" not in _M:
            _M["tree"] = golden.redraw_params(jax.tree.map(
                np.asarray, jm.init(jax.random.PRNGKey(0))), SEED)
        params = _M["tree"]
        tm = params_from_numpy(tcfg, params, device="cpu")
        _M[dtype] = (jm, jax.tree.map(jnp.asarray, params), tm, tcfg)
    return _M[dtype]


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("kind", ["enc_attn", "dec_cross"])
def test_block_apply_and_decode_match_jax(kind):
    jcfg, tcfg = cfgs()
    p = golden.redraw_params(jax.tree.map(np.asarray, jblocks.block_init(
        jax.random.PRNGKey(3), jcfg, kind)), 5)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_t(p)
    assert sorted(p) == sorted(blocks.block_init(
        torch.Generator().manual_seed(0), tcfg, kind))
    rng = np.random.default_rng(7)
    mem = rng.normal(0, 1, (2, 40, tcfg.d_model)).astype(np.float32)
    x = mem if kind == "enc_attn" else \
        rng.normal(0, 1, (2, 9, tcfg.d_model)).astype(np.float32)
    jm_ = None if kind == "enc_attn" else jnp.asarray(mem)
    tm_ = None if kind == "enc_attn" else t(mem)
    jy, jst = jax.jit(lambda p_, x_, m_: jblocks.block_apply(
        p_, x_, jcfg, kind, memory=m_))(jp, jnp.asarray(x), jm_)
    ty, tst = blocks.block_apply(tp, t(x), tcfg, kind, memory=tm_)
    close_rel(ty, jy)
    for k in ("absmax", "rms"):
        close_rel(tst[k], jst[k])
    if kind == "enc_attn":
        with pytest.raises(ValueError):
            jblocks.block_cache_init(jcfg, kind, 2, 8, jnp.float32)
        with pytest.raises(ValueError):
            blocks.block_cache_init(tcfg, kind, 2, 8, torch.float32)
        with pytest.raises(ValueError):
            blocks.block_decode(tp, t(x[:, :1]), {}, 0, tcfg, kind)
        return
    jc = jblocks.block_cache_init(jcfg, kind, 2, 8, jnp.float32)
    tc = blocks.block_cache_init(tcfg, kind, 2, 8, torch.float32)
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    jdecode = jax.jit(lambda p_, x_, c_, pos_, m_: jblocks.block_decode(
        p_, x_, c_, pos_, jcfg, kind, memory=m_))
    for pos in range(4):
        xs = x[:, pos:pos + 1]
        jy, jc, _ = jdecode(jp, jnp.asarray(xs), jc, pos, jm_)
        ty, tc, _ = blocks.block_decode(tp, t(xs), tc, pos, tcfg, kind,
                                        memory=tm_)
        close_rel(ty, jy)
        for k in ("k", "v"):
            close_rel(tc[k], jc[k])


@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoidal_pos_matches_jax(offset):
    close_rel(temb.sinusoidal_pos(9, 24, offset, torch.float32),
              jemb.sinusoidal_pos(9, 24, offset, jnp.float32))


# ------------------------------------------------------------------- model
def test_encode_forward_loss_match_jax():
    jm, params, tm, cfg = models()
    fr, tok, tgt = inputs(cfg, 11)
    jmem = jax.jit(jm.encode)(params, jnp.asarray(fr))
    jl, jst = jax.jit(jm.forward)(params, jnp.asarray(fr), jnp.asarray(tok))
    jloss, jaux = jax.jit(jm.loss)(params, {"frames": jnp.asarray(fr),
                                            "tokens": jnp.asarray(tok),
                                            "targets": jnp.asarray(tgt)})
    with torch.no_grad():
        close_rel(tm.encode(t(fr)), jmem)
        tl, tst = tm(t(fr), t(tok))
        tloss, taux = tm.loss({"frames": t(fr), "tokens": t(tok),
                               "targets": t(tgt)})
    close_rel(tl, jl)
    assert sorted(tst) == sorted(jst) == ["stack"]
    assert sorted(tst["stack"]) == sorted(jst["stack"]) == ["absmax", "rms"]
    for k in ("absmax", "rms"):
        assert tst["stack"][k].shape == (cfg.dec_layers,)
        close_rel(tst["stack"][k], jst["stack"][k])
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_REL)
    assert float(taux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0
    assert taux["stats"]["stack"]["rms"].requires_grad is False


def test_serve_steps_and_greedy_tokens_match_jax():
    """12 calls of each package's ``encdec_memory`` serve step, each
    feeding its own greedy token; then the port's decode against its own
    forward over the tokens it fed."""
    jm, params, tm, cfg = models()
    fr, tok, _ = inputs(cfg, 13, s=1)
    jserve = jax.jit(jmake_serve_step(jm, encdec_memory=True))
    tserve = make_serve_step(tm, encdec_memory=True)
    jmem = jax.jit(jm.encode)(params, jnp.asarray(fr))
    with torch.no_grad():
        tmem = tm.encode(t(fr))
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    assert len(tc) == cfg.dec_layers and sorted(tc[0]) == ["k", "v"]
    assert tc[0]["k"].shape == jc["k"].shape[1:]
    jt, tt, fed, rows = jnp.asarray(tok), t(tok), [t(tok)], []
    for pos in range(12):
        jl, jc = jserve(params, jt, jc, pos, jmem)
        tl, tc = tserve(tt, tc, pos, tmem)
        np.testing.assert_allclose(host(tl), np.asarray(jl), rtol=0,
                                   atol=DECODE_TOL)
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(host(tt), np.asarray(jt))
        fed.append(tt)
        rows.append(tl[:, 0])
    with torch.no_grad():
        fwd, _ = tm(t(fr), torch.cat(fed[:-1], 1))
    close_rel(torch.stack(rows, 1), fwd)


# ----------------------------------------------------------------- convert
_RUN = {}


def jax_run():
    """The JAX package's initial TrainState with the redrawn parameters,
    the batch, STEPS jitted train steps' metrics and states (numpy)."""
    if "run" in _RUN:
        return _RUN["run"]
    jm, params, _, cfg = models()
    fr, tok, tgt = inputs(cfg, 17, s=16)
    batch = {"frames": fr, "tokens": tok, "targets": tgt}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = JOptimizer(kind="adamw", lr_fn=jwarmup_cosine(*LR))
    state = jcreate_train_state(jm, opt, jax.random.PRNGKey(0),
                                example_batch=jb)
    state = state._replace(params=params)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jmake_train_step(jm, opt))
    metrics, states = [], []
    for _ in range(STEPS):
        state, met = step(state, jb)
        metrics.append({k: float(v) for k, v in met.items()})
        states.append(jax.tree.map(np.asarray, state))
    _RUN["run"] = (jm, cfg, init, batch, metrics, states)
    return _RUN["run"]


def test_params_carry_every_leaf_both_ways():
    jm, params, tm, cfg = models()
    leaves = jax.tree.leaves(params)
    assert sum(p.numel() for p in tm.parameters()) == \
        sum(x.size for x in leaves)
    assert [len(tm.enc_stack), len(tm.dec_stack)] == [2, 2]
    np.testing.assert_array_equal(
        host(tm.dec_stack[1]["cross"]["wk"]),
        np.asarray(params["dec_stack"]["cross"]["wk"][1]))
    np.testing.assert_array_equal(
        host(tm.enc_stack[0]["mlp"]["w_in"]),
        np.asarray(params["enc_stack"]["mlp"]["w_in"][0]))
    flat = flat_from_tree(cfg, jax.tree.map(np.asarray, params))
    assert sorted(flat) == sorted(n for n, _ in tm.named_parameters())
    back = train_state_to_numpy(create_train_state(
        tm, Optimizer(kind="adamw", lr_fn=warmup_cosine(*LR)),
        trng.prng_key(0))).params
    assert sorted(back) == list(TOP)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(g, np.asarray(w), str(path))


def manifest(d, step):
    with open(os.path.join(str(d), f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    return m["num_leaves"], m["shapes"], m["dtypes"], m["crc32"]


def test_train_state_crosses_both_ways(tmp_path):
    """The JAX state after the steps -> the port's -> the JAX layout, leaf
    for leaf bit for bit (``enc_stack`` / ``dec_stack`` stacked on their
    leading layer axis again); a port checkpoint restored by the JAX
    package and written again with an equal manifest."""
    jm, cfg, init, _, _, states = jax_run()
    st = train_state_from_numpy(cfg, states[-1], device="cpu")
    assert isinstance(st.params, EncDecLM) and st.step == STEPS
    back = train_state_to_numpy(st)
    for tree in (back.params, back.opt_state.mu, back.opt_state.nu):
        assert sorted(tree) == list(TOP)
        assert tree["enc_stack"]["attn"]["wq"].shape[0] == cfg.enc_layers
    got = tckpt._flatten(tckpt._pack_sketches(back))
    want = jax.tree_util.tree_leaves(jckpt._pack_sketches(states[-1]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))
    tckpt.save_train_state(str(tmp_path / "port"), STEPS, st)
    restored, _ = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                           jax.tree.map(jnp.asarray, init))
    jckpt.save_checkpoint(str(tmp_path / "jax"), STEPS, restored)
    assert manifest(tmp_path / "jax", STEPS) == \
        manifest(tmp_path / "port", STEPS)


# ------------------------------------------------------- clip and monitors
def test_clip_blocks_are_the_six_sorted_keys():
    jm, params, tm, cfg = models()
    keys, names = clip_blocks(tm)
    assert keys == tuple(sorted(params)) == TOP
    assert sum(len(v) for v in names.values()) == \
        len(list(tm.parameters()))
    assert all(n.startswith(k + ".") for k in keys for n in names[k])
    st = create_train_state(tm, Optimizer(kind="adamw",
                                          lr_fn=warmup_cosine(*LR)),
                            trng.prng_key(0))
    assert st.qclip.sketch.m.shape == (6,)


@pytest.mark.parametrize("over", [{}, {"num_layers": 5}, {"dec_layers": 3}],
                         ids=["reduced", "num_layers-5", "dec_layers-3"])
def test_monitors_count_decoder_layers(over):
    """One activation group per decoder layer, as the JAX package's
    ``eval_shape`` of the loss counts them, whatever ``num_layers``
    says."""
    jcfg, tcfg = cfgs(**over)
    jm = jbuild_model(jcfg)
    fr, tok, tgt = inputs(tcfg, 19, s=4, frames=8)
    jb = {"frames": jnp.asarray(fr), "tokens": jnp.asarray(tok),
          "targets": jnp.asarray(tgt)}
    jmons = jmon.init_train_monitors(
        jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), jb)
    assert tmon.group_counts(tcfg) == (int(jmons.n_act_groups),
                                       int(jmons.n_moe_groups)) \
        == (tcfg.dec_layers, 0)
    tm = build_model(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    mons = tmon.init_train_monitors(tm)
    assert mons.act_absmax_q99.state.m.shape == (tcfg.dec_layers,)
    assert mons.expert_load_q99 is None
    _, aux = tm.loss({k: t(v) for k, v in (("frames", fr), ("tokens", tok),
                                           ("targets", tgt))})
    a, r, loads = tmon._flatten_stats(aux["stats"])
    assert a.shape == r.shape == (tcfg.dec_layers,) and loads is None
    if not over:
        assert tmon.group_counts(get_config(ARCH)) == (32, 0)


# --------------------------------------------------------------- training
def test_create_train_state_matches_jax():
    jm, cfg, init, batch, _, _ = jax_run()
    _, _, tm, _ = models()
    st = create_train_state(tm, Optimizer(kind="adamw",
                                          lr_fn=warmup_cosine(*LR)),
                            trng.prng_key(0), example_batch=batch)
    np.testing.assert_array_equal(st.rng, init.rng)
    assert st.step == int(init.step) == 0
    for f in ("m", "step", "sign"):
        np.testing.assert_array_equal(bits(getattr(st.qclip.sketch, f)),
                                      bits(getattr(init.qclip.sketch, f)))
    for name in ("act_absmax_q99", "act_rms_q50"):
        fl, jf = getattr(st.monitors, name), getattr(init.monitors, name)
        for f in ("m", "step", "sign"):
            np.testing.assert_array_equal(bits(getattr(fl.state, f)),
                                          bits(getattr(jf.state, f)))
        assert [int(x) for x in fl.cursor] == \
            [int(np.asarray(x)) for x in jf.cursor]
    assert all(not v.any() for v in st.opt_state.mu.values())


def test_train_steps_match_jax():
    jm, cfg, init, batch, metrics, states = jax_run()
    (_, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, init.params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flat_from_tree(cfg, jax.tree.map(np.asarray, jg))
    st = train_state_from_numpy(cfg, init, device="cpu")
    tb = {k: t(v) for k, v in batch.items()}
    loss, _ = st.params.loss(tb)
    loss.backward()
    for name, p in st.params.named_parameters():
        close_rel(p.grad, jgrads[name], GRAD_TOL)
    st.params.zero_grad(set_to_none=True)
    step = make_train_step(st.params, Optimizer(kind="adamw",
                                                lr_fn=warmup_cosine(*LR)))
    for i in range(STEPS):
        st, met = step(st, tb)
        for k in ("loss", "ce_loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(metrics[i][k],
                                                  rel=STEP_REL), (i, k)
        want = states[i]
        pairs = [(st.qclip.sketch, want.qclip.sketch)] + [
            (getattr(st.monitors, n).state, getattr(want.monitors, n).state)
            for n in ("act_absmax_q99", "act_rms_q50")]
        for got, ref in pairs:
            np.testing.assert_array_equal(bits(got.sign), bits(ref.sign))
            scale = np.abs(np.asarray(ref.m))
            for f in ("m", "step"):
                err = np.abs(host(getattr(got, f))
                             - np.asarray(getattr(ref, f)))
                assert (err <= STATS_REL * scale).all(), (i, f, err)
        for n in ("act_absmax_q99", "act_rms_q50"):
            assert [int(x) for x in getattr(st.monitors, n).cursor] == \
                [int(np.asarray(x)) for x in getattr(want.monitors,
                                                     n).cursor]
    assert st.qclip.warmup == int(states[-1].qclip.warmup) == STEPS


def test_bf16_forward_within_measured_bound():
    jm, params, tm, cfg = models("bfloat16")
    fr, tok, _ = inputs(cfg, 23)
    jl, _ = jax.jit(jm.forward)(params, jnp.asarray(fr), jnp.asarray(tok))
    with torch.no_grad():
        tl, _ = tm(t(fr), t(tok))
    assert tl.dtype == torch.float32
    close_rel(tl, jl, BF16_REL)


# -------------------------------------------------------------- entry points
def test_engine_refuses_encdec_where_jax_engine_fails():
    jm, params, tm, cfg = models()
    with pytest.raises(ValueError, match="encdec_memory=True"):
        ServeEngine(tm, device="cpu")
    eng = jengine.ServeEngine(jm, params, batch_slots=2, max_len=16)
    eng.submit(jengine.Request(rid=0, prompt=[1, 2], max_new_tokens=2))
    with pytest.raises(TypeError, match="memory"):
        eng.run_until_drained()
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(ValueError, match="encoder-decoder"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])


def test_build_model_keeps_jax_tree_and_needs_a_card_or_cpu(monkeypatch):
    """Fresh weights: the JAX package's init tree (names, shapes,
    float32), each matrix's sample std within 10% of its scale, norms
    zeros; without a card and without ``device="cpu"`` it raises."""
    jcfg, cfg = cfgs()
    ref = params_from_numpy(cfg, jax.tree.map(
        np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0))),
        device="cpu")
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(2))
    assert isinstance(m, EncDecLM)
    want = {k: tuple(v.shape) for k, v in ref.named_parameters()}
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == want
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32
        if "norm" in name:
            assert not p.detach().any(), name
            continue
        scale = 0.02 if name.startswith(("embed", "dec_pos")) else \
            p.shape[0] ** -0.5
        assert abs(float(p.detach().std()) / scale - 1) < 0.1, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(cfg)


def test_launcher_frames_are_keyed_by_the_first_token():
    from repro_torch.launch import train as launch_train

    b = {"tokens": torch.tensor([[7, 1], [2, 3]]), "targets":
         torch.zeros((2, 2), dtype=torch.int32)}
    a1, a2 = launch_train.with_frames([b, b], 2, 8, "cpu")
    c = next(launch_train.with_frames(
        [dict(b, tokens=b["tokens"] + 1)], 2, 8, "cpu"))
    assert a1["frames"].shape == (2, launch_train.ENC_FRAMES, 8)
    assert a1["frames"].dtype == torch.float32
    assert torch.equal(a1["frames"], a2["frames"])
    assert not torch.equal(a1["frames"], c["frames"])


def run_train(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu"] + args, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_launcher_trains_whisper_and_resumes(tmp_path, capsys):
    """Killed at step 2 (os._exit(42), so in a subprocess) with
    checkpoints every 2, then restarted in this process: resumes from 2
    and finishes 4."""
    from repro_torch.launch import train as launch_train

    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", ARCH, "--steps", "4", "--batch", "2", "--seq", "16",
              "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    r1 = run_train(common + ["--die-at-step", "2"])
    assert r1.returncode == 42, r1.stderr[-2000:]
    assert tckpt.latest_step(ckpt) == 2
    launch_train.main(["--device", "cpu"] + common)
    printed = capsys.readouterr()
    out = json.loads(printed.out.strip().splitlines()[-1])
    assert out["final_step"] == 4 and out["steps"] == 2
    assert out["arch"] == ARCH and np.isfinite(out["last_loss"])
    assert "resumed from step 2" in printed.out + printed.err
