"""The port's training path (``repro_torch.train``, ``monitor``,
``CausalLM.loss``, ``models.convert``'s train-state carry,
``launch.train``) against the JAX package's, on the CPU.

Contracts and tolerances:

* Loss and gradients, the five attention-only configs reduced
  (``reduce_for_smoke``: float32 activations), the JAX package's weights
  carried across: loss within LOSS_REL = 1e-5 relative, each gradient
  within GRAD_TOL = 1e-4 x max|g| of its JAX leaf. At bf16 activations:
  BF16_LOSS_REL = 5e-4 and BF16_GRAD_TOL = 8e-2 x max|g|, twice the
  worst measured on these five (1.3e-4 and 3.8e-2). ``onehot_xent`` and
  the mask path likewise.
* Bit-exact: the three monitor fleets' planes and cursors fed the JAX
  package's stats over 12 steps; ``StepTimeMonitor`` step for step;
  ``create_train_state``'s key words and clip lanes.
* Five whole ``train_step``s from a carried JAX ``TrainState`` at the
  reduced yi-6b: each loss and grad norm within STEP_REL = 1e-5 relative.
* A ``TrainState`` checkpoint crosses between the packages both ways with
  equal manifests (leaf count, shapes, dtypes) and equal CRC32s.
* The claims of ``tests/test_train_loop.py`` on the port alone (120
  steps), and the preemption restart of ``tests/test_fault_tolerance.py``
  as two subprocesses of ``repro_torch.launch.train --device cpu``.
* The MoE configs, reduced (olmoe-1b-7b; deepseek-v2-lite-16b with its
  MLA prefix): loss, aux loss and gradients as above (the aux loss now a
  real balance term); four ``train_step``s from the JAX package's
  initial ``TrainState`` on its batches, each loss within STEP_REL, the
  expert-load fleet (2 units x 8 experts = 16 lanes, as the JAX
  package's ``eval_shape`` counts them) bit for bit after every step; the
  state after them carried to the port and back bit for bit, and a port
  checkpoint of it restored by the JAX package with equal manifests.
  The full configs' group counts: 26 x 64 = 1664 (deepseek), 16 x 64 =
  1024 (olmoe).
* The recurrent configs, reduced (zamba2-2.7b with its shared attention
  block; rwkv6-1.6b, and its H1 factorized form at subchunk 8), every
  leaf of the JAX tree redrawn (``make_torch_port_golden.redraw_params``):
  loss within LOSS_REL and gradients within GRAD_TOL as above (zamba2's
  ``shared_block`` gradient the JAX package's, which sums its uses);
  SSM_STEPS = 4 ``train_step``s from the JAX package's initial
  ``TrainState`` on its batches, each loss within STEP_REL (measured
  1.5e-7) and grad norm within SSM_GNORM_REL = 1e-4 (measured 2.2e-5 at
  rwkv6: its gradients run through ``exp`` of cumsum differences, which
  XLA's CPU cumsum sums in another order); after every step both
  activation fleets' sign planes and cursors bit for bit, their m and
  step planes within STATS_REL = 1e-5 x |m| a lane (m measured at most
  8.4e-7 relative, on up to 17 of zamba2's 24 lanes: where the 2U tick
  sets m to the step's statistic x and moves step by x - m, and the
  chunked forward cannot compute x bit-identically; bit for bit
  elsewhere); fed the
  JAX package's own statistics of each step, the port's fleets equal
  the JAX package's bit for bit, every plane; the state after
  them carried to the port and back bit for bit (``shared_block`` stored
  once, with one set of AdamW moments), and a port checkpoint of it
  restored by the JAX package with an equal manifest.
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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.models import build_model as jbuild_model
from repro.monitor import registry as jmon
from repro.optim import Optimizer as JOptimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train import checkpoint as jckpt
from repro.train import create_train_state as jcreate_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train.trainer import StepTimeMonitor as JStepTimeMonitor
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import rng as trng
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.convert import (flat_from_tree,
                                        train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.monitor import registry as tmon
from repro_torch.optim import Optimizer, warmup_cosine
from repro_torch.optim import clipping as tclip
from repro_torch.train import (create_train_state, make_serve_step,
                               make_train_step)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.train_state import clip_blocks
from repro_torch.train.trainer import StepTimeMonitor, Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = ("yi-6b", "gemma2-9b", "granite-20b", "minitron-4b", "qwen2-vl-2b")
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
MOE_STEPS = 4
# name -> (arch, config overrides): the golden file's three models
SSM_MODELS = {name: (arch, dict(rwkv_factorized=True,
                                rwkv_subchunk=golden.SSM_SUBCHUNK)
                     if factorized else {})
              for name, (arch, factorized) in golden.SSM_MODELS.items()}
SSM_STEPS = 4
STATS_REL, SSM_GNORM_REL = 1e-5, 1e-4
LOSS_REL, GRAD_TOL = 1e-5, 1e-4
BF16_LOSS_REL, BF16_GRAD_TOL = 5e-4, 8e-2
STEP_REL = 1e-5


def cfgs(arch="yi-6b", **kw):
    return (dataclasses.replace(jreduce(jget_config(arch)), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **kw))


def tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def bits(x):
    return np.asarray(host(x), np.float32).view(np.int32)


def batch_for(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "targets": rng.integers(0, cfg.vocab_size, (b, s))}
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.pos_type == "mrope":
        out["positions"] = rng.integers(0, 40, (b, 3, s)).astype(np.int32)
    return out


def loss_and_grads(arch, batch, **kw):
    """(JAX loss, aux, grads as {port name: array}; port loss, aux,
    model) on the same weights."""
    jcfg, tcfg = cfgs(arch, **kw)
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, jbatch(batch))
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    tl, taux = tm.loss(tbatch(batch))
    tl.backward()
    return (jl, jaux, flat_from_tree(tcfg, jax.tree.map(np.asarray, jg)),
            tl.detach(), taux, tm)


def check_grads(tm, jgrads, tol):
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(jgrads)
    for name, p in tm.named_parameters():
        want = jgrads[name]
        scale = float(np.abs(want).max())
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= tol * max(scale, 1e-30), (name, err, scale)
        assert np.isfinite(p.grad.numpy()).all()


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``test_arch_smoke.py``'s forward/loss and grad-step claims for the
    port (finite positive loss, finite non-zero grads), and the values
    against the JAX package's."""
    jcfg, tcfg = cfgs(arch)
    batch = batch_for(tcfg, 1)
    jl, jaux, jgrads, tl, taux, tm = loss_and_grads(arch, batch)
    assert np.isfinite(float(tl)) and float(tl) > 0.0
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(taux["ce_loss"]) == pytest.approx(float(jaux["ce_loss"]),
                                                   rel=LOSS_REL)
    assert float(taux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0
    assert not taux["ce_loss"].requires_grad
    for st in taux["stats"]["stack"]:
        assert all(not v.requires_grad for v in st.values())
    check_grads(tm, jgrads, GRAD_TOL)
    assert sum(float((p.grad ** 2).sum()) for p in tm.parameters()) > 0.0
    with torch.no_grad():
        logits, _ = tm(**{k: torch.from_numpy(v) for k, v in batch.items()
                          if k != "targets"})
    assert logits.shape == (2, 16, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_within_measured_bound(arch):
    jcfg, tcfg = cfgs(arch, dtype="bfloat16")
    jl, _, jgrads, tl, _, tm = loss_and_grads(arch, batch_for(tcfg, 2),
                                              dtype="bfloat16")
    assert abs(float(tl) - float(jl)) <= BF16_LOSS_REL * abs(float(jl))
    check_grads(tm, jgrads, BF16_GRAD_TOL)


def test_h2_onehot_xent_matches_gather_and_jax():
    """``test_perf_variants.py::test_h2_onehot_xent_matches_gather`` on the
    port, and the one-hot loss against the JAX package's."""
    batch = batch_for(cfgs()[1], 3)
    jl, _, jgrads, tl, _, tm = loss_and_grads("yi-6b", batch,
                                              onehot_xent=True)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    check_grads(tm, jgrads, GRAD_TOL)
    tcfg = dataclasses.replace(tm.cfg, onehot_xent=False)
    other = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    other.load_state_dict(tm.state_dict())
    gl, _ = other.loss(tbatch(batch))
    np.testing.assert_allclose(float(gl.detach()), float(tl), rtol=1e-6)


def test_masked_loss_matches_jax():
    batch = batch_for(cfgs()[1], 4)
    batch["mask"] = (np.random.default_rng(5).random((2, 16)) < 0.6) \
        .astype(np.float32)
    jl, jaux, jgrads, tl, taux, tm = loss_and_grads("yi-6b", batch)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    check_grads(tm, jgrads, GRAD_TOL)
    batch["mask"][:] = 0.0          # an empty mask divides by 1, not 0
    tl0, _ = tm.loss(tbatch(batch))
    assert float(tl0.detach()) == 0.0


# ------------------------------------------------------------- monitors
_RUN = {}


def jax_run(steps=12):
    """The JAX package's reduced yi-6b: its initial TrainState (numpy),
    the stats of ``steps`` train steps and each step's metrics, the
    states after 5 steps, the batches."""
    if "run" in _RUN:
        return _RUN["run"]
    jcfg, tcfg = cfgs()
    jm = jbuild_model(jcfg)
    opt = JOptimizer(kind="adamw", lr_fn=jwarmup_cosine(1e-3, 10, 30))
    corpus = JCorpus(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                 batch_size=4))
    batches = [corpus.batch(i) for i in range(steps)]
    state = jcreate_train_state(jm, opt, jax.random.PRNGKey(0),
                                example_batch=batches[0])
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jmake_train_step(jm, opt))
    loss_fn = jax.jit(jm.loss)
    stats, metrics, after5 = [], [], None
    for i, b in enumerate(batches):
        _, aux = loss_fn(state.params, jbatch(b))
        stats.append(jax.tree.map(np.asarray, aux["stats"]))
        state, met = step(state, jbatch(b))
        metrics.append({k: float(v) for k, v in met.items()})
        if i == 4:
            after5 = jax.tree.map(np.asarray, state)
    _RUN["run"] = (jm, opt, init, stats, metrics, after5, batches,
                   jax.tree.map(np.asarray, state))
    return _RUN["run"]


def test_flatten_stats_orders_as_jax():
    jm, _, init, *_ = jax_run()
    tcfg = cfgs()[1]
    tm = params_from_numpy(tcfg, init.params, device="cpu")
    b = batch_for(tcfg, 6)
    _, jaux = jm.loss(jax.tree.map(jnp.asarray, init.params), jbatch(b))
    with torch.no_grad():
        _, taux = tm.loss(tbatch(b))
    for got, want in zip(tmon._flatten_stats(taux["stats"]),
                         jmon._flatten_stats(jaux["stats"])):
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5)


def test_monitor_fleets_bit_exact_on_jax_stats():
    """init_train_monitors' group counts and fleets, then 12 ticks fed the
    JAX package's stats: each fleet's planes and cursor equal."""
    jm, _, init, stats, *_ = jax_run()
    jfleets = jmon.init_train_monitors(
        jm, jax.tree.map(jnp.asarray, init.params),
        {"tokens": jnp.zeros((4, 32), jnp.int32),
         "targets": jnp.zeros((4, 32), jnp.int32)})
    tm = params_from_numpy(cfgs()[1], init.params, device="cpu")
    tfleets = tmon.init_train_monitors(tm)
    assert tfleets.n_act_groups == int(jfleets.n_act_groups) == 2
    assert tfleets.n_moe_groups == int(jfleets.n_moe_groups) == 0
    assert tfleets.expert_load_q99 is None and \
        jfleets.expert_load_q99 is None
    for st in stats:
        jfleets = jmon.update_train_monitors(
            jfleets, jax.tree.map(jnp.asarray, st))
        tfleets = tmon.update_train_monitors(
            tfleets, jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                                  st))
        for name in ("act_absmax_q99", "act_rms_q50"):
            jf, tf = getattr(jfleets, name), getattr(tfleets, name)
            for f in ("m", "step", "sign"):
                np.testing.assert_array_equal(bits(getattr(tf.state, f)),
                                              bits(getattr(jf.state, f)))
            assert [int(x) for x in tf.cursor] == \
                [int(np.asarray(x)) for x in jf.cursor]
    js, ts = jmon.monitor_summary(jfleets), tmon.monitor_summary(tfleets)
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(bits(ts[k]), bits(js[k]))


# ----------------------------------------------------- state and steps
def test_create_train_state_keys_and_lanes_match_jax():
    _, _, init, *_ = jax_run()
    tcfg = cfgs()[1]
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(1e-3, 10, 30))
    st = create_train_state(model, opt, trng.prng_key(0),
                            example_batch=batch_for(tcfg, 0))
    np.testing.assert_array_equal(st.rng, init.rng)
    assert st.step == 0 and st.qclip.warmup == 0
    assert st.qclip.sketch.m.shape == init.qclip.sketch.m.shape == (5,)
    assert st.monitors.n_act_groups == int(init.monitors.n_act_groups)
    assert create_train_state(model, opt, trng.prng_key(0)).monitors is None
    assert sorted(st.opt_state.mu) == sorted(
        n for n, _ in model.named_parameters())


def test_train_state_carried_and_back_bit_for_bit():
    """JAX TrainState -> the port's -> the JAX layout: every leaf of the
    checkpoint tree equal bit for bit, in the same order."""
    _, _, _, _, _, after5, _, _ = jax_run()
    st = train_state_from_numpy(cfgs()[1], after5, device="cpu")
    assert st.step == 5 and st.qclip.warmup == 5
    back = train_state_to_numpy(st)
    got = tckpt._flatten(tckpt._pack_sketches(back))
    want = jax.tree_util.tree_leaves(jckpt._pack_sketches(after5))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


def test_five_train_steps_from_carried_state():
    """Five port steps from the JAX initial state on the JAX batches: each
    loss and grad norm within STEP_REL, the key words equal, the clip's
    warmup and the step count."""
    _, _, init, _, metrics, after5, batches, _ = jax_run()
    tcfg = cfgs()[1]
    st = train_state_from_numpy(tcfg, init, device="cpu")
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(1e-3, 10, 30))
    step = make_train_step(st.params, opt)
    for i in range(5):
        st, met = step(st, tbatch(batches[i]))
        for k in ("loss", "ce_loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(metrics[i][k],
                                                  rel=STEP_REL), (i, k)
        assert float(met["aux_loss"]) == metrics[i]["aux_loss"] == 0.0
    np.testing.assert_array_equal(st.rng, after5.rng)
    assert st.step == 5 and st.qclip.warmup == 5
    np.testing.assert_allclose(host(st.qclip.sketch.m),
                               after5.qclip.sketch.m, rtol=STEP_REL)
    flat = flat_from_tree(tcfg, after5.params)
    for name, p in st.params.named_parameters():
        np.testing.assert_allclose(host(p), flat[name], rtol=0,
                                   atol=1e-5 * np.abs(flat[name]).max()
                                   + 1e-7)


def test_global_clip_step_matches_jax():
    _, opt, init, _, _, _, batches, _ = jax_run()
    jm = jbuild_model(cfgs()[0])
    jstep = jax.jit(jmake_train_step(jm, opt, clip_mode="global",
                                     max_norm=0.5))
    js, jmet = jstep(jax.tree.map(jnp.asarray, init), jbatch(batches[0]))
    st = train_state_from_numpy(cfgs()[1], init, device="cpu")
    step = make_train_step(st.params, Optimizer(
        kind="adamw", lr_fn=warmup_cosine(1e-3, 10, 30)),
        clip_mode="global", max_norm=0.5)
    st, met = step(st, tbatch(batches[0]))
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=STEP_REL)
    assert st.qclip.warmup == 0        # the sketch did not tick
    flat = flat_from_tree(cfgs()[1], jax.tree.map(np.asarray, js.params))
    for name, p in st.params.named_parameters():
        np.testing.assert_allclose(host(p), flat[name], rtol=0,
                                   atol=1e-6 * np.abs(flat[name]).max())


def test_serve_step_is_decode_step():
    _, _, init, *_ = jax_run()
    tm = params_from_numpy(cfgs()[1], init.params, device="cpu")
    serve = make_serve_step(tm)
    toks = torch.zeros((2, 1), dtype=torch.int32)
    a, _ = serve(toks, tm.init_cache(2, 8), 0)
    b, _ = tm.decode_step(toks, tm.init_cache(2, 8), 0)
    assert torch.equal(a, b)


# ----------------------------------------------------------- checkpoints
def manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        m = json.load(f)
    return m["num_leaves"], m["shapes"], m["dtypes"], m["crc32"]


def test_train_state_checkpoint_crosses_both_ways(tmp_path):
    """JAX writes, the port restores into a fresh state and writes again:
    equal manifests and CRC32s. The port writes its own state, JAX
    restores it into its structure and writes again: equal too."""
    jm, _, init, _, _, after5, _, final = jax_run()
    tcfg = cfgs()[1]
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5,
                          jax.tree.map(jnp.asarray, after5))
    like = train_state_from_numpy(tcfg, init, device="cpu")
    st, step = tckpt.restore_train_state(str(tmp_path / "jax"), like)
    assert step == 5 and st.params is like.params and st.step == 5
    tckpt.save_train_state(str(tmp_path / "port"), 5, st)
    assert manifest(tmp_path / "port", 5) == manifest(tmp_path / "jax", 5)

    mine = train_state_from_numpy(tcfg, final, device="cpu")
    tckpt.save_train_state(str(tmp_path / "port2"), 12, mine)
    restored, _ = jckpt.restore_checkpoint(
        str(tmp_path / "port2"), jax.tree.map(jnp.asarray, init))
    jckpt.save_checkpoint(str(tmp_path / "jax2"), 12, restored)
    assert manifest(tmp_path / "jax2", 12) == \
        manifest(tmp_path / "port2", 12)


# -------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_jax(arch):
    jcfg, tcfg = cfgs(arch)
    jl, jaux, jgrads, tl, taux, tm = loss_and_grads(arch,
                                                    batch_for(tcfg, 7, s=24))
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(jaux["aux_loss"]) > 0.0
    assert float(taux["aux_loss"]) == pytest.approx(
        float(jaux["aux_loss"]), rel=LOSS_REL)
    check_grads(tm, jgrads, GRAD_TOL)
    for name, p in tm.named_parameters():
        if name.endswith("router"):
            assert float(p.grad.abs().max()) > 0.0, name


_MOE = {}


def jax_moe_run(arch):
    """The JAX package's reduced ``arch``: its initial TrainState (numpy),
    MOE_STEPS batches of its corpus, each step's metrics and expert-load
    fleet, the state after the steps."""
    if arch in _MOE:
        return _MOE[arch]
    jcfg, _ = cfgs(arch)
    jm = jbuild_model(jcfg)
    opt = JOptimizer(kind="adamw", lr_fn=jwarmup_cosine(1e-3, 10, 30))
    corpus = JCorpus(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                 batch_size=4))
    batches = [corpus.batch(i) for i in range(MOE_STEPS)]
    state = jcreate_train_state(jm, opt, jax.random.PRNGKey(0),
                                example_batch=batches[0])
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jmake_train_step(jm, opt))
    metrics, fleets = [], []
    for b in batches:
        state, met = step(state, jbatch(b))
        metrics.append({k: float(v) for k, v in met.items()})
        fleets.append(jax.tree.map(np.asarray,
                                   state.monitors.expert_load_q99))
    _MOE[arch] = (jm, init, batches, metrics, fleets,
                  jax.tree.map(np.asarray, state))
    return _MOE[arch]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_steps_and_expert_load_fleet_match_jax(arch):
    _, init, batches, metrics, fleets, _ = jax_moe_run(arch)
    tcfg = cfgs(arch)[1]
    st = train_state_from_numpy(tcfg, init, device="cpu")
    assert st.monitors.n_moe_groups == int(init.monitors.n_moe_groups) \
        == 2 * tcfg.moe_experts
    assert tmon.group_counts(tcfg) == (int(init.monitors.n_act_groups),
                                       int(init.monitors.n_moe_groups))
    fresh = tmon.init_train_monitors(st.params)
    assert fresh.n_moe_groups == st.monitors.n_moe_groups
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(1e-3, 10, 30))
    step = make_train_step(st.params, opt)
    for i, b in enumerate(batches):
        st, met = step(st, tbatch(b))
        for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(metrics[i][k],
                                                  rel=STEP_REL), (i, k)
        fl, jf = st.monitors.expert_load_q99, fleets[i]
        for f in ("m", "step", "sign"):
            np.testing.assert_array_equal(bits(getattr(fl.state, f)),
                                          bits(getattr(jf.state, f)))
        assert [int(x) for x in fl.cursor] == \
            [int(np.asarray(x)) for x in jf.cursor]
    assert float(host(st.monitors.expert_load_q99.state.m).max()) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_state_crosses_both_ways(arch, tmp_path):
    """The JAX state after the steps -> the port's -> the JAX layout, leaf
    for leaf bit for bit (the expert-load fleet's lanes included); a port
    checkpoint of it restored by the JAX package and written again with
    an equal manifest."""
    jm, init, _, _, _, final = jax_moe_run(arch)
    tcfg = cfgs(arch)[1]
    st = train_state_from_numpy(tcfg, final, device="cpu")
    assert st.monitors.expert_load_q99.state.m.shape == \
        (2 * tcfg.moe_experts,)
    back = train_state_to_numpy(st)
    got = tckpt._flatten(tckpt._pack_sketches(back))
    want = jax.tree_util.tree_leaves(jckpt._pack_sketches(final))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))
    tckpt.save_train_state(str(tmp_path / "port"), MOE_STEPS, st)
    restored, _ = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                           jax.tree.map(jnp.asarray, init))
    jckpt.save_checkpoint(str(tmp_path / "jax"), MOE_STEPS, restored)
    assert manifest(tmp_path / "jax", MOE_STEPS) == \
        manifest(tmp_path / "port", MOE_STEPS)


# -------------------------------------------------------------- recurrent
_SSM = {}


def jax_ssm_run(name):
    """The JAX package's reduced recurrent config: its initial TrainState
    with every parameter leaf redrawn (numpy), SSM_STEPS batches of its
    corpus (seq 32: one chunk), each step's metrics and activation
    fleets, the state after the steps."""
    if name in _SSM:
        return _SSM[name]
    arch, kw = SSM_MODELS[name]
    jcfg, tcfg = cfgs(arch, **kw)
    jm = jbuild_model(jcfg)
    opt = JOptimizer(kind="adamw", lr_fn=jwarmup_cosine(1e-3, 10, 30))
    corpus = JCorpus(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                 batch_size=4))
    batches = [corpus.batch(i) for i in range(SSM_STEPS)]
    state = jcreate_train_state(jm, opt, jax.random.PRNGKey(0),
                                example_batch=batches[0])
    params = golden.redraw_params(jax.tree.map(np.asarray, state.params), 33)
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jmake_train_step(jm, opt))
    loss_fn = jax.jit(jm.loss)
    metrics, fleets, stats = [], [], []
    for b in batches:
        stats.append(jax.tree.map(np.asarray,
                                  loss_fn(state.params, jbatch(b))[1]["stats"]))
        state, met = step(state, jbatch(b))
        metrics.append({k: float(v) for k, v in met.items()})
        fleets.append(jax.tree.map(np.asarray, (state.monitors.act_absmax_q99,
                                                state.monitors.act_rms_q50)))
    _SSM[name] = (jm, tcfg, init, batches, metrics, (fleets, stats),
                  jax.tree.map(np.asarray, state))
    return _SSM[name]


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_loss_and_grads_match_jax(name):
    jm, tcfg, init, batches, *_ = jax_ssm_run(name)
    b = batches[0]
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, init.params), jbatch(b))
    tm = params_from_numpy(tcfg, init.params, device="cpu")
    tl, taux = tm.loss(tbatch(b))
    tl.backward()
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(taux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0
    jgrads = flat_from_tree(tcfg, jax.tree.map(np.asarray, jg))
    check_grads(tm, jgrads, GRAD_TOL)
    assert ("shared_block.attn.wq" in jgrads) == tcfg.shared_attention


def check_act_fleets(fleets, jfleets, clamped_rel=None):
    """Activation fleets against the JAX package's: sign planes and
    cursors bit for bit; m and step bit for bit, or, with
    ``clamped_rel``, each lane's within that bound times its |m| (the 2U
    tick sets m to the statistic x and moves step by x - m)."""
    for fl, jf in zip(fleets, jfleets):
        loose = ("m", "step") if clamped_rel else ()
        for f in ("m", "step", "sign"):
            if f not in loose:
                np.testing.assert_array_equal(bits(getattr(fl.state, f)),
                                              bits(getattr(jf.state, f)))
        scale = np.abs(np.asarray(jf.state.m))
        for f in loose:
            err = np.abs(host(getattr(fl.state, f))
                         - np.asarray(getattr(jf.state, f)))
            assert (err <= clamped_rel * scale).all(), (f, err, scale)
        assert [int(x) for x in fl.cursor] == \
            [int(np.asarray(x)) for x in jf.cursor]


@pytest.mark.parametrize("name", sorted(SSM_MODELS))
def test_recurrent_train_steps_and_monitors_match_jax(name):
    jm, tcfg, init, batches, metrics, (fleets, stats), _ = jax_ssm_run(name)
    st = train_state_from_numpy(tcfg, init, device="cpu")
    fed = tmon.init_train_monitors(st.params)
    assert tmon.group_counts(tcfg) == (int(init.monitors.n_act_groups), 0)
    assert st.monitors.expert_load_q99 is None
    keys, _ = clip_blocks(st.params)
    assert keys == tuple(sorted(init.params))
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(1e-3, 10, 30))
    step = make_train_step(st.params, opt)
    for i, b in enumerate(batches):
        st, met = step(st, tbatch(b))
        for k, rel in (("loss", STEP_REL), ("ce_loss", STEP_REL),
                       ("grad_norm", SSM_GNORM_REL)):
            assert float(met[k]) == pytest.approx(metrics[i][k],
                                                  rel=rel), (i, k)
        mon = st.monitors
        check_act_fleets((mon.act_absmax_q99, mon.act_rms_q50), fleets[i],
                         STATS_REL)
        fed = tmon.update_train_monitors(fed, jax.tree.map(
            lambda x: torch.from_numpy(np.array(x)), stats[i]))
        check_act_fleets((fed.act_absmax_q99, fed.act_rms_q50), fleets[i])
    assert fed.n_act_groups == tcfg.num_layers


@pytest.mark.parametrize("name", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_recurrent_train_state_crosses_both_ways(name, tmp_path):
    """The JAX state after the steps -> the port's -> the JAX layout, leaf
    for leaf bit for bit (zamba2's ``shared_block`` once, its ``stack``
    placeholder empty); a port checkpoint restored by the JAX package and
    written again with an equal manifest."""
    jm, tcfg, init, _, _, _, final = jax_ssm_run(name)
    st = train_state_from_numpy(tcfg, final, device="cpu")
    back = train_state_to_numpy(st)
    if tcfg.shared_attention:
        for tree in (back.params, back.opt_state.mu, back.opt_state.nu):
            assert tree["stack"][0] == {} and "shared_block" in tree
        names = list(st.opt_state.mu)
        assert sum(n.startswith("shared_block.") for n in names) == \
            len(jax.tree.leaves(final.params["shared_block"]))
        assert not any(n.startswith("layers.0.") for n in names)
    got = tckpt._flatten(tckpt._pack_sketches(back))
    want = jax.tree_util.tree_leaves(jckpt._pack_sketches(final))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = host(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))
    tckpt.save_train_state(str(tmp_path / "port"), SSM_STEPS, st)
    restored, _ = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                           jax.tree.map(jnp.asarray, init))
    jckpt.save_checkpoint(str(tmp_path / "jax"), SSM_STEPS, restored)
    assert manifest(tmp_path / "jax", SSM_STEPS) == \
        manifest(tmp_path / "port", SSM_STEPS)


def test_full_config_group_counts():
    """The expert-load fleet's lanes at full width: (layer, expert) for
    every MoE layer, deepseek's dense prefix excluded."""
    assert tmon.group_counts(get_config("deepseek-v2-lite-16b")) == \
        (27, 26 * 64)
    assert tmon.group_counts(get_config("olmoe-1b-7b")) == (16, 16 * 64)
    assert tmon.group_counts(get_config("yi-6b")) == (32, 0)


# ------------------------------------------------------------ trajectory
@pytest.fixture(scope="module")
def trained():
    """``tests/test_train_loop.py``'s run on the port alone: the reduced
    yi-6b, warmup_cosine(2e-3, 10, 150), batch 8 x 48, 120 steps."""
    cfg = reduce_for_smoke(get_config("yi-6b"))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(2e-3, 10, 150))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=48, batch_size=8))
    it = corpus.iterate(prefetch=0, device="cpu")
    state = create_train_state(model, opt, trng.prng_key(0),
                               example_batch=next(it))
    trainer = Trainer(model, opt, make_train_step(model, opt), it,
                      log_every=1000)
    return trainer.run(state, 120), trainer


def test_loss_decreases(trained):
    _, trainer = trained
    losses = [m["loss"] for m in trainer.metrics_history]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3
    assert np.isfinite(losses[-1])


def test_monitors_learned_activation_quantiles(trained):
    state, _ = trained
    summ = tmon.monitor_summary(state.monitors)
    q99 = host(summ["act_absmax_q99"])
    q50 = host(summ["act_rms_q50"])
    assert q99.shape[0] > 0 and np.all(q99 > 0.0) and np.all(q50 > 0.0)
    assert np.all(q50 <= q99 * 50)


def test_quantile_clip_state_engaged(trained):
    state, _ = trained
    assert state.qclip.warmup == 120 and state.step == 120
    assert np.any(np.abs(host(state.qclip.sketch.m) - 1.0) > 1e-3)


def test_step_time_monitor_bit_exact_with_jax():
    rng = np.random.default_rng(4)
    dts = np.concatenate([0.1 + rng.normal(0, 0.005, 200),
                          [0.5, 0.02, 0.3], rng.uniform(1e-3, 0.4, 100)])
    j, t = JStepTimeMonitor(margin=1.5), StepTimeMonitor(margin=1.5)
    for dt in dts:
        assert t.observe(float(dt)) == j.observe(float(dt))
        assert (t.m, t.step_size, t.sign, t.count) == \
            (j.m, j.step_size, j.sign, j.count)
    assert t.q99_ms == j.q99_ms


def test_straggler_detector_flags_outlier():
    mon = StepTimeMonitor(margin=1.5)
    rng = np.random.default_rng(0)
    flags = [mon.observe(max(0.10 + rng.normal(0, 0.005), 1e-3))
             for _ in range(200)]
    assert not any(flags[50:])
    assert mon.observe(0.5)
    assert 50 < mon.q99_ms < 200


# -------------------------------------------------------------- launcher
def run_train(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu"] + args, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_preemption_restart_resumes_and_finishes(tmp_path):
    """Killed at step 30 (os._exit(42)) with checkpoints every 10, then
    restarted: resumes from 30 and finishes 60."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", "yi-6b", "--steps", "60", "--batch", "4", "--seq",
              "32", "--ckpt-dir", ckpt, "--ckpt-every", "10"]
    r1 = run_train(common + ["--die-at-step", "30"])
    assert r1.returncode == 42, r1.stderr[-2000:]
    assert tckpt.latest_step(ckpt) == 30
    r2 = run_train(common)
    assert r2.returncode == 0, r2.stderr[-2000:]
    out = json.loads(r2.stdout.strip().splitlines()[-1])
    assert out["final_step"] == 60 and out["steps"] == 30
    assert out["device"] == "cpu"
    assert "resumed from step 30" in r2.stdout + r2.stderr
    assert tckpt.latest_step(ckpt) == 60


def test_launcher_needs_a_card_or_cpu(monkeypatch):
    from repro_torch.launch import train as launch_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch_train.main(["--steps", "1"])


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_launcher_trains_recurrent_archs_on_cpu(arch, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "4",
                       "--batch", "2", "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == arch and out["final_step"] == 4
    assert np.isfinite(out["last_loss"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_trains_moe_archs_on_cpu(arch, capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "4",
                       "--batch", "2", "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == arch and out["final_step"] == 4
    assert np.isfinite(out["last_loss"])


# ---------------------------------------------------------- golden entry


def golden_run(data, device, ckpt_copy):
    """The port on the golden file's ``train/*`` entry: the carried
    initial state through 8 steps, the frugal parts fed the golden norms
    and stats, and the committed JAX checkpoint continued."""
    cfg = golden.serve_config(reduce_for_smoke(get_config(golden.SERVE_ARCH)))
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*golden.TRAIN_LR))
    init = train_state_from_numpy(cfg, golden.train_state_tree(data),
                                  device=device)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in golden.train_batches(data)]
    loss, _ = init.params.loss(batches[0])
    loss.backward()
    grads1 = {n: p.grad.detach().cpu().numpy()
              for n, p in init.params.named_parameters()}
    init.params.zero_grad(set_to_none=True)
    step = make_train_step(init.params, opt)
    st, losses = init, []
    for b in batches:
        st, met = step(st, b)
        losses.append(float(met["loss"]))
    like = train_state_from_numpy(cfg, golden.train_state_tree(data),
                                  device=device)
    resumed, at = tckpt.restore_train_state(ckpt_copy, like)
    cont = make_train_step(resumed.params, opt)
    later = []
    for b in batches[at:]:
        resumed, met = cont(resumed, b)
        later.append(float(met["loss"]))
    return cfg, float(loss.detach()), grads1, losses, at, later, resumed


def test_golden_training_entry_on_cpu(tmp_path):
    import shutil

    data = np.load(golden.GOLDEN)
    ckpt_copy = str(tmp_path / "train")
    shutil.copytree(os.path.join(golden.CKPT_ROOT, "train"), ckpt_copy)
    cfg, loss1, grads1, losses, at, later, resumed = golden_run(
        data, "cpu", ckpt_copy)
    want = data["train/loss"]
    assert abs(loss1 - want[0]) <= LOSS_REL * abs(want[0])
    jg = flat_from_tree(cfg, golden.unflatten_params(data, "train/grads1"))
    for name, g in grads1.items():
        scale = float(np.abs(jg[name]).max())
        assert float(np.abs(g - jg[name]).max()) <= GRAD_TOL * scale, name
    np.testing.assert_allclose(losses, want, rtol=STEP_REL)
    assert at == golden.TRAIN_CKPT_STEP and resumed.step == 8
    np.testing.assert_allclose(later, want[at:], rtol=STEP_REL)

    # the frugal parts on the golden norms and stats, bit for bit
    init = golden.train_state_tree(data)
    qclip = tclip_state(init)
    fleets = tmon.init_train_monitors(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    for i in range(golden.TRAIN_STEPS):
        scales, qclip = tclip.quantile_clip_scales(
            torch.from_numpy(data["train/block_norms"][i]), qclip,
            data["train/clip_key"][i])
        for f in ("m", "step", "sign"):
            np.testing.assert_array_equal(bits(getattr(qclip.sketch, f)),
                                          bits(data[f"train/clip_{f}"][i]))
        stats = {"stack": [{"absmax": torch.from_numpy(
            data["train/stats_absmax"][i]), "rms": torch.from_numpy(
            data["train/stats_rms"][i])}]}
        fleets = tmon.update_train_monitors(fleets, stats)
        for name in golden.TRAIN_MONITORS:
            fl = getattr(fleets, name)
            for f in ("m", "step", "sign"):
                np.testing.assert_array_equal(
                    bits(getattr(fl.state, f)),
                    bits(data[f"train/{name}/{f}"][i]))
            assert [int(x) for x in fl.cursor] == \
                data[f"train/{name}/cursor"][i].tolist()
    assert qclip.warmup == golden.TRAIN_STEPS


def tclip_state(init):
    from repro_torch.core.frugal import Frugal2UState
    from repro_torch.optim.clipping import QuantileClipState

    sk = init.qclip.sketch
    return QuantileClipState(
        Frugal2UState(*(torch.from_numpy(np.array(getattr(sk, f)))
                        for f in ("m", "step", "sign"))),
        int(init.qclip.warmup))


def test_committed_train_checkpoint_restores_with_equal_crc32s(tmp_path):
    """The committed JAX TrainState checkpoint restores into the port and
    saves back with the same manifest and CRC32s."""
    import shutil

    data = np.load(golden.GOLDEN)
    cfg = golden.serve_config(reduce_for_smoke(get_config(golden.SERVE_ARCH)))
    src = str(tmp_path / "train")
    shutil.copytree(os.path.join(golden.CKPT_ROOT, "train"), src)
    like = train_state_from_numpy(cfg, golden.train_state_tree(data),
                                  device="cpu")
    st, step = tckpt.restore_train_state(src, like)
    tckpt.save_train_state(str(tmp_path / "port"), step, st)
    assert manifest(tmp_path / "port", step) == manifest(src, step)
