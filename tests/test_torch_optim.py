"""The port's optimizer layer (``repro_torch.optim``) against the JAX
package's ``optim``, on the CPU.

* Schedules: ``warmup_cosine`` and ``constant`` bit-exact against the
  JAX functions evaluated op by op, over 1100 steps of five schedules.
* AdamW and Lion: one update from the same grads, moments and params
  (and five chained updates) within 1e-6 relative of the JAX package's.
* Clipping: ``global_norm`` / ``clip_by_global_norm`` within 1e-6
  relative; the quantile clip's sketch, warmup and scales bit-exact when
  fed the JAX package's block norms and key chain over 40 steps (past the
  20-step warmup); ``quantile_clip`` on gradient blocks within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import clipping as jclip
from repro.optim import optimizer as jopt
from repro.optim import schedule as jsched
from repro_torch.core import rng as trng
from repro_torch.core.frugal import Frugal2UState
from repro_torch.optim import clipping as tclip
from repro_torch.optim import optimizer as topt
from repro_torch.optim import schedule as tsched

REL = 1e-6


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(x, np.float32).view(np.int32)


def rel_close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("args", [(1e-3, 10, 30), (2e-3, 10, 150),
                                  (3e-4, 7, 1000), (1e-3, 0, 50),
                                  (5e-4, 20, 15)])
def test_warmup_cosine_bit_exact(args):
    fj, ft = jsched.warmup_cosine(*args), tsched.warmup_cosine(*args)
    steps = np.arange(1100, dtype=np.int32)
    want = np.asarray([np.asarray(fj(jnp.int32(s))) for s in steps],
                      np.float32)
    got = np.asarray([ft(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_constant_bit_exact():
    for lr in (3e-4, 1e-3, 0.1):
        assert np.float32(tsched.constant(lr)(7)) == \
            np.asarray(jsched.constant(lr)(7))


def tree(seed, shapes=((3, 5), (7,), (2, 3, 4))):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(0, 1, s).astype(np.float32)
            for i, s in enumerate(shapes)}


def tt(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("kind", ["adamw", "lion"])
def test_optimizer_updates_match_jax(kind):
    """Five chained updates from the same grads: params and moments
    within REL of the JAX package's after each."""
    params = tree(0)
    jo = jopt.Optimizer(kind=kind, lr_fn=jsched.warmup_cosine(1e-2, 2, 6),
                        weight_decay=0.1, b1=0.9, b2=0.95)
    to = topt.Optimizer(kind=kind, lr_fn=tsched.warmup_cosine(1e-2, 2, 6),
                        weight_decay=0.1, b1=0.9, b2=0.95)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = tt(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        grads = tree(10 + step)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                           js, jp, step)
        ts = to.update(tt(grads), ts, tp, step)
        for k in params:
            rel_close(tp[k], jp[k])
            rel_close(ts.mu[k], js.mu[k])
            if kind == "adamw":
                rel_close(ts.nu[k], js.nu[k])
        assert int(ts.count) == int(js.count) == step + 1
        assert ts.count.dtype == torch.int32


def test_adamw_update_function_matches_jax():
    params, grads = tree(1), tree(2)
    mu, nu = tree(3), {k: np.abs(v) for k, v in tree(4).items()}
    js = jopt.AdamWState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                         nu={k: jnp.asarray(v) for k, v in nu.items()},
                         count=jnp.asarray(6, jnp.int32))
    ts = topt.AdamWState(mu=tt(mu), nu=tt(nu),
                         count=torch.tensor(6, dtype=torch.int32))
    jp, js = jopt.adamw_update({k: jnp.asarray(v) for k, v in grads.items()},
                               js, {k: jnp.asarray(v)
                                    for k, v in params.items()}, 3e-3)
    tp = tt(params)
    ts = topt.adamw_update(tt(grads), ts, tp, 3e-3)
    for k in params:
        rel_close(tp[k], jp[k])
        rel_close(ts.mu[k], js.mu[k])
        rel_close(ts.nu[k], js.nu[k])


def test_global_norm_and_clip_match_jax():
    g = tree(5)
    jn = jclip.global_norm(g)
    tn = tclip.global_norm(list(tt(g).values()))
    rel_close(tn, jn)
    for max_norm in (0.5, 100.0):
        jg, jn = jclip.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tg = tt(g)
        tn = tclip.clip_by_global_norm(list(tg.values()), max_norm)
        rel_close(tn, jn)
        for k in g:
            rel_close(tg[k], jg[k])
    assert float(tclip.global_norm([], device="cpu")) == 0.0


def test_quantile_clip_sketch_bit_exact_on_jax_norms():
    """40 steps of the clip on 5 blocks, fed the JAX package's block norms
    (lognormal, one block always 0.0 as the empty ``prefix`` is) and
    its key chain: sketch planes, warmup and scales equal bit for bit,
    through the warmup and 20 steps past it."""
    rng = np.random.default_rng(6)
    jstate = jclip.quantile_clip_init(5)
    tstate = tclip.quantile_clip_init(5, device="cpu")
    jkey, tkey = jax.random.PRNGKey(0), trng.prng_key(0)
    engaged = 0
    for step in range(40):
        jkey, jk = jax.random.split(jkey)
        tkey, tk = trng.split(tkey)
        norms = rng.lognormal(0.5, 0.8, 5).astype(np.float32)
        norms[3] = 0.0
        # each block one leaf whose norm is exactly the chosen norm
        blocks = [{"g": jnp.asarray([n], jnp.float32)} for n in norms]
        jblocks, jstate, jnorms = jclip.quantile_clip(blocks, jstate, jk)
        tnorms = torch.from_numpy(np.array(jnorms))
        scales, tstate = tclip.quantile_clip_scales(tnorms, tstate, tk)
        for f in ("m", "step", "sign"):
            np.testing.assert_array_equal(bits(getattr(tstate.sketch, f)),
                                          bits(getattr(jstate.sketch, f)))
        assert tstate.warmup == int(jstate.warmup) == step + 1
        # each block's one gradient, clipped: its norm times its scale
        np.testing.assert_array_equal(
            bits(tnorms * scales),
            bits(np.concatenate([np.asarray(b["g"]) for b in jblocks])))
        engaged += int((scales < 1).any())
    assert engaged > 0, "the clip never engaged"


def test_quantile_clip_on_gradient_blocks_matches_jax():
    rng = np.random.default_rng(8)
    jstate = jclip.quantile_clip_init(3)
    tstate = tclip.quantile_clip_init(3, device="cpu")
    key = trng.prng_key(9)
    for step in range(25):
        key, k = trng.split(key)
        grads = [tree(100 + 3 * step + i, ((4, 3), (5,))) for i in range(3)]
        jb, jstate, jn = jclip.quantile_clip(
            [{kk: jnp.asarray(v) for kk, v in g.items()} for g in grads],
            jstate, jnp.asarray(k), warmup_steps=5)
        tb = [list(tt(g).values()) for g in grads]
        tstate, tn = tclip.quantile_clip(tb, tstate, k, warmup_steps=5)
        rel_close(tn, jn)
        for got, want in zip(tb, jb):
            for t_, k_ in zip(got, sorted(want)):
                rel_close(t_, want[k_])
        np.testing.assert_allclose(tstate.sketch.m.numpy(),
                                   np.asarray(jstate.sketch.m), rtol=REL)


def test_quantile_clip_init_matches():
    j = jclip.quantile_clip_init(4, init_norm=2.5)
    t = tclip.quantile_clip_init(4, init_norm=2.5, device="cpu")
    assert isinstance(t.sketch, Frugal2UState) and t.warmup == 0
    for f in ("m", "step", "sign"):
        np.testing.assert_array_equal(bits(getattr(t.sketch, f)),
                                      bits(getattr(j.sketch, f)))
