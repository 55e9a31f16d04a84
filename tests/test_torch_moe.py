"""The port's MoE layer (``repro_torch.models.layers.moe``) against the JAX
package's, on the CPU.

Inputs and weights from numpy seeds, at ``reduce_for_smoke`` widths
(d_model 128, 8 experts of d_ff 64, top 2), a batch of 2 sequences of 64
tokens, with and without shared experts, at capacity factor 1.25 (cap 21
of 32 expected: assignments drop) and 16.0 (none drop).

Routing is compared first and must be identical: the top-k experts and
weights' order, the dispatch (sorted experts, slots, tokens, the
``dropped`` mask), ``expert_load`` and ``drop_fraction`` bit for bit.
Then the values: the output and ``aux_loss`` within RTOL = 1e-5 relative
(of max |out|), the gradients of the input and every weight within
GRAD_TOL = 1e-5 x max |g| of the JAX package's. Router logits that tie
exactly pin the tie-break: the lower expert index first, as
``jax.lax.top_k`` orders equal values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models.layers import moe as jmoe
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.layers import moe as tmoe

RTOL = 1e-5
GRAD_TOL = 1e-5
B, S = 2, 64


def cfgs(shared: int, cf: float):
    kw = dict(moe_shared_experts=shared, capacity_factor=cf)
    arch = "deepseek-v2-lite-16b"
    return (dataclasses.replace(jreduce(jget_config(arch)), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **kw))


def moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    p = {"router": rng.normal(0, d ** -.5, (d, e)),
         "w_in": rng.normal(0, d ** -.5, (e, d, ff)),
         "w_gate": rng.normal(0, d ** -.5, (e, d, ff)),
         "w_out": rng.normal(0, ff ** -.5, (e, ff, d))}
    if cfg.moe_shared_experts:
        sff = ff * cfg.moe_shared_experts
        p["shared"] = {"w_in": rng.normal(0, d ** -.5, (d, sff)),
                       "w_gate": rng.normal(0, d ** -.5, (d, sff)),
                       "w_out": rng.normal(0, sff ** -.5, (sff, d))}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def routing(jcfg, tcfg, p, x):
    """Both packages' (top_w, top_e) and dispatch outputs."""
    jlog = jnp.einsum("bsd,de->bse", jnp.asarray(x), p["router"])
    jw, je = jax.lax.top_k(jax.nn.softmax(jlog, -1), jcfg.moe_topk)
    jw = jw / jnp.maximum(jnp.sum(jw, -1, keepdims=True), 1e-9)
    cap = int(jcfg.capacity_factor * S * jcfg.moe_topk / jcfg.moe_experts) + 1
    jd = jax.vmap(lambda xs, tw, te: jmoe._dispatch_one_seq(
        xs, tw, te, jcfg.moe_experts, cap, jnp.float32))(jnp.asarray(x), jw,
                                                         je)
    tlog = torch.einsum("bsd,de->bse", torch.from_numpy(x),
                        torch.from_numpy(p["router"]))
    tw, te = tmoe.top_k(torch.softmax(tlog, -1), tcfg.moe_topk)
    tw = tw / torch.clamp(tw.sum(-1, keepdim=True), min=1e-9)
    td = tmoe._dispatch(torch.from_numpy(x), tw, te, tcfg.moe_experts, cap,
                        torch.float32)
    return (jw, je, jd), (tw, te, td), cap


def assert_same_routing(j, t):
    (jw, je, jd), (tw, te, td) = j, t
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL)
    jbuf, jsorted, jslot, jtok, jws, jdrop = jd
    tbuf, tsorted, tslot, torder, tws, tdrop = td
    np.testing.assert_array_equal(tsorted.numpy(), np.asarray(jsorted))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal((torder // te.shape[-1]).numpy(),
                                  np.asarray(jtok))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    np.testing.assert_allclose(tws.numpy(), np.asarray(jws), rtol=RTOL)
    cap = tbuf.shape[2] - 1     # the overflow slot's content is unspecified
    np.testing.assert_allclose(tbuf[:, :, :cap].numpy(),
                               np.asarray(jbuf)[:, :, :cap], rtol=0, atol=0)


def close_rel(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("shared", [0, 2], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [1.25, 16.0], ids=["overflow", "no-drop"])
def test_moe_block_matches_jax(shared, cf):
    jcfg, tcfg = cfgs(shared, cf)
    p = moe_params(jcfg, 1 + shared)
    x = np.random.default_rng(3).normal(0, 1, (B, S, jcfg.d_model)) \
        .astype(np.float32)
    j, t, cap = routing(jcfg, tcfg, p, x)
    assert cap == (21 if cf == 1.25 else 257)
    assert_same_routing(j, t)
    dropped = np.asarray(j[2][-1])
    assert dropped.any() == (cf == 1.25)

    def jloss(p, x):
        out, aux = jmoe.moe_block(p, x, jcfg)
        return jnp.sum(out * out) + aux["aux_loss"], (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    tp, tx = torch_tree(p, grad=True), torch_tree(x, grad=True)
    tout, taux = tmoe.moe_block(tp, tx, tcfg)
    (torch.sum(tout * tout) + taux["aux_loss"]).backward()
    for k in ("expert_load", "drop_fraction"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      k)
    assert set(taux) == set(jaux)
    close_rel(tout, jout)
    close_rel(taux["aux_loss"], jaux["aux_loss"])
    close_rel(taux["router_logit_max"], jaux["router_logit_max"])
    close_rel(tx.grad, jgx, GRAD_TOL)
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgp))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        close_rel(leaf.grad, flat_j[path], GRAD_TOL)


@pytest.mark.parametrize("topk", [3, 6])
def test_load_statistics_bit_exact_at_inexact_counts(topk):
    """2 x 24 tokens at top 3 and top 6 (deepseek's k): 1/48, 1/144 and
    1/k are inexact in float32. The JAX package's model runs under
    ``jit``, where ``jnp.mean`` and the division by k multiply by the
    float32 reciprocal; the port's ``expert_load`` and ``drop_fraction``
    equal the jitted JAX package's bit for bit."""
    jcfg, tcfg = (dataclasses.replace(c, moe_topk=topk)
                  for c in cfgs(0, 1.25))
    p = moe_params(jcfg, 7)
    x = np.random.default_rng(8).normal(0, 1, (2, 24, jcfg.d_model)) \
        .astype(np.float32)
    _, jaux = jax.jit(lambda p, x: jmoe.moe_block(p, x, jcfg))(
        p, jnp.asarray(x))
    _, taux = tmoe.moe_block(torch_tree(p), torch.from_numpy(x), tcfg)
    for k in ("expert_load", "drop_fraction"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      k)
    # cap 12 for 9 expected at top 3: some drop (at top 6, cap 23 of 24)
    assert (float(taux["drop_fraction"]) > 0.0) == (topk == 3)


@pytest.mark.parametrize("case", ["all-tied", "pairs-tied"])
def test_tied_router_logits_break_toward_the_lower_expert(case):
    """A zero router ties every expert (each token picks experts 0 and 1,
    and the rest overflow); a router whose columns repeat in pairs ties
    each expert with its neighbour. Both packages choose the same experts
    in the same order, and the dispatch is the same."""
    jcfg, tcfg = cfgs(0, 1.25)
    p = moe_params(jcfg, 4)
    if case == "all-tied":
        p["router"][:] = 0.0
    else:
        p["router"][:, 1::2] = p["router"][:, 0::2]
    x = np.random.default_rng(5).normal(0, 1, (B, S, jcfg.d_model)) \
        .astype(np.float32)
    j, t, _ = routing(jcfg, tcfg, p, x)
    assert_same_routing(j, t)
    te = t[1].numpy()
    if case == "all-tied":
        assert (te == [0, 1]).all()
    else:
        assert (te[..., 0] % 2 == 0).all() and (te[..., 1] == te[..., 0] + 1
                                                ).all()
    jout, jaux = jmoe.moe_block(p, jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe_block(torch_tree(p), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    np.testing.assert_array_equal(taux["drop_fraction"].numpy(),
                                  np.asarray(jaux["drop_fraction"]))
    close_rel(tout, jout)


def test_top_k_matches_lax_top_k_on_ties():
    """Small integers in [0, 4) over 16 slots: most rows hold ties at the
    k-th place; values and indices equal to ``jax.lax.top_k``'s."""
    v = np.random.default_rng(6).integers(0, 4, (64, 16)).astype(np.float32)
    for k in (1, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = tmoe.top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_init_keeps_jax_shapes_and_scales():
    jcfg, tcfg = cfgs(2, 1.25)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
    js = jax.tree.map(lambda a: a.shape, jp)
    ts = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert js == ts
    d, ff = tcfg.d_model, tcfg.moe_d_ff
    for name, scale in (("router", d ** -.5), ("w_in", d ** -.5),
                        ("w_out", ff ** -.5)):
        assert abs(float(tp[name].std()) / scale - 1) < 0.1, name
