"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``,
``roofline/trace_cost.py``, ``build_model(device="meta")``,
``abstract_train_state``) against the JAX package's, on the CPU.

* Shapes: the meta model's parameters, its caches, the train state and
  every cell's inputs equal the JAX package's ``eval_shape`` shapes,
  compared through ``models/convert.py``'s stacking. Differences by
  design, named here: a decode cell's ``pos`` is a host int (the cache's
  last slot) where JAX's is a 0-d int32; the state's ``step`` and the
  clip's ``warmup`` are host ints; the JAX train state has no monitors
  (``repro.train.train_state.abstract_train_state`` with an example batch
  fails under ``eval_shape``, ROADMAP C).
* FLOPs: the count of a step on meta tensors equals its count on real CPU
  tensors (reduced yi-6b, deepseek-v2-lite-16b and whisper-large-v3,
  train and decode).
* The dry run at full width: every arch's decode_32k and long_500k cells
  on the single and the multi-pod mesh (one trace each), and yi-6b's
  train_4k, return ok or skipped as ``cell_supported`` says, hold only
  meta tensors and never touch a card; the roofline is priced on
  gpu-h100. The other train_4k and prefill_32k cells take 5-16 s each
  here and run through the CLI (``--all``), not in this file.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild_model
from repro.optim import Optimizer as JOptimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train.train_state import abstract_train_state as jabstract_state
from repro_torch.configs import ALIASES, get_config, reduce_for_smoke
from repro_torch.core import rng as crng
from repro_torch.launch import dryrun, specs
from repro_torch.models import build_model
from repro_torch.models.convert import tree_from_flat
from repro_torch.optim import Optimizer, warmup_cosine
from repro_torch.parallel import sharding as sh
from repro_torch.roofline import report
from repro_torch.roofline.trace_cost import (collective_bytes,
                                             placement_collectives,
                                             traced_cost)
from repro_torch.train.steps import make_train_step
from repro_torch.train.train_state import (abstract_train_state,
                                           create_train_state)

ARCHS = list(ALIASES)


def jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in flat}


def port_shapes(cfg, flat):
    """The JAX layout of {name: tensor} (convert's stacking), as
    {keystr: (shape, dtype)}."""
    def leaf(x):
        if isinstance(x, list):
            return jax.ShapeDtypeStruct((len(x),) + tuple(x[0].shape),
                                        str(x[0].dtype).split(".")[-1])
        return jax.ShapeDtypeStruct(tuple(x.shape),
                                    str(x.dtype).split(".")[-1])
    return jax_shapes(tree_from_flat(cfg, flat, leaf=leaf))


def cache_shapes(model, caches):
    layout, flat = dryrun.cache_layout(model, caches)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list) and node and isinstance(node[0], str):
            t = flat[node[0]]
            return jax.ShapeDtypeStruct((len(node),) + tuple(t.shape),
                                        str(t.dtype).split(".")[-1])
        if isinstance(node, list):
            return [walk(v) for v in node]
        t = flat[node]
        return jax.ShapeDtypeStruct(tuple(t.shape),
                                    str(t.dtype).split(".")[-1])
    return jax_shapes(walk(layout))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_caches_and_inputs_match_jax(arch):
    cfg = get_config(arch)
    jm = jbuild_model(jget_config(arch))
    model = specs.abstract_params(cfg)
    params = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in params.values())
    assert port_shapes(cfg, params) == jax_shapes(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    # The CPU path builds the same shapes and dtypes (a narrow config).
    red = reduce_for_smoke(cfg)
    assert {k: (p.shape, p.dtype) for k, p in
            build_model(red, device="meta").named_parameters()} == \
        {k: (p.shape, p.dtype) for k, p in
         build_model(red, device="cpu").named_parameters()}
    p = specs.SHAPES["decode_32k"]
    caches = specs.abstract_caches(model, p["batch"], p["seq"])
    assert cache_shapes(model, caches) == jax_shapes(jspecs.abstract_caches(
        jm, jm.cfg, p["batch"], p["seq"]))
    for shape, sp in specs.SHAPES.items():
        got = specs.input_specs(arch, shape)
        want = jspecs.input_specs(arch, shape)
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "pos":            # a host int: the cache's last slot
                assert v.shape == () and v.dtype == jnp.int32
                assert got[k] == sp["seq"] - 1
                continue
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1]) \
                == (tuple(v.shape), str(v.dtype)), (shape, k)


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_abstract_train_state_matches_jax(arch):
    cfg = get_config(arch)
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(3e-4, 100, 10_000))
    batch = specs.input_specs(cfg, "train_4k")
    cpu_model = build_model(reduce_for_smoke(cfg), device="cpu")
    # A model that is not on meta is replaced by its meta twin.
    assert abstract_train_state(cpu_model, opt, crng.prng_key(0)
                                ).params is not cpu_model
    st = abstract_train_state(specs.abstract_params(cfg), opt,
                              crng.prng_key(0), example_batch=batch)
    jm = jbuild_model(jget_config(arch))
    jopt = JOptimizer(kind="adamw", lr_fn=jwarmup_cosine(3e-4, 100, 10_000))
    jst = jabstract_state(jm, jopt, jax.random.PRNGKey(0))
    want = jax_shapes(jst.params)
    assert port_shapes(cfg, dict(st.params.named_parameters())) == want
    assert port_shapes(cfg, st.opt_state.mu) == jax_shapes(jst.opt_state.mu)
    assert port_shapes(cfg, st.opt_state.nu) == jax_shapes(jst.opt_state.nu)
    count = st.opt_state.count
    assert (count.shape, count.dtype, count.device.type) == \
        ((), torch.int32, "meta")
    assert jst.opt_state.count.shape == () and \
        jst.opt_state.count.dtype == jnp.int32
    assert st.step == 0 and jst.step.dtype == jnp.int32
    assert st.rng.shape == tuple(jst.rng.shape) == (2,)
    assert st.rng.dtype == np.uint32 and jst.rng.dtype == jnp.uint32
    for f in ("m", "step", "sign"):
        t, j = getattr(st.qclip.sketch, f), getattr(jst.qclip.sketch, f)
        assert (tuple(t.shape), t.device.type) == (tuple(j.shape), "meta")
    assert st.qclip.warmup == 0 and jst.monitors is None
    # The port's monitors: meta planes, one group a (decoder) layer.
    groups = cfg.dec_layers if cfg.is_encdec else cfg.num_layers
    assert st.monitors.n_act_groups == groups
    assert all(t.device.type == "meta" for t in sh.leaves(st.monitors))


def reduced_overrides(arch):
    cfg = get_config(arch)
    red = reduce_for_smoke(cfg)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
            if getattr(red, f.name) != getattr(cfg, f.name)}


def cpu_twin(kind, args, gen):
    """``build_cell``'s meta args as real CPU tensors (random weights,
    random token ids, zero caches)."""
    if kind == "train":
        state, batch = args
        model = build_model(state.params.cfg, device="cpu", generator=gen)
        vocab = model.cfg.vocab_size
        batch = {k: (torch.randint(0, vocab, v.shape, generator=gen,
                                   dtype=v.dtype) if v.dtype == torch.int32
                     else torch.randn(v.shape, generator=gen,
                                      dtype=v.dtype))
                 for k, v in batch.items()}
        opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(3e-4, 100, 10_000))
        return make_train_step(model, opt), (create_train_state(
            model, opt, crng.prng_key(0), example_batch=batch), batch)
    model = build_model(args[0].cfg, device="cpu", generator=gen)
    b = args[1].shape[0]
    caches = [{k: torch.zeros(t.shape, dtype=t.dtype) for k, t in c.items()}
              for c in args[2]]
    rest = (torch.zeros((b, 1), dtype=torch.int32), caches, args[3])
    if len(args) == 5:
        rest += (torch.randn(args[4].shape, generator=gen,
                             dtype=torch.float32).to(args[4].dtype),)
    return (lambda m, *r: m.decode_step(*r)), (model,) + rest


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v2-lite-16b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_flops_on_meta_equal_flops_on_cpu(arch, kind):
    shape = {"seq": 16, "batch": 2, "kind": kind}
    fn, args, _ = specs.build_cell(arch, shape, reduced_overrides(arch))
    meta = traced_cost(fn, *args)
    cpu_fn, cpu_args = cpu_twin(kind, args, torch.Generator().manual_seed(0))
    cpu = traced_cost(cpu_fn, *cpu_args)
    assert meta["flops"] > 0
    assert meta["flops"] == cpu["flops"] and meta["by_op"] == cpu["by_op"]


def test_placement_collectives_and_wire_rule():
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as sh

    recs = [("all-reduce", 100, 100), ("all-gather", 64, 4),
            ("reduce-scatter", 4, 64), ("all-to-all", 16, 16)]
    total, by_op, counts = collective_bytes(recs)
    assert by_op == {"all-reduce": 200, "all-gather": 64,
                     "reduce-scatter": 64, "all-to-all": 16}
    assert total == 344 and counts == dict.fromkeys(by_op, 1)
    mesh = make_production_mesh()
    fsdp = sh.Sharding(mesh, sh.P("data", "model"))   # [1024, 512] wo
    owned = sh.Sharding(mesh, sh.P(None, "model"), layer=(3, 32),
                        layer_axes=("data",))
    rep = sh.replicated(mesh)
    leaves = [("layers.0.attn.wo", (1024, 512), 4, fsdp, 1, 8, 2),
              ("layers.3.attn.wq", (512, 1024), 4, owned, 1, 8, 2),
              ("layers.0.norm1.scale", (512,), 4, rep, 2, 8, 2),
              ("enc_stack.0.attn.wo", (1024, 512), 4, fsdp, 0, 8, 2)]
    fwd = placement_collectives(leaves, "prefill")
    local = 1024 * 512 * 4 // 256
    assert fwd == [("all-gather", local * 16, local),
                   ("all-reduce", 8 * 512 * 2, 8 * 512 * 2),
                   ("all-gather", 512 * 1024 * 4 // 16,
                    512 * 1024 * 4 // 256)]
    train = placement_collectives(leaves, "train")
    assert [r[0] for r in train] == [
        "all-gather", "all-gather", "reduce-scatter", "all-reduce",
        "all-reduce", "all-gather", "all-gather", "reduce-scatter",
        "all-reduce"]
    assert train[-1] == ("all-reduce", 512 * 4, 512 * 4)


CELLS = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,shape", CELLS + [("yi-6b", "train_4k")])
def test_dry_run_cell_at_full_width(arch, shape):
    recs = dryrun.run_cells(arch, shape, ("single", "multi"))
    supported, _ = specs.cell_supported(arch, shape)
    assert not torch.cuda.is_initialized()
    for rec, n_dev in zip(recs, (256, 512)):
        assert rec["ok"], rec.get("traceback")
        if not supported:
            assert rec["skipped"] and shape == "long_500k"
            continue
        assert rec["mesh_info"]["n_devices"] == n_dev
        assert rec["roofline"]["hw"] == "gpu-h100"
        assert rec["device_flops"] == rec["flops_global"] / n_dev > 0
        res = rec["production"]["memory_analysis"]
        assert res["argument_size_in_bytes"] >= \
            res["argument_size_min_in_bytes"] > 0
        assert rec["device_bytes"] > 0 and rec["device_collective_bytes"] > 0
        assert rec["tokens_per_step"] == specs.SHAPES[shape]["batch"] * (
            1 if shape != "train_4k" else 4096)
        for k in ("model_flops", "n_params", "n_active_params", "total_s"):
            assert rec[k] > 0
        json.dumps(rec)
    if shape == "train_4k":
        ratio = recs[0]["model_flops"] / recs[0]["flops_global"]
        print(f"{arch} train_4k: model_flops / traced FLOPs = {ratio:.4f}")
        assert 0.5 < ratio < 1.0
    # one trace prices both meshes: per device halves on 512 devices
    if supported:
        assert recs[0]["flops_global"] == recs[1]["flops_global"]


def test_variants_change_what_they_name():
    """Each kind of variant through ``run_cell``: ``rwkv_factorized``
    prices the H1 decay tensors (``analytic_hbm_bytes``) and leaves the
    decode trace as it was; ``vocab_nofsdp`` keeps the tables off 'data',
    so the most loaded device holds more."""
    base, fact, novocab = (dryrun.run_cell("rwkv6-1.6b", "decode_32k",
                                           "single", variant=v)
                           for v in ("baseline", "rwkv_factorized",
                                     "vocab_nofsdp"))
    assert all(r["ok"] for r in (base, fact, novocab))
    assert fact["device_bytes"] < base["device_bytes"]
    assert fact["flops_global"] == base["flops_global"]

    def resident(rec):
        return rec["production"]["memory_analysis"]["argument_size_in_bytes"]
    assert resident(novocab) > resident(base) == resident(fact)
    assert novocab["device_bytes"] == base["device_bytes"]


def test_variants_are_the_jax_ones_the_port_reads(monkeypatch):
    """VARIANTS is the JAX package's table less the variants that set a
    field no port code reads (``seq_sharded_residual``); ``run_cells``
    refuses an unknown name and a variant with an unread key."""
    assert {k: v for k, v in jspecs.VARIANTS.items()
            if set(v) <= specs.VARIANT_KEYS} == specs.VARIANTS
    assert set(jspecs.VARIANTS) - set(specs.VARIANTS) == {
        "seq_residual", "h1_combo", "h2_combo", "h3_combo"}
    fields = {f.name for f in dataclasses.fields(get_config("yi-6b"))}
    assert specs.VARIANT_KEYS - fields == {"exclude_vocab_fsdp"}
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.run_cells("yi-6b", "decode_32k", variant="h2_combo")
    monkeypatch.setitem(specs.VARIANTS, "seq_residual",
                        jspecs.VARIANTS["seq_residual"])
    with pytest.raises(ValueError, match="no code of the port reads"):
        dryrun.run_cells("yi-6b", "decode_32k", variant="seq_residual")


def test_dryrun_cli_writes_a_record_and_the_report_reads_it(tmp_path,
                                                            capsys):
    dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    assert "[OK] rwkv6-1.6b decode_32k single" in capsys.readouterr().out
    cells = report.load_cells(str(tmp_path))
    assert sorted((c["arch"], c.get("skipped", False)) for c in cells) == [
        ("rwkv6-1.6b", False), ("yi-6b", True)]
    assert "rwkv6-1.6b | decode_32k" in report.roofline_table(cells)
    assert "SKIP" in report.dryrun_table(cells, "single")
