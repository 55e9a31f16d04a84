"""The port's sharding rules and meshes against the JAX package's
(``parallel/sharding.py``, ``launch/mesh.py``, ``launch/dryrun.py``'s
``build_shardings``).

* ``param_spec_tree`` through ``param_shardings`` on both production
  meshes, FSDP on and off, the vocab tables in and out of FSDP: for all
  ten archs at full width, each per-layer ``Sharding`` stacked back into
  the JAX layout equals the JAX package's spec on
  ``jax.eval_shape(model.init)`` leaf for leaf.
* Owner placement of stacked layers: each device's parameter bytes equal
  the JAX ``shard_shape`` bytes computed from the same specs.
* ``batch_spec_tree``, ``dp_axes`` and ``mesh_info`` on the port's meshes.
* The decode cell's cache, token and memory shardings and the train
  cell's state and batch shardings of every arch, against
  ``repro.launch.dryrun.build_shardings`` on the JAX package's real
  256/512-device meshes. That module sets ``XLA_FLAGS`` (512 host
  devices) when imported, so it runs in a subprocess.
* The dry run's record of one reduced yi-6b train cell (residency and
  per-device FLOPs) against the JAX package's compile of the same cell
  on a (2, 2) mesh of host devices, in the same subprocess.
* ``shard`` / ``unshard`` round trips on a (2, 2) mesh of ``"cpu"``.

The JAX train cell is built without monitors: ``repro.launch.specs.
build_cell`` fails to make them under ``eval_shape`` (a fault of the
reference, ROADMAP C); the port's are replicated, as are the JAX
package's when it has them.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.launch.mesh import mesh_info as jmesh_info
from repro.models import build_model as jbuild_model
from repro.parallel.sharding import batch_spec_tree as jbatch_spec_tree
from repro.parallel.sharding import dp_axes as jdp_axes
from repro.parallel.sharding import param_spec_tree as jparam_spec_tree
from repro_torch.configs import ALIASES, get_config, reduce_for_smoke
from repro_torch.core import rng as crng
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import (Mesh, _device_array,
                                     make_production_mesh, make_test_mesh,
                                     mesh_info)
from repro_torch.models import build_model
from repro_torch.optim import Optimizer, warmup_cosine
from repro_torch.parallel import sharding as sh
from repro_torch.roofline.trace_cost import traced_cost
from repro_torch.train.steps import make_train_step
from repro_torch.train.train_state import abstract_train_state

ARCHS = list(ALIASES)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}


def names(path):
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(f"[{k.idx}]")
        else:
            out.append(str(k))
    return tuple(out)


def jax_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {names(p): x for p, x in flat}


def is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def entry(e):
    """A spec entry in JSON form: None, a name, or a list of names."""
    return list(e) if isinstance(e, tuple) else e


def as_list(spec):
    return [entry(e) for e in spec]


def stacked_specs(layout, by_name):
    """{path: spec as list} of a JAX-layout tree of port names, each
    stacked leaf's per-layer Shardings joined back into one spec (they
    must agree)."""
    out = {}
    for path, leaf in sh.layout_leaves(layout):
        if isinstance(leaf, list):
            shs = [by_name[n] for n in leaf]
            assert all(tuple(s.spec) == tuple(shs[0].spec)
                       and s.layer_axes == shs[0].layer_axes
                       and s.layer == (i, len(leaf))
                       for i, s in enumerate(shs)), path
            axes = shs[0].layer_axes
            head = None if not axes else axes[0] if len(axes) == 1 \
                else list(axes)
            out[path] = [head] + as_list(shs[0].spec)
        else:
            out[path] = as_list(by_name[leaf].spec)
    return out


def padded(spec, ndim):
    return spec + [None] * (ndim - len(spec))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = jbuild_model(jget_config(arch))
        out[arch] = (jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                     build_model(get_config(arch), device="meta"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_jax_spec_trees(models, arch):
    jparams, model = models[arch]
    shapes = {k: v.shape for k, v in jax_leaves(jparams).items()}
    layout = sh.jax_layout(model)
    for mesh in MESHES.values():
        for fsdp in (True, False):
            for ev in (False, True):
                want = jax_leaves(jparam_spec_tree(
                    jparams, mesh.shape["model"],
                    mesh.shape["data"] if fsdp else 1, ev), is_leaf=is_spec)
                got = stacked_specs(layout, sh.param_shardings(
                    model, mesh, fsdp=fsdp, exclude_vocab_fsdp=ev))
                assert set(got) == set(want)
                for path, spec in want.items():
                    nd = len(shapes[path])
                    assert padded(got[path], nd) == padded(as_list(spec),
                                                           nd), (path, fsdp,
                                                                 ev)
                # param_spec_tree itself, in the JAX layout
                tree = sh.param_spec_tree(model, mesh.shape["model"],
                                          mesh.shape["data"] if fsdp else 1,
                                          ev)
                assert {p: padded(as_list(s), len(shapes[p]))
                        for p, s in sh.layout_leaves(tree)} == \
                    {p: padded(as_list(s), len(shapes[p]))
                     for p, s in want.items()}


@pytest.mark.parametrize("arch", ["yi-6b", "granite-20b",
                                  "deepseek-v2-lite-16b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_owner_placement_bytes_equal_jax_shard_shapes(models, arch):
    jparams, model = models[arch]
    shapes = {k: v.shape for k, v in jax_leaves(jparams).items()}
    for mesh in MESHES.values():
        specs = jax_leaves(jparam_spec_tree(jparams, mesh.shape["model"],
                                            mesh.shape["data"]),
                           is_leaf=is_spec)
        want = 0
        for path, spec in specs.items():
            split = [math.prod(mesh.shape[a] for a in sh.spec_axes(e))
                     for e in padded(as_list(spec), len(shapes[path]))]
            want += math.prod(n // k for n, k in zip(shapes[path], split)) * 4
        per_device = dryrun.residency_bytes(model,
                                            sh.param_shardings(model, mesh))
        assert per_device.shape == mesh.devices.shape
        assert int(per_device.max()) == int(per_device.min()) == want


def test_batch_specs_dp_axes_and_meshes_match_jax():
    for kind, mesh in MESHES.items():
        # The JAX functions read only ``mesh.shape`` and ``mesh.size``.
        assert sh.dp_axes(mesh) == jdp_axes(mesh)
        assert mesh_info(mesh) == jmesh_info(mesh) == {
            "axes": dict(mesh.shape), "n_devices": mesh.size,
            "multi_pod": kind == "multi"}
        for arch in ("qwen2-vl-2b", "whisper-large-v3", "yi-6b"):
            for shape in ("train_4k", "prefill_32k"):
                jb = jspecs.input_specs(arch, shape)
                want = {k: as_list(v)
                        for k, v in jbatch_spec_tree(jb, mesh).items()}
                got = {k: as_list(v) for k, v in sh.batch_spec_tree(
                    specs.input_specs(arch, shape), mesh).items()}
                assert got == want
    assert MESHES["single"].devices.shape == (16, 16)
    assert MESHES["multi"].axis_names == ("pod", "data", "model")
    assert {d.type for d in MESHES["multi"].devices.flat} == {"meta"}
    for n, shape in ((4, (1, 4)), (6, (3, 2)), (3, (3, 1)), (8, (2, 4))):
        m = make_test_mesh(n, device="cpu")
        assert m.devices.shape == shape and m.axis_names == ("data", "model")
    with pytest.raises(RuntimeError):
        make_production_mesh(devices=["cpu"] * 8)


JAX_CELLS = r"""
import json, sys
from repro.launch import dryrun as D
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh
from repro.configs import ALIASES
from repro.optim import Optimizer, warmup_cosine
from repro.train.train_state import abstract_train_state
import jax

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def named(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for p, x in flat:
        key = "/".join(str(k.key) if hasattr(k, "key") else f"[{k.idx}]"
                       if hasattr(k, "idx") else str(k) for k in p)
        out[key] = spec(x)
    return out

out = {}
for kind, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ALIASES:
        fn, args, _ = S.build_cell(arch, "decode_32k")
        dsh = D.build_shardings(mesh, "decode", args, None)
        model = S.build_model(S.get_config(arch))
        opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(3e-4, 100, 10_000))
        batch = S.input_specs(arch, "train_4k")
        state = abstract_train_state(model, opt, jax.random.PRNGKey(0))
        tsh, bsh = D.build_shardings(mesh, "train", (state, batch), None)
        out[f"{kind}/{arch}"] = {
            "caches": named(dsh[2]), "tokens": spec(dsh[1]),
            "pos": spec(dsh[3]),
            "memory": spec(dsh[4]) if len(dsh) == 5 else None,
            "mu": named(tsh.opt_state.mu), "nu": named(tsh.opt_state.nu),
            "params": named(tsh.params),
            "rest": [spec(x) for x in (tsh.opt_state.count, tsh.step,
                                       tsh.rng)]
                    + [spec(x) for x in jax.tree.leaves(tsh.qclip)],
            "batch": {k: spec(v) for k, v in bsh.items()}}
# One reduced yi-6b train cell (8 x 64, layers unrolled, attention in
# one chunk: XLA counts a loop body once) compiled on a (data 2, model 2)
# mesh of four host devices: what the port's dry run records for it.
import dataclasses
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import reduce_for_smoke
from repro.roofline.hlo_parse import collective_bytes
from repro.train.steps import make_train_step
cfg = dataclasses.replace(reduce_for_smoke(S.get_config("yi-6b")),
                          unroll_layers=True)
model = S.build_model(cfg)
opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(3e-4, 100, 10_000))
state = abstract_train_state(model, opt, jax.random.PRNGKey(0),
                             with_monitors=False)
batch = {k: jax.ShapeDtypeStruct((8, 64), jnp.int32)
         for k in ("tokens", "targets")}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
in_sh = D.build_shardings(mesh, "train", (state, batch), None)
with mesh:
    compiled = jax.jit(make_train_step(model, opt), in_shardings=in_sh,
                       donate_argnums=(0,)).lower(state, batch).compile()
cost = compiled.cost_analysis()
cost = cost[0] if isinstance(cost, list) else cost
out["tiny_train"] = {
    "flops": float(cost["flops"]),
    "argument_size_in_bytes":
        int(compiled.memory_analysis().argument_size_in_bytes),
    "collective_bytes": collective_bytes(compiled.as_text())[0]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_CELLS], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def slash(path):
    return "/".join(path)


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shardings_equal_jax_build_shardings(jax_cells, arch):
    _, args, _ = specs.build_cell(arch, "decode_32k")
    # train_4k: the port's state has its monitors
    _, (state, batch), _ = specs.build_cell(arch, "train_4k")
    assert state.monitors is not None
    for kind, mesh in MESHES.items():
        want = jax_cells[f"{kind}/{arch}"]
        dsh = dryrun.build_shardings(mesh, "decode", args)
        layout, _ = dryrun.cache_layout(args[0], args[2])
        by_name = {f"{i}.{k}": s for i, c in enumerate(dsh[2])
                   for k, s in c.items()}
        got = {slash(p): s for p, s in stacked_specs(layout,
                                                     by_name).items()}
        assert set(got) == set(want["caches"])
        for key, spec in want["caches"].items():
            nd = len(spec)
            assert padded(got[key], nd) == spec, (kind, key)
        assert as_list(dsh[1].spec) == want["tokens"] == []
        assert as_list(dsh[3].spec) == want["pos"] == []
        if want["memory"] is None:
            assert len(dsh) == 4
        else:
            assert as_list(dsh[4].spec) == want["memory"]
        tsh, bsh = dryrun.build_shardings(mesh, "train", (state, batch))
        jl = sh.jax_layout(state.params)
        for field in ("params", "mu", "nu"):
            by = tsh.params if field == "params" \
                else getattr(tsh.opt_state, field)
            got = {slash(p): s for p, s in stacked_specs(jl, by).items()}
            assert set(got) == set(want[field])
            for key, spec in want[field].items():
                assert padded(got[key], len(spec)) == spec, (field, key)
        rep = [tsh.opt_state.count, tsh.step, tsh.rng, tsh.qclip,
               tsh.monitors]
        assert all(isinstance(s, sh.Sharding) and as_list(s.spec) == []
                   for s in rep)
        assert all(s == [] for s in want["rest"])
        assert {k: as_list(v.spec) for k, v in bsh.items()} == want["batch"]


def test_dry_run_record_against_the_jax_compile(jax_cells):
    """The port's record of a reduced yi-6b train cell (``mesh_record``
    on its trace) against the JAX package's compile of the same cell on
    the same (2, 2) mesh, both without monitors (see above).

    Residency: the bytes of the most loaded device equal
    ``memory_analysis().argument_size_in_bytes`` but for 16 bytes the
    JAX state holds on the device and the port on the host (``step``
    and the clip's ``warmup``, int32 each, and the [2] uint32 key).
    FLOPs: the port's global count / 4 over XLA's per-device count was
    0.9653 when this test was written (XLA also counts elementwise
    FLOPs); held within [0.95, 1]. Collective bytes are a model
    (ROADMAP C): 0.2737 of XLA's on this cell, printed, not held."""
    want = jax_cells["tiny_train"]
    cfg = reduce_for_smoke(get_config("yi-6b"))
    model = build_model(cfg, device="meta")
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(3e-4, 100, 10_000))
    batch = {k: torch.empty((8, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    state = abstract_train_state(model, opt, crng.prng_key(0),
                                 example_batch=batch, with_monitors=False)
    cost = traced_cost(make_train_step(model, opt), state, batch)
    mesh = Mesh(_device_array([torch.device("meta")] * 4, (2, 2)),
                ("data", "model"))
    rec = dryrun.mesh_record(mesh, cfg, {"seq": 64, "batch": 8,
                                         "kind": "train"},
                             (state, batch), cost)
    res = rec["production"]["memory_analysis"]
    assert res["argument_size_in_bytes"] + 4 + 4 + 8 == \
        want["argument_size_in_bytes"]
    ratio = rec["device_flops"] / want["flops"]
    coll = rec["device_collective_bytes"] / want["collective_bytes"]
    print(f"device FLOPs / XLA's {ratio:.4f}; collective bytes / XLA's "
          f"{coll:.4f}")
    assert rec["device_flops"] == cost["flops"] / 4
    assert 0.95 <= ratio <= 1.0


def test_shard_and_unshard_round_trip_on_a_cpu_mesh():
    mesh = Mesh(_device_array(["cpu"] * 4, (2, 2)), ("data", "model"))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 6, 8), generator=gen)
    cases = [
        (sh.Sharding(mesh, sh.P(None, "model", "data")), (4, 3, 4)),
        (sh.Sharding(mesh, sh.P(("data", "model"))), (1, 6, 8)),
        (sh.Sharding(mesh, sh.P()), (4, 6, 8)),
        # layer 3 of 4 stacked over 'data': held by data index 1 only
        (sh.Sharding(mesh, sh.P(None, "model"), layer=(3, 4),
                     layer_axes=("data",)), (4, 3, 8)),
    ]
    for s, shard_shape in cases:
        shards = sh.shard(x, s)
        assert shards.shape == (2, 2)
        held = [c for c in np.ndindex(2, 2) if shards[c] is not None]
        if s.layer is not None:
            assert held == [(1, 0), (1, 1)]
            assert s.device_mask().tolist() == [[False, False], [True, True]]
        else:
            assert len(held) == 4
        assert all(tuple(shards[c].shape) == shard_shape for c in held)
        assert s.shard_shape(x.shape) == shard_shape
        assert torch.equal(sh.unshard(shards, s), x)
    # a one-name tuple is that name, as in JAX's PartitionSpec
    assert sh.P(("data",), None) == ("data", None)
    placed = sh.place({"a": x, "b": [x[0]]},
                      {"a": cases[0][0], "b": sh.replicated(mesh)})
    assert torch.equal(sh.unshard(placed["a"], cases[0][0]), x)
    assert torch.equal(placed["b"][0][1, 1], x[0])
