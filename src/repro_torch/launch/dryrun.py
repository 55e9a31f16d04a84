"""Dry run: price every (arch × shape) cell on the 256/512-device
production mesh without allocating (port of the JAX package's
``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape decode_32k [--mesh single|multi] [--variant NAME]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Each cell builds its step on ``meta`` tensors (``launch/specs.py``) and
runs it once under the FLOP counter (``roofline/trace_cost.py``): nothing
is stored on the card or the host. It records, per device of the mesh:

  device_flops              the traced global FLOPs / mesh size (XLA
                            reports a partitioned module's own count)
  production.memory_analysis.argument_size_in_bytes
                            the bytes of every argument the most loaded
                            device holds under the shardings
                            (``build_shardings``)
  device_bytes              ``analytic_hbm_bytes``, the HBM traffic model
  device_collective_bytes   the wire bytes of the collectives the
                            placement implies (``placement_collectives``)
  roofline                  ``roofline_terms`` on ``gpu-h100``

and ``model_flops``, ``n_params``, ``n_active_params``,
``tokens_per_step`` and ``total_s``. ``--all`` runs one subprocess per
cell and writes ``<out>/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.parallel.sharding import (PartitionSpec, Sharding,
                                           batch_shardings, dp_axes, leaves,
                                           map_layout, param_shardings,
                                           replicated, stacked_shardings)
from repro_torch.roofline.analysis import (analytic_hbm_bytes, hw_for,
                                           model_flops, roofline_terms)
from repro_torch.roofline.trace_cost import (collective_bytes,
                                             placement_collectives,
                                             traced_cost)
from repro_torch.train.checkpoint import _map

CANON = {v: k for k, v in ALIASES.items()}
HW = "gpu-h100"
CELL_TIMEOUT_S = 900
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cache_sharding(mesh, shape) -> PartitionSpec:
    """Heuristic cache specs of a JAX-layout cache leaf's ``shape``:
    [.., B, L, H, D] KV caches: L over 'data' when batch can't shard,
    heads over 'model'; small recurrent states: heads over 'model'."""
    dp = dp_axes(mesh)
    data = mesh.shape.get("data", 1)
    model = mesh.shape.get("model", 1)
    dp_total = 1
    for a in dp:
        dp_total *= mesh.shape.get(a, 1)
    nd = len(shape)
    spec = [None] * nd
    # possible stacked leading dim (n_units): treat dims after it
    off = 1 if nd >= 5 else 0
    bdim = off
    if nd - off >= 2:
        if shape[bdim] % dp_total == 0 and shape[bdim] >= dp_total:
            spec[bdim] = dp
        elif nd - off >= 3 and shape[bdim + 1] % data == 0 \
                and shape[bdim + 1] >= 4096:
            spec[bdim + 1] = "data"     # seq-sharded long cache (SP decode)
        # heads/latent dim over model
        hdim = bdim + 2 if nd - off >= 4 else bdim + 1
        if hdim < nd and spec[hdim] is None and shape[hdim] % model == 0 \
                and shape[hdim] >= model:
            spec[hdim] = "model"
        elif (nd - off >= 4 and spec[bdim + 1] is None
              and shape[bdim + 1] % model == 0 and shape[bdim + 1] >= 4096):
            # heads unshardable (whisper kv=20, granite kv=1): shard cache
            # LENGTH over 'model' instead (sequence-parallel decode)
            spec[bdim + 1] = "model"
    return PartitionSpec(*spec)


def cache_layout(model, caches):
    """(JAX-layout tree of cache names, {name: tensor}): the port's
    per-layer caches stacked as the JAX package's ``init_cache`` stacks
    them (``prefix`` unstacked, ``stack`` per unit kind over units; an
    encoder-decoder's over decoder layers), names ``<layer>.<key>``."""
    from repro_torch.models.blocks import stage_unit_kinds

    flat = {f"{i}.{k}": t for i, c in enumerate(caches)
            for k, t in c.items()}
    keys = [list(c) for c in caches]
    if model.cfg.is_encdec:
        return {k: [f"{i}.{k}" for i in range(len(caches))]
                for k in keys[0]}, flat
    prefix, n_units, kinds = stage_unit_kinds(model.cfg)
    n_pre, n_kinds = len(prefix), len(kinds)
    tree = {"prefix": [{k: f"{i}.{k}" for k in keys[i]}
                       for i in range(n_pre)],
            "stack": []}
    for j in range(n_kinds):
        layers = [n_pre + u * n_kinds + j for u in range(n_units)]
        tree["stack"].append({k: [f"{i}.{k}" for i in layers]
                              for k in keys[layers[0]]})
    return tree, flat


def cache_shardings(mesh, model, caches) -> List[Dict[str, Sharding]]:
    """Per layer, {cache key: Sharding}: ``_cache_sharding`` of each
    JAX-layout leaf, a stacked leaf's layer dim by owner."""
    layout, flat = cache_layout(model, caches)

    def spec(path, leaf):
        shape = tuple(flat[leaf[0] if isinstance(leaf, list) else leaf].shape)
        if isinstance(leaf, list):
            shape = (len(leaf),) + shape
        return _cache_sharding(mesh, shape)

    by_name = stacked_shardings(mesh, layout, map_layout(layout, spec))
    return [{k: by_name[f"{i}.{k}"] for k in c}
            for i, c in enumerate(caches)]


def build_shardings(mesh, kind, args, exclude_vocab_fsdp=False):
    """Shardings matching ``build_cell``'s abstract args: a ``Sharding``
    for each tensor (one ``Sharding`` stands for every tensor below it,
    as for the monitors), {name: Sharding} for a model's parameters."""
    ev = exclude_vocab_fsdp
    rep = replicated(mesh)
    if kind == "train":
        from repro_torch.optim.optimizer import AdamWState

        state, batch = args
        p_sh = param_shardings(state.params, mesh, exclude_vocab_fsdp=ev)
        opt_sh = AdamWState(mu=p_sh, nu=p_sh, count=rep)
        state_sh = type(state)(
            params=p_sh, opt_state=opt_sh, step=rep, rng=rep,
            monitors=rep if state.monitors is not None else None,
            qclip=rep if state.qclip is not None else None)
        return (state_sh, batch_shardings(batch, mesh))
    model = args[0]
    p_sh = param_shardings(model, mesh, exclude_vocab_fsdp=ev)
    if kind == "prefill":
        return (p_sh, batch_shardings(args[1], mesh))
    # decode: [B, 1] tokens are tiny; replicating avoids 1-wide dp shards
    out = [p_sh, rep, cache_shardings(mesh, model, args[2]), rep]
    if len(args) == 5:   # encdec memory
        out.append(batch_shardings({"m": args[4]}, mesh)["m"])
    return tuple(out)


def residency_bytes(args, shardings) -> np.ndarray:
    """Per device of the mesh (its shape), the bytes of ``args`` it holds
    under ``shardings`` (``build_shardings``' structure: a ``Sharding``
    for every tensor below it, {name: Sharding} for a model)."""
    parts = []

    def add(t, sh):
        parts.append(sh.device_mask() * sh.shard_bytes(t.shape,
                                                       t.element_size()))

    def visit(node, sh):
        if isinstance(sh, Sharding):
            for t in leaves(node):
                add(t, sh)
            return node
        if isinstance(node, nn.Module):
            for name, p in node.named_parameters():
                add(p, sh[name])
            return node
        return None

    _map(visit, args, shardings)
    return sum(parts)


def _uses_and_rows(model, kind, batch, seq):
    """(uses(name), rows(name)) of a step: the times it runs a parameter
    tensor and the rows of that tensor's output, summed over the batch
    (an encoder-decoder's encoder runs on ``seq`` frames, its decoder on
    DEC_TOKENS or, decoding, one token; a decode cell runs no
    encoder)."""
    cfg = model.cfg
    dec = 1 if kind == "decode" else seq
    if cfg.is_encdec:
        dec = 1 if kind == "decode" else specs_lib.DEC_TOKENS
    shared = sum(layer is model.shared_block for layer in model.layers) \
        if getattr(model, "shared_block", None) is not None else 0

    def is_encoder(name):
        return name.startswith(("enc_stack.", "enc_norm."))

    def uses(name):
        if cfg.is_encdec and is_encoder(name):
            return 0 if kind == "decode" else 1
        return shared if name.startswith("shared_block.") else 1

    def rows(name):
        return batch * (seq if cfg.is_encdec and is_encoder(name) else dec)
    return uses, rows


def step_collectives(mesh, kind, model, p_sh, batch, seq):
    """The placement's collective records of one step (trace_cost)."""
    dp_total = 1
    for a in dp_axes(mesh):
        dp_total *= mesh.shape.get(a, 1)
    act_bytes = torch.empty((), dtype=getattr(torch, model.cfg.dtype),
                            device="meta").element_size()
    uses, rows = _uses_and_rows(model, kind, batch, seq)
    split = dp_total if batch % dp_total == 0 else 1
    leaves = [(n, tuple(p.shape), p.element_size(), p_sh[n], uses(n),
               rows(n) // split, act_bytes)
              for n, p in model.named_parameters()]
    return placement_collectives(leaves, kind)


def mesh_record(mesh, cfg, cell, args, cost, exclude_vocab_fsdp=False,
                cfg_v=None) -> dict:
    """The record of a traced cell on ``mesh``: ``cell`` its SHAPES entry
    (batch, seq, kind), ``args`` its abstract args, ``cost`` the
    ``traced_cost`` of its step on them. ``cfg_v`` (default ``cfg``), the
    config with a variant's overrides, prices the HBM bytes; ``cfg`` the
    model FLOPs and parameter counts, as in the JAX package."""
    cfg_v = cfg if cfg_v is None else cfg_v
    kind, batch, seq = cell["kind"], cell["batch"], cell["seq"]
    in_sh = build_shardings(mesh, kind, args,
                            exclude_vocab_fsdp=exclude_vocab_fsdp)
    resident = residency_bytes(args, in_sh)
    model = args[0].params if kind == "train" else args[0]
    p_sh = in_sh[0].params if kind == "train" else in_sh[0]
    coll, coll_by_op, coll_counts = collective_bytes(
        step_collectives(mesh, kind, model, p_sh, batch, seq))
    model_size = mesh.shape.get("model", 1)
    dev_bytes = analytic_hbm_bytes(cfg_v, kind, batch, seq,
                                   dp=mesh.size // model_size,
                                   model=model_size)
    dev_flops = cost["flops"] / mesh.size
    tokens = batch * (1 if kind == "decode" else seq)
    mf = model_flops(cfg, tokens, kind)
    return {
        "mesh_info": mesh_info(mesh),
        "production": {
            "memory_analysis": {
                "argument_size_in_bytes": int(resident.max()),
                "argument_size_min_in_bytes": int(resident.min())},
            "collective_bytes": coll,
            "collective_by_op": coll_by_op,
            "collective_counts": coll_counts,
        },
        "flops_global": cost["flops"], "flops_by_op": cost["by_op"],
        "device_flops": dev_flops, "device_bytes": dev_bytes,
        "device_collective_bytes": coll, "collective_by_op": coll_by_op,
        "model_flops": mf,
        "roofline": roofline_terms(dev_flops, dev_bytes, coll,
                                   hw=hw_for(HW), model_flops_global=mf,
                                   n_chips=mesh.size),
        "tokens_per_step": tokens, "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params()}


def run_cells(arch: str, shape: str, mesh_kinds=("single",),
              variant: str = "baseline") -> List[dict]:
    """One record per mesh of ``mesh_kinds`` ("single", "multi") for the
    cell (arch, shape, variant), from one trace of its step. A variant
    that ``specs.VARIANTS`` does not name raises ValueError."""
    t0 = time.time()
    arch_canon = CANON.get(arch, arch)
    ov, exclude_vocab = specs_lib.variant_overrides(variant)
    recs = [{"arch": arch_canon, "shape": shape, "mesh": m,
             "variant": variant, "ok": False} for m in mesh_kinds]
    supported, why = specs_lib.cell_supported(arch_canon, shape)
    if not supported:
        for rec in recs:
            rec.update(skipped=True, reason=why, ok=True)
        return recs
    try:
        cfg = get_config(arch_canon)
        cfg_v = dataclasses.replace(cfg, **ov) if ov else cfg
        cell = specs_lib.SHAPES[shape]
        fn, args, _ = specs_lib.build_cell(arch_canon, shape, ov or None)
        if any(t.device.type != "meta" for t in leaves(args)):
            raise RuntimeError("a dry-run argument holds storage")
        t1 = time.time()
        cost = traced_cost(fn, *args)
        trace_s = time.time() - t1
        for rec in recs:
            mesh = make_production_mesh(multi_pod=(rec["mesh"] == "multi"))
            rec.update(mesh_record(mesh, cfg, cell, args, cost,
                                   exclude_vocab_fsdp=exclude_vocab,
                                   cfg_v=cfg_v), ok=True)
            rec["production"]["trace_s"] = round(trace_s, 2)
    except Exception as e:   # the records report the failure
        for rec in recs:
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    for rec in recs:
        rec["total_s"] = round(time.time() - t0, 2)
    return recs


def run_cell(arch: str, shape: str, mesh_kind: str,
             variant: str = "baseline") -> dict:
    return run_cells(arch, shape, (mesh_kind,), variant)[0]


def _cell_file(out, arch, shape, mesh, variant="baseline") -> str:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(out, f"{arch}__{shape}__{mesh}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(specs_lib.SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline",
                    choices=list(specs_lib.VARIANTS))
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch, shape, mesh) in subprocesses")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    if args.all:
        for a in ARCH_IDS:
            for s in specs_lib.SHAPES:
                for m in ("single", "multi"):
                    fname = _cell_file(args.out, a, s, m)
                    if os.path.exists(fname) and not args.force:
                        print(f"skip (exists): {fname}")
                        continue
                    print(f"=== {a} {s} {m}", flush=True)
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", a, "--shape", s, "--mesh", m,
                           "--out", args.out]
                    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                        filter(None, [SRC, os.environ.get("PYTHONPATH")])))
                    r = subprocess.run(cmd, env=env, capture_output=True,
                                       text=True, timeout=CELL_TIMEOUT_S)
                    if r.returncode != 0:
                        rec = {"arch": CANON.get(a, a), "shape": s,
                               "mesh": m, "ok": False,
                               "error": f"subprocess rc={r.returncode}",
                               "stderr": r.stderr[-3000:]}
                        with open(fname, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"    FAILED rc={r.returncode}", flush=True)
                    else:
                        print("    done", flush=True)
        return

    rec = run_cell(args.arch, args.shape, args.mesh, variant=args.variant)
    with open(_cell_file(args.out, args.arch, args.shape, args.mesh,
                         args.variant), "w") as f:
        json.dump(rec, f, indent=1)
    status = "SKIP" if rec.get("skipped") else (
        "OK" if rec.get("ok") else "FAIL")
    print(f"[{status}] {args.arch} {args.shape} {args.mesh} "
          f"({rec.get('total_s', 0)}s)")
    if not rec.get("ok"):
        print(rec.get("error", ""))
        print(rec.get("traceback", "")[-2000:])
        sys.exit(1)
    if "roofline" in rec:
        t = rec["roofline"]
        print(json.dumps({k: t[k] for k in
                          ("compute_s", "memory_s", "collective_s", "bound")},
                         indent=1))


if __name__ == "__main__":
    main()
