"""Weights carried across from the JAX package.

``params_from_numpy(cfg, tree)`` takes the JAX package's ``CausalLM``
parameter pytree with numpy leaves (``jax.tree.map(np.asarray, params)``)
and returns the port's ``CausalLM`` computing what the JAX model computes:
each stacked unit of ``stack`` (a leading ``n_units`` axis per unit kind)
becomes one layer module, in the order the JAX scan runs them. zamba2's
``shared_block`` is one module, run at each ``{}`` placeholder of
``stack``; both directions keep it once, under that key.

An encoder-decoder's tree (``EncDecLM``) has no ``stack``: its
``enc_stack`` and ``dec_stack`` are single dicts whose leaves carry a
leading [n_layers] axis (a ``vmap`` over layers), and each layer becomes
one module of the port's ``enc_stack`` / ``dec_stack``, named
``enc_stack.<i>.*`` / ``dec_stack.<i>.*``.

``train_state_from_numpy(cfg, tree)`` does the same for a whole
``TrainState`` (parameters, moments, step, key words, monitor fleets and
the clip sketch), and ``train_state_to_numpy(state)`` is its inverse into
the JAX package's stacked layout, which checkpoints store leaf for leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device

from .blocks import stage_unit_kinds
from .causal_lm import CausalLM
from .encdec import EncDecLM

TOP_LEVEL = ("embed", "final_norm", "lm_head", "pos", "shared_block")
ENCDEC_TOP_LEVEL = ("embed", "dec_pos", "enc_norm", "dec_norm")


def _layer_stacks(cfg) -> Dict[str, int]:
    """An encoder-decoder's layer-stacked keys and their layer counts."""
    return {"enc_stack": cfg.enc_layers, "dec_stack": cfg.dec_layers}


def _tensors(node, device, unit=None):
    """A nested dict of numpy leaves -> the same of tensors on ``device``
    (copies), taking index ``unit`` of each leaf's leading axis when
    given."""
    if isinstance(node, Mapping):
        return {k: _tensors(v, device, unit) for k, v in node.items()}
    a = np.asarray(node)
    return torch.from_numpy(np.array(a if unit is None else a[unit])).to(
        device)


def params_from_numpy(cfg, tree: Mapping, device=None):
    """The JAX package's parameter tree (numpy leaves) as a port model on
    ``device`` (None: the card; raises where there is none)."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        out = {k: _tensors(tree[k], dev) for k in ENCDEC_TOP_LEVEL}
        for k, n in _layer_stacks(cfg).items():
            out[k] = [_tensors(tree[k], dev, i) for i in range(n)]
        return EncDecLM(cfg, out)
    _, n_units, unit_kinds = stage_unit_kinds(cfg)
    out = {k: _tensors(tree[k], dev) for k in TOP_LEVEL if k in tree}
    out["layers"] = [_tensors(p, dev) for p in tree.get("prefix", [])]
    stack = tree.get("stack", [])
    out["layers"] += [_tensors(stack[j], dev, u) for u in range(n_units)
                      for j in range(len(unit_kinds))]
    return CausalLM(cfg, out)


# ------------------------------------------------------------ train state
class FleetState(NamedTuple):
    """A monitor fleet in the JAX package's pytree order: its lane sketch,
    then its cursor (the JAX ``QuantileFleet``'s data fields)."""
    state: Any
    cursor: Any


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on(x, device, dtype=None) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def flat_from_tree(cfg, tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX-layout parameter tree (numpy or tensor leaves) -> {the
    port's parameter name: leaf}, stacked units unstacked in scan
    order; the shared block's leaves once, as ``shared_block.*``; an
    encoder-decoder's stacks layer by layer, as ``enc_stack.<i>.*``."""
    _, n_units, unit_kinds = stage_unit_kinds(cfg)
    out: Dict[str, Any] = {}

    def put(prefix, node, unit=None):
        if isinstance(node, Mapping):
            for k, v in node.items():
                put(f"{prefix}.{k}", v, unit)
        else:
            out[prefix] = node if unit is None else node[unit]

    if cfg.is_encdec:
        stacks = _layer_stacks(cfg)
        for k, v in tree.items():
            if k in stacks:
                for i in range(stacks[k]):
                    put(f"{k}.{i}", v, i)
            else:
                put(k, v)
        return out

    for k in TOP_LEVEL:
        if k in tree:
            put(k, tree[k])
    layers = [(p, None) for p in tree.get("prefix", [])]
    stack = tree.get("stack", [])
    layers += [(stack[j], u) for u in range(n_units)
               for j in range(len(unit_kinds))]
    for i, (node, unit) in enumerate(layers):
        put(f"layers.{i}", node, unit)
    return out


def _stack_host(x) -> np.ndarray:
    """A leaf or a list of per-unit leaves -> one numpy array."""
    if isinstance(x, list):
        return np.stack([_host(u) for u in x])
    return _host(x)


def _stacked(units, leaf, path=()):
    """Per-unit trees of the same keys -> one tree whose leaves are
    ``leaf`` of the units' leaves in order."""
    node_u0 = units[0]
    for p in path:
        node_u0 = node_u0[p]
    if isinstance(node_u0, dict):
        return {k: _stacked(units, leaf, path + (k,)) for k in node_u0}
    per_unit = []
    for unit in units:
        x = unit
        for p in path:
            x = x[p]
        per_unit.append(x)
    return leaf(per_unit)


def tree_from_flat(cfg, flat: Mapping[str, Any], leaf=_stack_host) -> Dict:
    """{port parameter name: tensor} -> the JAX package's tree: each
    unit kind's layers (an encoder-decoder's: each stack's) stacked on a
    leading axis (``leaf`` maps a list of per-unit leaves, or one leaf,
    to the stored value)."""
    prefix_kinds, n_units, unit_kinds = stage_unit_kinds(cfg)
    n_prefix, n_kinds = len(prefix_kinds), len(unit_kinds)
    stacks = _layer_stacks(cfg) if cfg.is_encdec else {"layers": None}
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, Dict[int, Dict[str, Any]]] = {k: {}
                                                        for k in stacks}

    def insert(node, parts, value):
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for name, x in flat.items():
        parts = name.split(".")
        if parts[0] in stacks:
            insert(per_layer[parts[0]].setdefault(int(parts[1]), {}),
                   parts[2:], x)
        else:
            insert(tree, parts, leaf(x))

    if cfg.is_encdec:
        for k, n in stacks.items():
            tree[k] = _stacked([per_layer[k][i] for i in range(n)], leaf)
        return tree
    layers = per_layer["layers"]

    def mapped(node, fn):
        if isinstance(node, dict):
            return {k: mapped(v, fn) for k, v in node.items()}
        return fn(node)

    tree["prefix"] = [mapped(layers[i], leaf) for i in range(n_prefix)]
    stack = []
    for j in range(n_kinds):
        # A shared kind has no layers.* names: its placeholder is {}.
        units = [layers.get(n_prefix + u * n_kinds + j, {})
                 for u in range(n_units)]
        stack.append(_stacked(units, leaf) if units else {})
    tree["stack"] = stack
    return tree


def _stack_spec(x):
    from repro_torch.train.checkpoint import LeafSpec

    if isinstance(x, list):
        return LeafSpec((len(x),) + tuple(x[0].shape), np.float32)
    return LeafSpec(tuple(x.shape), np.float32)


def _fleet_from(node, quantile: float, seed: int, device):
    """A port monitor fleet at a JAX-layout fleet's state (a JAX
    ``QuantileFleet`` with numpy leaves, or a ``FleetState``)."""
    from repro_torch.api.spec import StreamCursor
    from repro_torch.monitor.registry import make_fleet

    if node is None:
        return None
    sk = node.state
    fleet = make_fleet(int(np.shape(sk.m)[0]), quantile, seed, device=device)
    planes = tuple(_on(getattr(sk, f), device, torch.float32)
                   for f in ("m", "step", "sign"))
    seed_, t_off, g_off = (int(_host(x)) for x in node.cursor)
    return dataclasses.replace(
        fleet, state=fleet.state.with_planes(planes),
        cursor=StreamCursor.create(seed=seed_, t_offset=t_off,
                                   g_offset=g_off))


def _fleet_to(fleet) -> Optional[FleetState]:
    if fleet is None:
        return None
    st = fleet.checkpoint_state()
    return FleetState(state=st["sketch"], cursor=st["cursor"])


def train_state_from_numpy(cfg, tree, device=None, model=None):
    """The JAX package's ``TrainState`` (``jax.tree.map(np.asarray,
    state)``: numpy leaves, its monitors' fleets and clip sketch as JAX
    objects) as the port's, on ``device`` (None: the card). Fields are
    read by name: params through ``params_from_numpy`` (or copied into
    ``model``'s tensors in place, which also takes tensor leaves: a
    restored checkpoint); mu and nu unstacked in the same scan order;
    step, the key words, the fleets' planes and cursors, the clip sketch
    and its warmup."""
    from repro_torch.core.frugal import Frugal2UState
    from repro_torch.monitor.registry import (SEED_ABSMAX, SEED_MOE,
                                              SEED_RMS, TrainMonitors)
    from repro_torch.optim import AdamWState, LionState
    from repro_torch.optim.clipping import QuantileClipState
    from repro_torch.train.train_state import TrainState

    dev = resolve_device(device)
    if model is None:
        model = params_from_numpy(cfg, tree.params, dev)
    else:
        with torch.no_grad():
            params = dict(model.named_parameters())
            for k, x in flat_from_tree(cfg, tree.params).items():
                params[k].copy_(_on(x, dev, params[k].dtype))

    def moments(t):
        return {k: _on(x, dev, torch.float32)
                for k, x in flat_from_tree(cfg, t).items()}

    opt = tree.opt_state
    count = _on(opt.count, dev, torch.int32).reshape(())
    if hasattr(opt, "nu"):
        opt_state = AdamWState(mu=moments(opt.mu), nu=moments(opt.nu),
                               count=count)
    else:
        opt_state = LionState(mu=moments(opt.mu), count=count)
    monitors = None
    if tree.monitors is not None:
        mon = tree.monitors
        monitors = TrainMonitors(
            act_absmax_q99=_fleet_from(mon.act_absmax_q99, 0.99,
                                       SEED_ABSMAX, dev),
            act_rms_q50=_fleet_from(mon.act_rms_q50, 0.5, SEED_RMS, dev),
            expert_load_q99=_fleet_from(mon.expert_load_q99, 0.99,
                                        SEED_MOE, dev),
            n_act_groups=int(_host(mon.n_act_groups)),
            n_moe_groups=int(_host(mon.n_moe_groups)))
    qclip = None
    if tree.qclip is not None:
        sk = tree.qclip.sketch
        qclip = QuantileClipState(
            sketch=Frugal2UState(*(_on(x, dev, torch.float32)
                                   for x in (sk.m, sk.step, sk.sign))),
            warmup=int(_host(tree.qclip.warmup)))
    return TrainState(params=model, opt_state=opt_state,
                      step=int(_host(tree.step)),
                      rng=np.asarray(_host(tree.rng), np.uint32).reshape(2),
                      monitors=monitors, qclip=qclip)


def train_state_to_numpy(state, shapes_only: bool = False):
    """The inverse: a port ``TrainState`` in the JAX package's layout and
    leaf types (stacked float32 parameters and moments, 0-d int32 count,
    step, warmup and group counts, [2] uint32 key words; fleets as
    ``FleetState`` (lane sketch, cursor), the clip sketch a
    ``Frugal2UState``), flattening to the JAX package's checkpoint leaves
    in order. ``shapes_only`` puts a ``LeafSpec`` in place of each
    parameter and moment (a restore template, no copies)."""
    from repro_torch.monitor.registry import TrainMonitors
    from repro_torch.optim.clipping import QuantileClipState
    from repro_torch.train.train_state import TrainState

    cfg = state.params.cfg
    leaf = _stack_spec if shapes_only else _stack_host
    i32 = lambda x: np.asarray(int(x), np.int32)     # noqa: E731
    params = tree_from_flat(cfg, dict(state.params.named_parameters()),
                            leaf)
    opt = state.opt_state
    moments = {f: tree_from_flat(cfg, getattr(opt, f), leaf)
               for f in opt._fields if f != "count"}
    opt_tree = type(opt)(**moments, count=i32(_host(opt.count)))
    mon = state.monitors
    if mon is not None:
        mon = TrainMonitors(
            act_absmax_q99=_fleet_to(mon.act_absmax_q99),
            act_rms_q50=_fleet_to(mon.act_rms_q50),
            expert_load_q99=_fleet_to(mon.expert_load_q99),
            n_act_groups=i32(mon.n_act_groups),
            n_moe_groups=i32(mon.n_moe_groups))
    qclip = state.qclip
    if qclip is not None:
        qclip = QuantileClipState(sketch=qclip.sketch,
                                  warmup=i32(qclip.warmup))
    return TrainState(params=params, opt_state=opt_tree,
                      step=i32(state.step),
                      rng=np.asarray(state.rng, np.uint32).reshape(2),
                      monitors=mon, qclip=qclip)
