"""Logical-axis sharding rules (port of the JAX package's
``parallel/sharding.py``).

Meshes (``launch/mesh.py``):
  single-pod: (data=16, model=16)            — 256 devices
  multi-pod:  (pod=2, data=16, model=16)     — 512 devices

Rules (TP on 'model', DP on ('pod','data')), rule for rule the JAX
package's:
  embeddings / lm head [V, D]       -> ('model', None)   vocab-sharded
  learned positions   [L, D]        -> ('model', None)
  attn/mla q,k,v,up-projections     -> (..., 'model')    column-parallel
  attn/mla out, mlp down            -> ('model', ...)    row-parallel
  MoE expert tensors [E, ., .]      -> ('model', None, None)  EP
  router / norms / small vectors    -> replicated
  scan-stacked leaves               -> same rule shifted right by the layer dim
plus FSDP over 'data' (``_spec_for``). A dim is sharded only where its
axis size divides it.

The rules read the JAX package's layout: every stacked unit's leaves
carry a leading layer dim (``models/convert.py`` stacks the port's
per-layer parameters in shapes only), so ``param_spec_tree`` equals the
JAX package's leaf for leaf. ``param_shardings`` maps each spec back onto
the port's per-layer tensors. A stacked leaf whose layer dim the spec
splits is placed by **owner**: layer ``i`` of ``L`` lives whole (in its
other dims as the spec says) on the devices whose index along the layer
axes is ``i // (L / n)``, the same bytes per device as the JAX package's
``shard_shape`` of the stacked leaf.

A ``Sharding`` names a mesh and a ``PartitionSpec``; ``shard`` cuts a
tensor into a numpy object array of the mesh's shape (each entry the
shard on its device, None where a device holds no part of it) and
``unshard`` puts it back together.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.checkpoint import _map


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), an axis name, or a tuple of
    axis names (the dim split over their product, major to minor); a
    one-name tuple is that name, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1
            else tuple(p) if isinstance(p, list) else p for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------- rule table
# name -> rule: 'col': last dim on 'model'; 'row': first non-layer dim on
# 'model'; 'vocab': dim 0 on 'model'; 'expert' tensors are 'col' / 'row'
# leaves with three real dims; 'rep': replicated.
_RULES = [
    (r"^(table|pos_table)$", "vocab"),
    (r"^(wq|wk|wv|w_in|w_gate|ck|wr|wg|in_proj|wu_k|wu_v)$", "col"),
    (r"^(wo|w_out|out_proj|cv)$", "row"),
    (r"^(router|wd_kv|w_lora_a|w_lora_b|conv_w|A_log|D|dt_bias|w0|u)$", "rep"),
    (r"^(scale|bias|norm_scale|ln_scale|mix_.*|cmix_.*)$", "rep"),
]

def _leaf_rule(name: str) -> str:
    for pat, rule in _RULES:
        if re.match(pat, name):
            return rule
    return "rep"


def _spec_for(rule: str, ndim: int, shape, n_layer_dims: int,
              model_size: int, data_size: int = 1) -> PartitionSpec:
    """A PartitionSpec honouring divisibility.

    TP on 'model' per the rule table, plus FSDP/ZeRO sharding over
    'data': stacked leaves shard their LAYER dim over 'data' when it
    divides (each data index owns L/data layers and their optimizer
    state); otherwise the first unsharded dim that 'data' divides."""
    spec = [None] * ndim

    def ok(dim_idx, size):
        return shape[dim_idx] % size == 0 and shape[dim_idx] >= size

    if rule == "vocab":
        if ndim >= 2 and ok(0, model_size):
            spec[0] = "model"
    elif rule == "col":
        d = ndim - 1
        # expert tensors with 3 real dims: [E, D, F] -> shard E (EP) instead
        if ndim - n_layer_dims == 3:
            if ok(n_layer_dims, model_size):
                spec[n_layer_dims] = "model"
        elif ok(d, model_size):
            spec[d] = "model"
    elif rule == "row":
        d = n_layer_dims  # first real dim after stacked layer dims
        if ok(d, model_size):
            spec[d] = "model"
    # ---- FSDP over 'data' (params + optimizer state residency / data_size)
    if data_size > 1 and rule in ("vocab", "col", "row") and ndim >= 2:
        if n_layer_dims and spec[0] is None and ok(0, data_size):
            spec[0] = "data"                      # layer-dim ZeRO shard
        else:
            for d in range(n_layer_dims, ndim):   # first shardable free dim
                if spec[d] is None and ok(d, data_size):
                    spec[d] = "data"
                    break
    return PartitionSpec(*spec)


# ------------------------------------------------------- the JAX layout
def _is_leaf(x) -> bool:
    """A leaf of a JAX-layout tree: a spec, a list of per-layer leaves
    (one stacked leaf), or anything that is not a container."""
    if isinstance(x, PartitionSpec):
        return True
    if isinstance(x, list):
        return bool(x) and not isinstance(x[0], (Mapping, list))
    return not isinstance(x, (Mapping, tuple))


def layout_leaves(tree, path=()):
    """(path names, leaf) of a JAX-layout tree, dict keys in insertion
    order, list items as "[i]"."""
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from layout_leaves(v, path + (str(k),))
    else:
        for i, v in enumerate(tree):
            yield from layout_leaves(v, path + (f"[{i}]",))


def map_layout(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path names, leaf)``."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: map_layout(v, fn, path + (str(k),))
                for k, v in tree.items()}
    return [map_layout(v, fn, path + (f"[{i}]",))
            for i, v in enumerate(tree)]


def jax_layout(model, flat: Optional[Mapping[str, Any]] = None):
    """The JAX package's parameter tree of ``model`` with, at each leaf,
    the port's parameter name, or the list of per-layer names a stacked
    leaf holds in scan order (``flat``: another name -> value mapping
    to lay out instead of the names)."""
    from repro_torch.models.convert import tree_from_flat

    if flat is None:
        flat = {k: k for k, _ in model.named_parameters()}
    return tree_from_flat(model.cfg, flat, leaf=lambda x: x)


def _stacked_shape(leaf, shapes) -> Tuple[int, ...]:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(shapes[leaf[0]])
    return tuple(shapes[leaf])


def param_spec_tree(model, model_size: int, data_size: int = 1,
                    exclude_vocab_fsdp: bool = False):
    """PartitionSpec tree of ``model``'s parameters in the JAX package's
    layout (stacked leaves with their layer dim).

    exclude_vocab_fsdp (H2c of the JAX package): the embedding and
    unembedding tables keep their d_model dim off 'data', trading
    per-device residency for the data-axis collectives of the
    embed / unembed contractions."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}

    def spec(names, leaf):
        name = names[-1]
        in_stack = any(n in ("stack", "enc_stack", "dec_stack")
                       for n in names)
        n_layer_dims = 1 if in_stack else 0
        rule = _leaf_rule(name)
        ds = 1 if exclude_vocab_fsdp and rule == "vocab" else data_size
        shape = _stacked_shape(leaf, shapes)
        return _spec_for(rule, len(shape), shape, n_layer_dims, model_size,
                         ds)

    return map_layout(jax_layout(model), spec)


# -------------------------------------------------------------- shardings
@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """``spec`` over a tensor's own dims on ``mesh``; for one layer of a
    stacked leaf, ``layer`` = (i, L) and ``layer_axes`` the axes the
    stacked layer dim is split over (owner placement)."""

    mesh: Any
    spec: PartitionSpec
    layer: Optional[Tuple[int, int]] = None
    layer_axes: Tuple[str, ...] = ()

    def _split(self, axes) -> int:
        shape = self.mesh.shape
        return math.prod(shape[a] for a in axes)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return tuple(n // self._split(spec_axes(e))
                     for n, e in zip(shape, self._full_spec(len(shape))))

    def _full_spec(self, ndim):
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def _index(self, coords, axes) -> int:
        """The device's index along the product of ``axes``."""
        shape = self.mesh.shape
        pos = {a: i for i, a in enumerate(self.mesh.axis_names)}
        k = 0
        for a in axes:
            k = k * shape[a] + coords[pos[a]]
        return k

    def owner(self) -> Optional[int]:
        """The index along ``layer_axes`` that holds this layer."""
        if self.layer is None or not self.layer_axes:
            return None
        i, n_layers = self.layer
        return i // (n_layers // self._split(self.layer_axes))

    def holds(self, coords) -> bool:
        own = self.owner()
        return own is None or self._index(coords, self.layer_axes) == own

    def device_mask(self) -> np.ndarray:
        """Per device of the mesh, whether it holds a shard."""
        shape = self.mesh.devices.shape
        return np.array([self.holds(c) for c in np.ndindex(*shape)],
                        bool).reshape(shape)

    def shard_bytes(self, shape, itemsize: int) -> int:
        return math.prod(self.shard_shape(shape)) * itemsize


def param_shardings(model, mesh, fsdp: bool = True,
                    exclude_vocab_fsdp: bool = False
                    ) -> Dict[str, Sharding]:
    """{the port's parameter name: Sharding}: each JAX-layout spec on the
    port's tensors, a stacked leaf's per layer (owner placement where its
    layer dim is split)."""
    model_size = mesh.shape.get("model", 1)
    data_size = mesh.shape.get("data", 1) if fsdp else 1
    specs = param_spec_tree(model, model_size, data_size, exclude_vocab_fsdp)
    return stacked_shardings(mesh, jax_layout(model), specs)


def stacked_shardings(mesh, layout, specs) -> Dict[str, Sharding]:
    """A JAX-layout tree of port names (``layout``) and one of its specs
    -> {port name: Sharding}."""
    out: Dict[str, Sharding] = {}
    specs = dict(layout_leaves(specs))
    for path, leaf in layout_leaves(layout):
        spec = specs[path]
        if isinstance(leaf, list):
            for i, name in enumerate(leaf):
                out[name] = Sharding(mesh, PartitionSpec(*spec[1:]),
                                     layer=(i, len(leaf)),
                                     layer_axes=spec_axes(spec[0]))
        else:
            out[leaf] = Sharding(mesh, spec)
    return out


def replicated(mesh) -> Sharding:
    return Sharding(mesh, PartitionSpec())


# ------------------------------------------------------------------- batches
def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def batch_spec_tree(batch: Mapping[str, Any], mesh) -> Dict[str,
                                                             PartitionSpec]:
    """Leading (batch) dim over the data-parallel axes; scalars
    replicated."""
    dp = dp_axes(mesh)
    return {k: PartitionSpec() if _ndim(x) == 0
            else PartitionSpec(dp, *([None] * (_ndim(x) - 1)))
            for k, x in batch.items()}


def batch_shardings(batch: Mapping[str, Any], mesh) -> Dict[str, Sharding]:
    return {k: Sharding(mesh, s)
            for k, s in batch_spec_tree(batch, mesh).items()}


# --------------------------------------------------------------- placement
def _slices(sharding: Sharding, shape, coords):
    out = []
    for n, e in zip(shape, sharding._full_spec(len(shape))):
        axes = spec_axes(e)
        step = n // sharding._split(axes)
        k = sharding._index(coords, axes)
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def shard(tensor: torch.Tensor, sharding: Sharding) -> np.ndarray:
    """A numpy object array of the mesh's shape: each device's shard of
    ``tensor`` on that device (a view where the device is the tensor's
    own), None where the device holds none of it."""
    devices = sharding.mesh.devices
    out = np.empty(devices.shape, dtype=object)
    for coords in np.ndindex(*devices.shape):
        if sharding.holds(coords):
            part = tensor[_slices(sharding, tensor.shape, coords)]
            out[coords] = part.to(devices[coords])
    return out


def unshard(shards: np.ndarray, sharding: Sharding,
            device=None) -> torch.Tensor:
    """The whole tensor back from ``shard``'s array, on ``device`` (None:
    the first shard's)."""
    held = [(c, shards[c]) for c in np.ndindex(*shards.shape)
            if shards[c] is not None]
    first = held[0][1]
    shape = tuple(n * sharding._split(spec_axes(e)) for n, e in zip(
        first.shape, sharding._full_spec(first.dim())))
    out = torch.empty(shape, dtype=first.dtype,
                      device=first.device if device is None else device)
    for coords, part in held:
        out[_slices(sharding, shape, coords)] = part.to(out.device)
    return out


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def is_shards(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype == object


def leaves(tree, is_leaf=_is_tensor) -> list:
    """The leaves below ``tree`` that ``is_leaf`` picks, in
    ``checkpoint._map``'s order (a module stands for its parameters and
    buffers)."""
    out = []

    def visit(x):
        if is_leaf(x):
            out.append(x)
            return x
        if isinstance(x, torch.nn.Module):
            out.extend(t for t in (*x.parameters(), *x.buffers())
                       if is_leaf(t))
            return x
        return None

    _map(visit, tree)
    return out


def _by_sharding(fn, tree, shardings, is_leaf):
    """``fn(leaf, Sharding)`` over ``tree``, whose structure
    ``shardings`` follows down to a ``Sharding`` (which stands for every
    leaf below it)."""
    def visit(node, s):
        if isinstance(s, Sharding):
            return _map(lambda x: fn(x, s) if is_leaf(x) else None, node)
        return None

    return _map(visit, tree, shardings)


def place(tree, shardings):
    """``tree`` with each tensor replaced by ``shard(tensor, its
    Sharding)``: ``shardings`` has ``tree``'s structure down to a
    ``Sharding``, which places every tensor below it."""
    return _by_sharding(shard, tree, shardings, _is_tensor)


def unplace(tree, shardings, device=None):
    """The inverse of ``place``: each shard array whole again (on
    ``device``; None: its first shard's)."""
    return _by_sharding(lambda a, s: unshard(a, s, device), tree, shardings,
                        is_shards)


__all__ = [
    "PartitionSpec",
    "Sharding",
    "batch_shardings",
    "batch_spec_tree",
    "dp_axes",
    "is_shards",
    "jax_layout",
    "layout_leaves",
    "leaves",
    "map_layout",
    "param_shardings",
    "param_spec_tree",
    "place",
    "replicated",
    "shard",
    "spec_axes",
    "stacked_shardings",
    "unplace",
    "unshard",
]
