"""Fault-tolerant checkpoints: atomic, checksummed, keep-k, self-verifying.

Port of the JAX package's ``train/checkpoint.py``, in the same on-disk
format leaf for leaf, so a checkpoint written by either package restores
in the other. Layout (one directory per step):

    <dir>/step_000042/
        manifest.json      — step, structure, leaf shapes and dtypes,
                             per-leaf CRC32s (format 4), writer topology
        shard_0.npz        — the leaves, ``leaf_<i>`` in flattening order
    <dir>/step_000042.COMMITTED   — empty marker, written last
    <dir>/step_000041.corrupt/    — a step that failed verification

Write protocol: the leaves and the manifest go into ``step_X.tmp/``, each
file fsync'd, the directory is renamed to ``step_X/``, and the COMMITTED
marker is written and fsync'd last. Readers only consider steps with a
marker, so a kill at any point never exposes a torn step. Restore checks
every leaf against its manifest CRC32 (format 4); a committed step that
fails is quarantined (marker removed, directory renamed ``*.corrupt``) and
restore falls back to the newest step that verifies. Formats 2 and 3 carry
no CRCs and still restore. A template that disagrees with the stored leaf
count or kind (float against integer) raises a plain ValueError and leaves
the step alone. The port places a fleet on one device, so a step holds one
shard.

Flattening follows JAX's pytree order, which the on-disk format depends
on: dict keys sorted, NamedTuples and tuples in field order, ``None``
dropped. A ``GroupedQuantileSketch`` is stored packed, as
``(m, step_sign, quantile, m2, step_sign2)`` (1-2 words per lane and the
per-lane target), and a ``Frugal2UState`` as ``(m, step_sign)``. Leaves are
written as numpy arrays of their own dtype: the fleets pass cursor fields
as 0-d int32 arrays, planes as float32, packed words as int32, so the
CRC32s equal the JAX package's for the same state.

A training run's ``TrainState`` is stored in the JAX package's layout
(``save_train_state`` / ``restore_train_state``, through
``models.convert.train_state_to_numpy``): each unit kind's layers stacked
on a leading axis as the JAX scan holds them, the moments likewise, each
monitor fleet as (packed lane sketch, cursor), so a training checkpoint
crosses between the packages both ways.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device
from repro_torch.core.frugal import Frugal2UState
from repro_torch.core.packing import (PackedFrugal2UState, pack_frugal2u,
                                      unpack_frugal2u)
from repro_torch.core.sketch import GroupedQuantileSketch, PackedSketchState
from repro_torch.resilience import chaos

__all__ = ["CheckpointCorruptError", "LeafSpec", "save_checkpoint",
           "restore_checkpoint", "committed_steps", "latest_step",
           "read_manifest", "save_train_state", "restore_train_state"]


_SHARD = "shard_0.npz"     # one writer: the port places a fleet on one device


class CheckpointCorruptError(ValueError):
    """A committed checkpoint step failed integrity verification (unreadable
    manifest or shard, CRC mismatch, missing leaf). Distinct from template
    mismatches (plain ValueError): corruption triggers quarantine and
    fallback; a wrong template never destroys a good checkpoint."""


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A shape-only leaf of a restore template (no allocation): restore
    reads the dtype it casts to; the stored shape wins."""

    shape: Tuple[int, ...]
    dtype: Any          # numpy dtype or its name


class _PackedSketchNode(NamedTuple):
    """On-disk form of a GroupedQuantileSketch node, a type of its own so
    restore knows the packer made it (a PackedSketchState in a user tree
    passes through untouched). Drift-free sketches keep both shadow
    fields None (no leaves)."""

    m: object
    step_sign: object
    quantile: object
    m2: object = None
    step_sign2: object = None


def _leaf_crc32(arr) -> int:
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _map(fn, tree, *rest):
    """Replace every node that ``fn(node, *nodes of rest)`` claims (returns
    not None for); recurse through dicts and sequences of ``tree`` and the
    same-shaped ``rest`` (NamedTuples keep their type)."""
    out = fn(tree, *rest)
    if out is not None:
        return out
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        parts = [_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return tree


def _flatten(tree):
    """Leaves in JAX's pytree order: dict keys sorted, sequences in order,
    None dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(x, leaves) for x in like])
    if isinstance(like, (tuple, list)):
        return type(like)([_unflatten(x, leaves) for x in like])
    return next(leaves)


def _treedef(tree) -> str:
    """Informational structure string for the manifest, spelled as JAX
    prints a PyTreeDef (no reader checks it)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    inner = ", ".join(_treedef(x) for x in tree) \
        if isinstance(tree, (tuple, list)) else ""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, tuple):
        return f"({inner}{',' if len(tree) == 1 else ''})"
    if isinstance(tree, list):
        return f"[{inner}]"
    return "*"


def _pack_sketches(tree):
    """Sketch nodes serialize packed: a Frugal2UState to two words per
    lane, a GroupedQuantileSketch to its ``packed()`` payload."""
    def pack(x):
        if isinstance(x, Frugal2UState):
            return pack_frugal2u(Frugal2UState(*(torch.as_tensor(p)
                                                 for p in x)))
        if isinstance(x, GroupedQuantileSketch):
            return _PackedSketchNode(*x.packed())
        return None

    return _map(pack, tree)


def _pack_sketch_template(tree):
    """Structure-only pack of a restore template: no arithmetic on leaves,
    so LeafSpec templates work (restore reads only the dtypes)."""
    def i32_like(leaf):
        return None if leaf is None else LeafSpec(tuple(leaf.shape),
                                                  np.int32)

    def pack(x):
        if isinstance(x, Frugal2UState):
            return PackedFrugal2UState(m=x.m, step_sign=i32_like(x.step))
        if isinstance(x, GroupedQuantileSketch):
            return _PackedSketchNode(m=x.m, step_sign=i32_like(x.step),
                                     quantile=x.quantile, m2=x.m2,
                                     step_sign2=i32_like(x.step2))
        return None

    return _map(pack, tree)


def _unpack_sketches(tree, device):
    def unpack(x):
        if isinstance(x, PackedFrugal2UState):
            return unpack_frugal2u(x)
        if isinstance(x, _PackedSketchNode):
            return GroupedQuantileSketch.from_packed(PackedSketchState(*x),
                                                     device=device)
        return None

    return _map(unpack, tree)


def _sync_sketch_drift(restored, like):
    """Copy each sketch node's DriftConfig from the ``like`` template: the
    packed payload holds plane data only, and a decay sketch is
    layout-identical to a vanilla one, so the template is the source of
    truth for half-life and window length."""
    def sync(r, l):
        if not (isinstance(r, GroupedQuantileSketch)
                and isinstance(l, GroupedQuantileSketch)):
            return None
        if r.drift == l.drift:
            return r
        if (r.m2 is not None) != l.program.layout.has_shadow:
            raise ValueError(
                f"checkpoint sketch {'has' if r.m2 is not None else 'lacks'}"
                f" a window shadow plane but the restore template's drift "
                f"is {l.drift!r}")
        return dataclasses.replace(r, drift=l.drift)

    return _map(sync, restored, like)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _is_float(dt: np.dtype) -> bool:
    return np.issubdtype(dt, np.floating)


def _np_dtype(ref):
    """The numpy dtype of a template leaf (LeafSpec, tensor or array)."""
    dt = getattr(ref, "dtype", None)
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 3,
                    topology: Any = None) -> str:
    """Write one committed format-4 step of ``state`` (a tree of dicts,
    tuples, sketches, tensors and arrays). ``topology`` (a JSON-able dict)
    records the writer's placement in the manifest; restore never reads
    it. Re-saving a committed step is a no-op; keeps the newest ``keep``
    committed steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    marker = os.path.join(ckpt_dir, name + ".COMMITTED")
    if os.path.exists(marker):
        return final                             # idempotent re-save
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    if os.path.exists(final):                    # uncommitted leftover
        shutil.rmtree(final)
    os.makedirs(tmp)

    packed = _pack_sketches(state)
    leaves = _flatten(packed)
    arrs = {f"leaf_{i}": _host_array(l) for i, l in enumerate(leaves)}
    # The leaf file is fsync'd too: otherwise a power cut after the rename
    # could commit a manifest whose leaf bytes never reached the disk.
    with open(os.path.join(tmp, _SHARD), "wb") as f:
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    chaos.on_checkpoint_phase("after_leaves")
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": f"PyTreeDef({_treedef(packed)})",
        "shapes": [list(a.shape) for a in arrs.values()],
        "dtypes": [str(a.dtype) for a in arrs.values()],
        "format": 4,
    }
    if topology is not None:
        manifest["topology"] = topology
    manifest["crc32"] = [_leaf_crc32(arrs[f"leaf_{i}"])
                         for i in range(len(leaves))]
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)                       # atomic on POSIX
    chaos.on_checkpoint_phase("before_marker")
    with open(marker, "w") as f:                 # commit marker last
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    chaos.on_checkpoint_committed(final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    keep = max(1, int(keep))     # never collect the newest checkpoint
    for s in committed_steps(ckpt_dir)[:-keep]:
        name = f"step_{s:08d}"
        # Marker first: a concurrent scan sees a complete step or none.
        try:
            os.remove(os.path.join(ckpt_dir, name + ".COMMITTED"))
        except OSError:
            pass
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _quarantine(ckpt_dir: str, step: int) -> None:
    """Hide a corrupt committed step from future scans: drop its marker and
    rename the directory to ``*.corrupt`` (kept for forensics)."""
    name = f"step_{step:08d}"
    try:
        os.remove(os.path.join(ckpt_dir, name + ".COMMITTED"))
    except OSError:
        pass
    src = os.path.join(ckpt_dir, name)
    dst = src + ".corrupt"
    try:
        if os.path.isdir(dst):
            shutil.rmtree(dst, ignore_errors=True)
        if os.path.isdir(src):
            os.rename(src, dst)
    except OSError:
        pass      # already gone or raced: the marker removal is what counts


def committed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(fn[len("step_"):-len(".COMMITTED")])
                  for fn in os.listdir(ckpt_dir)
                  if fn.endswith(".COMMITTED"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest of a committed step (the newest by default). Raises
    FileNotFoundError when no committed step exists."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``like``; returns (state, step). Every
    leaf lands as a tensor on ``device`` (None: the card; raises where
    there is none), sketches unpacked.

    Format-4 steps verify every leaf against the manifest CRC32s. A
    committed step that fails (or cannot be read) is quarantined and, when
    ``step`` was not pinned, the scan falls back to the next-newest
    committed step until one verifies; with ``step`` pinned the
    CheckpointCorruptError propagates. A step directory that vanishes
    mid-scan is skipped.
    """
    device = resolve_device(device)
    if step is not None:
        try:
            return _restore_step(ckpt_dir, step, like, device)
        except CheckpointCorruptError:
            _quarantine(ckpt_dir, step)
            raise
    corrupt = []
    for s in reversed(committed_steps(ckpt_dir)):
        try:
            return _restore_step(ckpt_dir, s, like, device)
        except CheckpointCorruptError as e:
            corrupt.append(f"step {s}: {e}")
            _quarantine(ckpt_dir, s)
        except FileNotFoundError:
            continue                 # collected between listing and read
    if corrupt:
        raise CheckpointCorruptError(
            f"no committed checkpoint in {ckpt_dir} verifies; quarantined "
            + "; ".join(corrupt))
    raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")


def _restore_step(ckpt_dir: str, step: int, like: Any,
                  device) -> Tuple[Any, int]:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint step directory {path} is gone")
    template = _pack_sketch_template(like)
    refs = _flatten(template)

    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {manifest_path} is corrupt or truncated "
            f"({e}); the step directory was not written by the committed-"
            "checkpoint protocol — restore from an earlier committed step"
        ) from e
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {manifest_path} is missing from a "
            "committed step — corrupt or truncated step directory") from e

    # The template disagrees (plain ValueError): the bytes may be fine.
    fmt = manifest.get("format", 1)
    if manifest.get("num_leaves") != len(refs):
        raise ValueError(
            f"checkpoint at {path} has {manifest.get('num_leaves')} leaves "
            f"(format {fmt}) but the target structure expects {len(refs)}; "
            "format-1 checkpoints store Frugal-2U sketches unpacked and are "
            "not readable by this version — re-save from the old layout.")
    for i, (stored, ref) in enumerate(zip(manifest.get("dtypes", ()), refs)):
        want = _np_dtype(ref)
        if want is not None and _is_float(np.dtype(stored)) != _is_float(want):
            raise ValueError(
                f"checkpoint at {path} stores leaf {i} as {stored} but the "
                f"target structure expects {want}: a checkpoint of another "
                "lane program or layout")

    shard_path = os.path.join(path, _SHARD)
    chaos.on_restore_shard(shard_path)
    crcs = manifest.get("crc32") if fmt >= 4 else None
    raw = []
    try:
        with open(shard_path, "rb") as fh, np.load(fh) as data:
            for i in range(len(refs)):
                arr = data[f"leaf_{i}"]
                if crcs is not None and _leaf_crc32(arr) != int(crcs[i]):
                    raise CheckpointCorruptError(
                        f"checkpoint leaf {i} in {shard_path} fails its "
                        "manifest CRC32 — bytes corrupt or truncated")
                raw.append(arr)
    except CheckpointCorruptError:
        raise
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"checkpoint shard {shard_path} is missing from a committed "
            "step") from e
    except Exception as e:
        # A torn or garbled npz container: zipfile.BadZipFile, zlib errors,
        # KeyError on a missing leaf, struct errors on truncation.
        raise CheckpointCorruptError(
            f"checkpoint shard {shard_path} is unreadable "
            f"({type(e).__name__}: {e}) — corrupt or truncated") from e

    restored = []
    for arr, ref in zip(raw, refs):
        dt = _np_dtype(ref)
        arr = np.array(arr, dtype=dt)            # an owned, cast copy
        restored.append(torch.from_numpy(arr).to(device))
    packed = _unflatten(template, iter(restored))
    return _sync_sketch_drift(_unpack_sketches(packed, device), like), step


def save_train_state(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """``save_checkpoint`` of a port ``TrainState`` in the JAX package's
    leaf order (stacked units)."""
    from repro_torch.models.convert import train_state_to_numpy

    return save_checkpoint(ckpt_dir, step, train_state_to_numpy(state),
                           keep=keep)


def restore_train_state(ckpt_dir: str, like, step: Optional[int] = None):
    """Restore a training checkpoint (either package's) into ``like``'s
    structure: its model's weights are overwritten in place, everything
    else is rebuilt on the model's device. Returns (state, step)."""
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_numpy)

    model = like.params
    tree, step = restore_checkpoint(
        ckpt_dir, train_state_to_numpy(like, shapes_only=True), step=step,
        device=model.device)
    return train_state_from_numpy(model.cfg, tree, model.device,
                                  model=model), step
