"""Elastic scaling: restore a committed checkpoint onto a DIFFERENT
topology (port of the JAX package's ``train/elastic.py``).

Checkpoints store leaves unsharded, so scaling from N to M devices is:
take the state's structure, compute shardings on the NEW mesh, place
each leaf as it is read. No resharding pass, no divisibility coupling
between the old and the new mesh. Two entry points:

* ``reshard_restore`` — a TrainState checkpoint (either package's) onto
  a ``launch.mesh.Mesh``, placed through ``param_shardings``' rules.
* ``fleet_reshard_restore`` — a QuantileFleet checkpoint onto ANY
  TopologySpec: fleet checkpoints store the MERGED canonical lanes (a
  sync point — DESIGN.md §15), so a fleet saved under (a × b) restores
  under (c × d), 1-D or one device by re-placement alone, bit-identical.
  ``QuantileFleet.reshard`` is the live half of the same contract.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.parallel.topology import TopologySpec


def train_state_shardings(like_state, mesh):
    """Shardings of a ``TrainState``'s checkpoint leaves (the JAX
    package's stacked layout, ``train_state_to_numpy``'s structure) on
    ``mesh``: params and the moments as ``param_spec_tree`` says (a
    stacked leaf's layer dim split over 'data' gives each data index its
    own layers), the count, step, key words, monitors and clip
    replicated."""
    from repro_torch.parallel.sharding import (Sharding, map_layout,
                                               param_spec_tree, replicated)
    from repro_torch.train.train_state import TrainState

    specs = param_spec_tree(like_state.params, mesh.shape.get("model", 1),
                            mesh.shape.get("data", 1))
    p_sh = map_layout(specs, lambda path, s: Sharding(mesh, s))
    rep = replicated(mesh)
    opt = like_state.opt_state
    opt_sh = type(opt)(**{f: p_sh for f in opt._fields if f != "count"},
                       count=rep)
    return TrainState(
        params=p_sh, opt_state=opt_sh, step=rep, rng=rep,
        monitors=rep if like_state.monitors is not None else None,
        qclip=rep if like_state.qclip is not None else None)


def reshard_restore(ckpt_dir: str, like_state, new_mesh,
                    step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore a ``like_state``-shaped TrainState checkpoint placed for
    ``new_mesh``. Returns (placed, step): ``placed`` is the checkpoint's
    TrainState in the JAX package's layout whose every leaf is a
    ``sharding.shard`` array (each device's shard on that device; None
    where a device holds none of it), ``sharding.unshard`` gives a leaf
    back whole. On a 1 x 1 mesh each leaf is whole on its one device."""
    from repro_torch.models.convert import train_state_to_numpy
    from . import checkpoint as ckpt_lib

    return ckpt_lib.restore_checkpoint(
        ckpt_dir, train_state_to_numpy(like_state, shapes_only=True),
        step=step, shardings=train_state_shardings(like_state, new_mesh))


def fleet_reshard_restore(ckpt_dir: str, spec, topology: TopologySpec,
                          step: Optional[int] = None,
                          per_lane_clock: bool = False, device=None):
    """Restore a QuantileFleet checkpoint re-placed on ``topology``.

    ``spec`` is the fleet's FleetSpec under any placement (its lane plane,
    num_groups × quantiles, must match the checkpoint); ``topology``
    overrides the placement. ``device`` is where a single or loop-mode
    fleet lives (None: the card); a device-resolved topology places on
    its own devices."""
    from repro_torch.api import QuantileFleet

    return QuantileFleet.restore(ckpt_dir, spec.with_topology(topology),
                                 step=step, per_lane_clock=per_lane_clock,
                                 device=device)
