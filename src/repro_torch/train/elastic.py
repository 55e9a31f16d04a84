"""Elastic scaling: restore a committed fleet checkpoint onto a DIFFERENT
topology (port of the JAX package's ``train/elastic.py``).

A fleet checkpoint stores the MERGED canonical lanes (a sync point —
DESIGN.md §15), so a fleet saved under (a × b) restores under (c × d),
1-D or one device by re-placement alone: the state is bit-identical and
the continued trajectory bit-exact. ``QuantileFleet.reshard`` is the live
half of the same contract.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.parallel.topology import TopologySpec


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
