"""Training-time frugal monitor fleets (port of the JAX package's
``monitor/registry.py``).

Groups tracked every step, each step one item per group (the paper's
stream model):

  activation absmax   per layer            -> q99 fleet
  activation rms      per layer            -> q50 fleet
  expert load         per (layer, expert)  -> q99 fleet (MoE)

Each monitor is a ``backend="jnp"`` QuantileFleet (the plain PyTorch tick,
on the fleet's device) with the scalar clock: the step's uniform for lane
g is ``counter_uniform(seed, step, g)``, so no key is threaded. The seeds
101 / 202 / 303 are the JAX package's, so the fleets hold the JAX
package's bits when fed the same statistics.

The JAX package counts the groups with ``eval_shape`` of the loss; the
port counts them from the model's layers, without a forward step: each
block returns one absmax and one rms, and each MoE block (kinds ``moe``
and ``mla_moe``) one load per expert. The loads arrive unit-major (the
stack's [n_units, E] raveled; deepseek's dense prefix has none), so lane
g of the port's expert-load fleet is lane g of the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.api.fleet import QuantileFleet
from repro_torch.api.spec import FleetSpec
from repro_torch.models.blocks import MOE_KINDS, layer_kinds

from .moe_stats import expert_load_groups

# Per-monitor counter seeds: distinct so the three fleets' lane g streams
# never alias.
SEED_ABSMAX, SEED_RMS, SEED_MOE = 101, 202, 303


class TrainMonitors(NamedTuple):
    act_absmax_q99: Optional[QuantileFleet]   # G = n_act_groups, Q = (0.99,)
    act_rms_q50: Optional[QuantileFleet]      # G = n_act_groups, Q = (0.5,)
    expert_load_q99: Optional[QuantileFleet]  # G = n_moe_groups (None: no MoE)
    n_act_groups: int
    n_moe_groups: int


def make_fleet(g: int, quantile: float, seed: int, init: float = 0.0,
               device=None) -> Optional[QuantileFleet]:
    """A monitor fleet of ``g`` groups (None for none), on ``device``
    (None: the card)."""
    if g == 0:
        return None
    return QuantileFleet.create(
        FleetSpec(num_groups=g, quantiles=(quantile,), program="2u",
                  backend="jnp"), init=init, seed=seed, device=device)


def _flatten_stats(stats: Dict[str, Any]):
    """Model stats -> (absmax [G], rms [G], expert_load [Gm] or None), in
    the JAX package's order: the stats dict's entries in order, a list's
    (the stack's unit kinds) in order, each statistic flattened."""
    absmax, rms, loads = [], [], []

    def visit(st):
        if not isinstance(st, dict):
            return
        if "absmax" in st:
            absmax.append(torch.ravel(st["absmax"]))
        if "rms" in st:
            rms.append(torch.ravel(st["rms"]))
        if st.get("expert_load") is not None:
            loads.append(torch.ravel(st["expert_load"]))

    for v in stats.values():
        if isinstance(v, dict):
            visit(v)
        elif isinstance(v, (list, tuple)):
            for st in v:
                visit(st)
    a = torch.cat(absmax) if absmax else torch.zeros((0,))
    r = torch.cat(rms) if rms else torch.zeros((0,))
    return a, r, (torch.cat(loads) if loads else None)


def group_counts(cfg) -> Tuple[int, int]:
    """(activation groups, expert-load groups) of ``cfg``'s model: one
    per layer, and one per (MoE layer, expert)."""
    kinds = layer_kinds(cfg)
    return len(kinds), expert_load_groups(
        sum(kind in MOE_KINDS for kind in kinds), cfg.moe_experts)


def init_train_monitors(model, device=None) -> TrainMonitors:
    """The three fleets for ``model`` (a ``CausalLM``): one group per
    layer for the activation fleets, one per (MoE layer, expert) for the
    expert-load fleet (None without MoE layers), on ``device`` (None:
    the model's)."""
    dev = model.device if device is None else device
    n_act, n_moe = group_counts(model.cfg)
    return TrainMonitors(
        act_absmax_q99=make_fleet(n_act, 0.99, SEED_ABSMAX, device=dev),
        act_rms_q50=make_fleet(n_act, 0.5, SEED_RMS, device=dev),
        expert_load_q99=make_fleet(n_moe, 0.99, SEED_MOE, device=dev),
        n_act_groups=n_act, n_moe_groups=n_moe)


def update_train_monitors(mon: TrainMonitors,
                          stats: Dict[str, Any]) -> TrainMonitors:
    """One frugal tick per group from this step's (detached) stats."""
    a, r, loads = _flatten_stats(stats)
    absmax_fl, rms_fl, moe_fl = mon.act_absmax_q99, mon.act_rms_q50, \
        mon.expert_load_q99
    if absmax_fl is not None:
        absmax_fl = absmax_fl.tick_lanes(a)
    if rms_fl is not None:
        rms_fl = rms_fl.tick_lanes(r)
    if moe_fl is not None and loads is not None:
        moe_fl = moe_fl.tick_lanes(loads)
    return mon._replace(act_absmax_q99=absmax_fl, act_rms_q50=rms_fl,
                        expert_load_q99=moe_fl)


def monitor_summary(mon: TrainMonitors) -> Dict[str, torch.Tensor]:
    """Each fleet's estimate plane m ([0] where a fleet is absent)."""
    def m(fleet):
        return fleet.state.m if fleet is not None else torch.zeros((0,))

    out = {"act_absmax_q99": m(mon.act_absmax_q99),
           "act_rms_q50": m(mon.act_rms_q50)}
    if mon.expert_load_q99 is not None:
        out["expert_load_q99"] = m(mon.expert_load_q99)
    return out
