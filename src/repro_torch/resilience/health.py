"""Lane health: plane-invariant validation and self-healing, port of the
JAX package's ``resilience/health.py``.

A frugal lane is 1-2 words with no redundancy, so a flipped bit poisons
its estimate for good unless the state breaks an invariant the program's
``StateLayout`` declares (``core.program``):

  'finite' — estimate heads are finite (a NaN or inf head can only enter
             through non-finite items, which every ingest path masks out);
  'sign'   — direction planes are exactly ±1.0;
  'step'   — step planes are finite and value-round-trip through the packed
             (step, sign) word (``core.packing``), the form every
             checkpoint and kernel operand uses.

``validate_planes`` evaluates a program's declared invariants in one pass
of tensor operations on the planes' device (the JAX version is a jitted jnp
pass, not a kernel); ``heal_planes`` resets flagged lanes to the fresh lane
state (``layout.pad_fill``: heads 0.0, pair planes 1.0, what
``GroupedQuantileSketch.create`` writes). Uniforms key on the absolute
(seed, tick, lane), so a lane healed at stream position t ticks on
bit-exactly like a lane created at t.

Policies live in ``repro_torch.api``: ``FleetSpec(health=...)`` is one of
``HEALTH_POLICIES``, applied by ``QuantileFleet.check_health()``;
``serve.SLOFleet`` accumulates the reports.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import packing

__all__ = ["HEALTH_POLICIES", "HealthReport", "LaneCorruptionError",
           "validate_planes", "heal_planes", "report_for"]

HEALTH_POLICIES = ("raise", "quarantine", "ignore")


class LaneCorruptionError(RuntimeError):
    """Raised by the 'raise' health policy when any lane violates its
    program's declared plane invariants."""


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Outcome of one fleet health scan."""

    total_lanes: int
    corrupt_lanes: int
    lane_ids: Tuple[int, ...]      # indices of flagged lanes
    policy: str                    # the FleetSpec policy in force
    quarantined: int = 0           # lanes re-initialized by this check

    @property
    def healthy(self) -> bool:
        return self.corrupt_lanes == 0

    def __str__(self):
        if self.healthy:
            return f"HealthReport(healthy, {self.total_lanes} lanes)"
        shown = ", ".join(map(str, self.lane_ids[:8]))
        more = "" if self.corrupt_lanes <= 8 else ", ..."
        return (f"HealthReport({self.corrupt_lanes}/{self.total_lanes} lanes "
                f"corrupt [{shown}{more}], policy={self.policy}, "
                f"quarantined={self.quarantined})")


def validate_planes(program, planes) -> torch.Tensor:
    """[L] bool tensor on the planes' device, True where a lane violates
    ``program``'s declared invariants."""
    layout = program.layout
    by_field = dict(zip(layout.plane_fields, planes))
    bad = torch.zeros(planes[0].shape, dtype=torch.bool,
                      device=planes[0].device)
    for field, domain in layout.invariants:
        x = by_field[field]
        if domain in ("finite", "step"):
            bad |= ~torch.isfinite(x)
        elif domain == "sign":
            bad |= (x != 1.0) & (x != -1.0)
        else:  # pragma: no cover - layout __post_init__ refuses unknowns
            raise ValueError(f"unknown invariant domain {domain!r}")
    # Pack round trip per plane-pair, by value (not bits): -0.0 steps and
    # clipped steps pass, while states the lane's own serialization would
    # rewrite (NaN, out-of-range, a mismatched sign) flag.
    for _, pair in layout.packing:
        if pair is None:
            continue
        step, sign = by_field[pair[0]], by_field[pair[1]]
        s2, g2 = packing.unpack_step_sign(packing.pack_step_sign(step, sign))
        bad |= (s2 != step) | (g2 != sign)
    return bad


def heal_planes(program, planes, corrupt_mask) -> Tuple[torch.Tensor, ...]:
    """New planes with the flagged lanes reset to ``layout.pad_fill`` (the
    fresh lane state); the input tensors are left as they were."""
    layout = program.layout
    mask = torch.as_tensor(corrupt_mask, dtype=torch.bool,
                           device=planes[0].device)
    return tuple(torch.where(mask, layout.pad_fill(f), p)
                 for f, p in zip(layout.plane_fields, planes))


def report_for(program, planes, policy: str) -> HealthReport:
    """A scan-only HealthReport (no healing applied)."""
    return report_of(validate_planes(program, planes), policy)


def report_of(corrupt_mask: torch.Tensor, policy: str) -> HealthReport:
    """The scan-only HealthReport of a ``validate_planes`` mask."""
    ids = tuple(int(i) for i in torch.nonzero(corrupt_mask).flatten().tolist())
    return HealthReport(total_lanes=int(corrupt_mask.shape[0]),
                        corrupt_lanes=len(ids), lane_ids=ids, policy=policy)
