"""Drift-aware frugal lanes: decayed Frugal-2U and the two-sketch window.

Port of the JAX package's ``core/drift.py``:

  * ``mode="decay"`` (2U only): after each real tick a below-floor step
    relaxes toward the floor, ``step <- floor - (floor - step) * alpha``
    with ``alpha = 2^(-1/half_life)`` computed once on the host in float32.
  * ``mode="window"``: an (A, B) sketch pair per lane; at the first tick of
    epoch ``e = t // W`` plane ``e mod 2`` restarts from the other plane's
    estimate with (step, sign) = (1, 1); both planes ingest every item with
    the same uniform; queries read the plane not restarted this epoch.

Restarts and decay are gated on the item being a number (``item == item``),
so a NaN tick stays a bit-exact no-op.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device

from .frugal import (Frugal1UState, Frugal2UState, frugal1u_update,
                     frugal2u_update)

DRIFT_MODES = ("decay", "window")


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Static drift description.

    mode      — "decay" (decayed Frugal-2U) or "window" (two-sketch pair).
    half_life — decay: ticks for the below-floor step excess to halve.
    floor     — decay: step level the excess decays toward.
    window    — window: epoch length W in ticks; queries cover the last
                W..2W items.
    """

    mode: str
    half_life: int = 4096
    floor: float = 0.0
    window: int = 4096

    def __post_init__(self):
        if self.mode not in DRIFT_MODES:
            raise ValueError(
                f"drift mode must be one of {DRIFT_MODES}, got {self.mode!r}")
        if self.mode == "decay" and self.half_life < 1:
            raise ValueError(
                f"decay half_life must be >= 1 tick, got {self.half_life}")
        if self.mode == "window" and self.window < 1:
            raise ValueError(f"window must be >= 1 tick, got {self.window}")
        if not np.isfinite(self.floor):
            raise ValueError(f"floor must be finite, got {self.floor}")

    def validate_for_algo(self, algo: str) -> "DriftConfig":
        if self.mode == "decay" and algo != "2u":
            raise ValueError(
                "drift mode 'decay' decays the adaptive step and needs "
                f"algo='2u' (Frugal-1U has no step); got algo={algo!r}")
        return self

    @property
    def windowed(self) -> bool:
        return self.mode == "window"

    @property
    def alpha_f32(self) -> np.float32:
        """Per-tick decay factor 2^(-1/half_life), rounded once to float32
        on the host, so every backend multiplies by the same value."""
        return np.float32(np.exp2(np.float64(-1.0) / self.half_life))

    @property
    def alpha_bits(self) -> int:
        """int32 bit pattern of ``alpha_f32`` (a kernel scalar operand)."""
        return int(np.float32(self.alpha_f32).view(np.int32))

    @property
    def floor_bits(self) -> int:
        return int(np.float32(self.floor).view(np.int32))

    def operand_slots(self) -> Tuple[int, int]:
        """The two drift scalar operands of the dense kernel:
        (alpha_bits, floor_bits) for decay, (window, 0) for window."""
        if self.mode == "decay":
            return (self.alpha_bits, self.floor_bits)
        return (int(self.window), 0)


def is_windowed(cfg) -> bool:
    """None-safe "carries a shadow plane" predicate."""
    return cfg is not None and cfg.mode == "window"


class WindowState(NamedTuple):
    """Two-sketch window pair: plane A (m, step, sign), plane B (m2, step2,
    sign2). For 1U the step/sign planes are all-ones placeholders."""

    m: torch.Tensor
    step: torch.Tensor
    sign: torch.Tensor
    m2: torch.Tensor
    step2: torch.Tensor
    sign2: torch.Tensor


def bits_to_f32(bits: int) -> float:
    """The float32 whose bit pattern is the int32 ``bits`` (exact as a
    Python float)."""
    return float(np.int32(bits).view(np.float32))


def apply_step_decay(step: torch.Tensor, valid: torch.Tensor, alpha: float,
                     floor: float) -> torch.Tensor:
    """Where the real-tick step sits below ``floor``, pull it geometrically
    toward the floor. ``alpha`` and ``floor`` are float32 values held as
    Python floats; three separate float32 operations, no fused multiply-add."""
    decayed = floor - (floor - step) * alpha
    return torch.where(valid & (step < floor), decayed, step)


def decay2u_update(state: Frugal2UState, items, rand, quantile, alpha,
                   floor) -> Frugal2UState:
    """One decayed Frugal-2U tick: Algorithm 3, then the step relaxation."""
    st = frugal2u_update(state, items, rand, quantile)
    valid = items == items
    return st._replace(step=apply_step_decay(st.step, valid, alpha, floor))


def window_phase(t, window):
    """(reset_a, reset_b) for absolute tick ``t`` (a Python int or an int32
    tensor): at the first tick of epoch ``e = t // W`` plane ``e mod 2``
    restarts. ``//`` and ``%`` floor for Python ints and torch tensors
    alike, as the JAX reference's int32 ``//`` does on negative ticks."""
    epoch = t // window
    boundary = t - epoch * window == 0
    return boundary & (epoch % 2 == 0), boundary & (epoch % 2 == 1)


def query_plane_is_primary(t_next, window: int):
    """True where plane A answers queries after ``t_next`` items (numpy;
    ``estimate()`` is a host read)."""
    t_last = np.maximum(np.asarray(t_next, np.int64) - 1, 0)
    epoch = t_last // int(window)
    return (epoch % 2) == 1


def window_update(state: WindowState, items, rand, quantile, t, window,
                  algo: str = "2u") -> WindowState:
    """One windowed tick: the epoch-boundary restart, then both planes
    ingest ``items`` with the same uniform ``rand``."""
    valid = items == items
    reset_a, reset_b = window_phase(t, window)
    reset_a = valid & reset_a
    reset_b = valid & reset_b
    m_a = torch.where(reset_a, state.m2, state.m)
    step_a = torch.where(reset_a, 1.0, state.step)
    sign_a = torch.where(reset_a, 1.0, state.sign)
    m_b = torch.where(reset_b, state.m, state.m2)
    step_b = torch.where(reset_b, 1.0, state.step2)
    sign_b = torch.where(reset_b, 1.0, state.sign2)
    if algo == "1u":
        a = frugal1u_update(Frugal1UState(m_a), items, rand, quantile)
        b = frugal1u_update(Frugal1UState(m_b), items, rand, quantile)
        return WindowState(m=a.m, step=step_a, sign=sign_a,
                           m2=b.m, step2=step_b, sign2=sign_b)
    a = frugal2u_update(Frugal2UState(m_a, step_a, sign_a), items, rand,
                        quantile)
    b = frugal2u_update(Frugal2UState(m_b, step_b, sign_b), items, rand,
                        quantile)
    return WindowState(m=a.m, step=a.step, sign=a.sign,
                       m2=b.m, step2=b.step, sign2=b.sign)


def window_process_seeded(state: WindowState, items: torch.Tensor, seed,
                          quantile, cfg: DriftConfig,
                          return_trace: bool = False, t_offset: int = 0,
                          g_offset: int = 0, lanes_per_group: int = 1,
                          algo: str = "2u"
                          ) -> Tuple[WindowState, Optional[torch.Tensor]]:
    """[T, G] two-sketch window ingest: the generic loop with the
    registered '{algo}-window' program. Trace rows are the queried plane's
    estimate at each tick. For 1U only the heads (m, m2) are planes; the
    step and sign fields come back as ones."""
    from . import program as program_mod  # program imports this module
    from .frugal import program_process_seeded

    prog = program_mod.program_for(algo, cfg)
    planes = (state.m, state.m2) if algo == "1u" else tuple(state)
    planes, trace = program_process_seeded(
        prog, planes, items, seed, quantile, return_trace=return_trace,
        t_offset=t_offset, g_offset=g_offset,
        lanes_per_group=lanes_per_group)
    if algo == "1u":
        one = torch.ones_like(planes[0])
        return WindowState(m=planes[0], step=one, sign=one, m2=planes[1],
                           step2=one, sign2=one), trace
    return WindowState(*planes), trace


def window_init(num_lanes: int, init=0.0, dtype=torch.float32,
                device=None) -> WindowState:
    """Fresh window pairs: both heads at ``init``, steps and signs at 1,
    every leaf in a buffer of its own. On ``device`` (None: the card)."""
    m = torch.broadcast_to(
        torch.as_tensor(init, dtype=dtype, device=resolve_device(device)),
        (num_lanes,)).clone()
    return WindowState(m=m, step=torch.ones_like(m), sign=torch.ones_like(m),
                       m2=m.clone(), step2=torch.ones_like(m),
                       sign2=torch.ones_like(m))
