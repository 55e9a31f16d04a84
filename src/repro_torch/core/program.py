"""LaneProgram — the rule behind every frugal backend, in PyTorch.

Port of the JAX package's ``core/program.py``. A program is a per-lane
tick ``tick(program, planes, item, u, ctx) -> planes``, a static
``StateLayout`` (plane fields, their packing into words, scalar operand
slots, query planes) and a host-side ``query``. The plain PyTorch loop
(``core.frugal.program_process_seeded``) runs the tick; the CUDA kernel
runs a C++ transcription of it, selected by ``kernel_family``.

Registered families:

  name        algo  planes                              scalar slots
  ----------  ----  ----------------------------------  --------------------
  1u          1u    (m,)                                ()
  2u          2u    (m, step, sign)                     ()
  2u-decay    2u    (m, step, sign)                     (alpha_bits, floor_bits)
  1u-window   1u    (m, m2)                             (window,)
  2u-window   2u    (m, step, sign, m2, step2, sign2)   (window,)
  2u-dp       2u    (m, step, sign)                     ()   [query-noised]
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import drift as drift_mod
from . import frugal
from . import packing
from . import rng as crng
from .drift import DriftConfig

# Salt for the DP reporting-noise stream: keeps query-time draws disjoint
# from every ingest-time uniform (which key on the raw seed).
_DP_SALT = int(np.int32(np.uint32(0x5DEECE66).view(np.int32)))

# Plane-invariant domains resilience.health checks. Every registered layout
# assigns one to each plane field (validate_program).
_INVARIANT_DOMAINS = ("finite", "step", "sign")


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Static shape of a program's persistent state.

    plane_fields — ordered plane names; plane tuples follow this order.
    packing      — one (head, pair) unit per plane-pair: ``head`` is the f32
                   estimate plane, ``pair`` an optional (step, sign) pair
                   packed into one int32 word (core.packing).
    scalar_names — int32 operands beyond (seed, t_offset, g_offset).
    query_fields — estimate planes a read gathers.
    invariants   — (field, domain) health declarations, one per plane
                   field: 'finite' (estimate heads), 'step' (finite and
                   value-round-trips through the packed word), 'sign'
                   (exactly ±1). ``resilience.health.validate_planes``
                   derives its corruption check from them.
    """

    plane_fields: Tuple[str, ...]
    packing: Tuple[Tuple[str, Optional[Tuple[str, str]]], ...]
    scalar_names: Tuple[str, ...] = ()
    query_fields: Tuple[str, ...] = ("m",)
    invariants: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        flat = []
        for head, pair in self.packing:
            flat.append(head)
            if pair is not None:
                flat.extend(pair)
        if tuple(flat) != self.plane_fields:
            raise ValueError(
                f"packing spec {self.packing} does not enumerate "
                f"plane_fields {self.plane_fields} in order")
        if not set(self.query_fields) <= set(self.heads):
            raise ValueError(
                f"query_fields {self.query_fields} must be packing heads "
                f"{self.heads}")
        seen = set()
        for field, domain in self.invariants:
            if field not in self.plane_fields:
                raise ValueError(
                    f"invariant declared for unknown plane field {field!r} "
                    f"(plane_fields {self.plane_fields})")
            if domain not in _INVARIANT_DOMAINS:
                raise ValueError(
                    f"invariant domain {domain!r} for plane {field!r} is not "
                    f"one of {_INVARIANT_DOMAINS}")
            if field in seen:
                raise ValueError(
                    f"duplicate invariant declaration for plane {field!r}")
            seen.add(field)

    @property
    def heads(self) -> Tuple[str, ...]:
        return tuple(h for h, _ in self.packing)

    @property
    def has_shadow(self) -> bool:
        """True when the program carries a second plane-pair (window)."""
        return len(self.packing) > 1

    @property
    def word_dtypes(self):
        """Word dtypes, unit-major: f32 head [+ i32 packed pair]."""
        dts = []
        for _, pair in self.packing:
            dts.append(torch.float32)
            if pair is not None:
                dts.append(torch.int32)
        return tuple(dts)

    @property
    def num_words(self) -> int:
        """Persistent memory words per lane — the paper's footprint."""
        return len(self.word_dtypes)

    def pad_fill(self, field: str) -> float:
        """Dummy-state fill for padded lanes."""
        return 0.0 if field in self.heads else 1.0

    def pack_planes(self, planes) -> Tuple[torch.Tensor, ...]:
        """Plane tuple -> word tuple (f32 head + packed i32 pair per unit)."""
        by_field = dict(zip(self.plane_fields, planes))
        words = []
        for head, pair in self.packing:
            words.append(by_field[head])
            if pair is not None:
                words.append(packing.pack_step_sign(by_field[pair[0]],
                                                    by_field[pair[1]]))
        return tuple(words)

    def unpack_words(self, words) -> Tuple[torch.Tensor, ...]:
        """Bit-exact inverse of ``pack_planes`` (in-domain steps)."""
        planes = []
        wi = 0
        for _, pair in self.packing:
            planes.append(words[wi])
            wi += 1
            if pair is not None:
                planes.extend(packing.unpack_step_sign(words[wi]))
                wi += 1
        return tuple(planes)


@dataclasses.dataclass(frozen=True)
class LaneProgram:
    """One frugal update rule. Hashable; two programs of the same family
    and parameters compare equal."""

    family: str
    algo: str
    layout: StateLayout
    tick: Callable                  # (prog, planes, item, u, ctx) -> planes
    query: Callable                 # (prog, m_planes, t_next, seed, lanes)
    trace: Callable                 # (prog, planes, t_abs) -> [L] tensor
    drift: Optional[DriftConfig] = None
    dp_epsilon: Optional[float] = None

    def run_tick(self, planes, item, u, ctx) -> Tuple[torch.Tensor, ...]:
        return tuple(self.tick(self, planes, item, u, ctx))

    def run_query(self, m_planes, t_next=None, seed=None, lanes=None):
        if self.layout.has_shadow and t_next is None:
            raise ValueError(
                f"{self.family}: estimate() needs t_next (absolute items "
                "ingested) to select the older window plane — read through "
                "repro_torch.api.QuantileFleet, whose cursor carries it")
        return self.query(self, m_planes, t_next, seed, lanes)

    def run_trace(self, planes, t_abs) -> torch.Tensor:
        return self.trace(self, planes, t_abs)

    @property
    def kernel_family(self) -> str:
        """Family whose kernel instantiation runs this program: the DP
        rule's tick is the vanilla 2U tick."""
        return "2u" if self.family == "2u-dp" else self.family

    def scalar_values(self) -> Tuple[int, ...]:
        """int32 values for ``layout.scalar_names``."""
        vals = []
        for name in self.layout.scalar_names:
            if name == "alpha_bits":
                vals.append(int(self.drift.alpha_bits))
            elif name == "floor_bits":
                vals.append(int(self.drift.floor_bits))
            elif name == "window":
                vals.append(int(self.drift.window))
            else:  # pragma: no cover - registration error
                raise ValueError(f"{self.family}: unknown scalar slot {name!r}")
        return tuple(vals)

    def memory_words(self) -> int:
        return self.layout.num_words


# ------------------------------------------------------------- tick functions
def _tick_1u(prog, planes, item, u, ctx):
    (m,) = planes
    return (frugal.frugal1u_update(frugal.Frugal1UState(m), item, u,
                                   ctx.quantile).m,)


def _tick_2u(prog, planes, item, u, ctx):
    return tuple(frugal.frugal2u_update(frugal.Frugal2UState(*planes), item,
                                        u, ctx.quantile))


def _tick_2u_decay(prog, planes, item, u, ctx):
    # alpha and floor arrive as float32 bit patterns in int32 slots.
    alpha = drift_mod.bits_to_f32(ctx.scalars[0])
    floor = drift_mod.bits_to_f32(ctx.scalars[1])
    return tuple(drift_mod.decay2u_update(frugal.Frugal2UState(*planes),
                                          item, u, ctx.quantile, alpha,
                                          floor))


def _tick_window(prog, planes, item, u, ctx):
    w = ctx.scalars[0]
    if prog.algo == "1u":
        m, m2 = planes
        one = torch.ones_like(m)
        st = drift_mod.window_update(
            drift_mod.WindowState(m=m, step=one, sign=one, m2=m2, step2=one,
                                  sign2=one), item, u, ctx.quantile, ctx.t,
            w, algo="1u")
        return (st.m, st.m2)
    return tuple(drift_mod.window_update(drift_mod.WindowState(*planes), item,
                                         u, ctx.quantile, ctx.t, w,
                                         algo="2u"))


# ------------------------------------------------------------ query functions
def _query_head(prog, m_planes, t_next, seed, lanes):
    return np.asarray(m_planes[0])


def _query_window(prog, m_planes, t_next, seed, lanes):
    m, m2 = (np.asarray(p) for p in m_planes)
    primary = drift_mod.query_plane_is_primary(np.asarray(t_next),
                                               prog.drift.window)
    return np.where(primary, m, m2)


def _query_dp(prog, m_planes, t_next, seed, lanes):
    """estimate + Laplace(1/epsilon), the noise a pure function of
    (seed ^ salt, t_next, lane), in numpy float64 as the JAX package does."""
    if seed is None or t_next is None or lanes is None:
        raise ValueError(
            "2u-dp: noised reporting needs the stream cursor (seed, t_next, "
            "lane ids) — read through repro_torch.api.QuantileFleet")
    u = crng.counter_uniform(
        crng.wrap_i32(int(seed) ^ _DP_SALT),
        torch.as_tensor(np.asarray(t_next).astype(np.int32)),
        torch.as_tensor(np.asarray(lanes).astype(np.int32)))
    centered = u.numpy().astype(np.float64) - 0.5
    scale = 1.0 / float(prog.dp_epsilon)
    noise = -scale * np.sign(centered) * np.log(
        np.maximum(1.0 - 2.0 * np.abs(centered), np.finfo(np.float64).tiny))
    return (np.asarray(m_planes[0], np.float64) + noise).astype(np.float32)


# ------------------------------------------------------------ trace functions
def _trace_head(prog, planes, t_abs):
    return planes[0]


def _trace_window(prog, planes, t_abs):
    # After tick t_abs the stream holds t_abs+1 items; trace the plane a
    # query would answer from (the one not restarted this epoch).
    epoch = t_abs // int(prog.drift.window)
    m2 = planes[prog.layout.plane_fields.index("m2")]
    return planes[0] if epoch % 2 == 1 else m2


# ----------------------------------------------------------------- registry
_L_1U = StateLayout(plane_fields=("m",), packing=(("m", None),),
                    invariants=(("m", "finite"),))
_L_2U = StateLayout(plane_fields=("m", "step", "sign"),
                    packing=(("m", ("step", "sign")),),
                    invariants=(("m", "finite"), ("step", "step"),
                                ("sign", "sign")))
# dataclasses.replace inherits _L_2U's invariants.
_L_2U_DECAY = dataclasses.replace(_L_2U,
                                  scalar_names=("alpha_bits", "floor_bits"))
_L_1U_WINDOW = StateLayout(plane_fields=("m", "m2"),
                           packing=(("m", None), ("m2", None)),
                           scalar_names=("window",),
                           query_fields=("m", "m2"),
                           invariants=(("m", "finite"), ("m2", "finite")))
_L_2U_WINDOW = StateLayout(
    plane_fields=("m", "step", "sign", "m2", "step2", "sign2"),
    packing=(("m", ("step", "sign")), ("m2", ("step2", "sign2"))),
    scalar_names=("window",),
    query_fields=("m", "m2"),
    invariants=(("m", "finite"), ("step", "step"), ("sign", "sign"),
                ("m2", "finite"), ("step2", "step"), ("sign2", "sign")))


def _refuse_params(family, **kw):
    extra = [k for k, v in kw.items() if v is not None]
    if extra:
        raise ValueError(f"program {family!r} takes no {extra} parameter(s)")


def _build_1u(half_life=None, floor=None, window=None, epsilon=None,
              drift=None):
    _refuse_params("1u", half_life=half_life, floor=floor, window=window,
                   epsilon=epsilon, drift=drift)
    return LaneProgram(family="1u", algo="1u", layout=_L_1U, tick=_tick_1u,
                       query=_query_head, trace=_trace_head)


def _build_2u(half_life=None, floor=None, window=None, epsilon=None,
              drift=None):
    _refuse_params("2u", half_life=half_life, floor=floor, window=window,
                   epsilon=epsilon, drift=drift)
    return LaneProgram(family="2u", algo="2u", layout=_L_2U, tick=_tick_2u,
                       query=_query_head, trace=_trace_head)


def _build_2u_decay(half_life=None, floor=None, window=None, epsilon=None,
                    drift=None):
    _refuse_params("2u-decay", window=window, epsilon=epsilon)
    if drift is None:
        drift = DriftConfig(mode="decay",
                            half_life=4096 if half_life is None else half_life,
                            floor=0.0 if floor is None else floor)
    elif drift.mode != "decay":
        raise ValueError(f"2u-decay needs a decay DriftConfig, got {drift!r}")
    return LaneProgram(family="2u-decay", algo="2u", layout=_L_2U_DECAY,
                       tick=_tick_2u_decay, query=_query_head,
                       trace=_trace_head, drift=drift)


def _build_window(algo):
    family = f"{algo}-window"
    layout = _L_1U_WINDOW if algo == "1u" else _L_2U_WINDOW

    def build(half_life=None, floor=None, window=None, epsilon=None,
              drift=None):
        _refuse_params(family, half_life=half_life, floor=floor,
                       epsilon=epsilon)
        if drift is None:
            drift = DriftConfig(mode="window",
                                window=4096 if window is None else window)
        elif drift.mode != "window":
            raise ValueError(
                f"{family} needs a window DriftConfig, got {drift!r}")
        return LaneProgram(family=family, algo=algo, layout=layout,
                           tick=_tick_window, query=_query_window,
                           trace=_trace_window, drift=drift)

    return build


def _build_2u_dp(half_life=None, floor=None, window=None, epsilon=None,
                 drift=None):
    _refuse_params("2u-dp", half_life=half_life, floor=floor, window=window,
                   drift=drift)
    epsilon = 1.0 if epsilon is None else float(epsilon)
    if not epsilon > 0.0:
        raise ValueError(f"2u-dp epsilon must be positive, got {epsilon}")
    return LaneProgram(family="2u-dp", algo="2u", layout=_L_2U, tick=_tick_2u,
                       query=_query_dp, trace=_trace_head,
                       dp_epsilon=epsilon)


_FAMILIES = {
    "1u": _build_1u,
    "2u": _build_2u,
    "2u-decay": _build_2u_decay,
    "1u-window": _build_window("1u"),
    "2u-window": _build_window("2u"),
    "2u-dp": _build_2u_dp,
}


def registered_families() -> Tuple[str, ...]:
    return tuple(_FAMILIES)


def make_program(family, *, half_life=None, floor=None, window=None,
                 epsilon=None, drift=None) -> LaneProgram:
    """Build a program by family name; a LaneProgram is returned as is."""
    if isinstance(family, LaneProgram):
        return family
    if family not in _FAMILIES:
        raise ValueError(f"unknown lane program {family!r}; registered: "
                         f"{', '.join(_FAMILIES)}")
    return _FAMILIES[family](half_life=half_life, floor=floor, window=window,
                             epsilon=epsilon, drift=drift)


@functools.lru_cache(maxsize=None)
def family_base(family: str) -> LaneProgram:
    """Canonical default-parameter instance of a family."""
    return make_program(family)


@functools.lru_cache(maxsize=None)
def program_for(algo: str, drift: Optional[DriftConfig] = None,
                dp_epsilon: Optional[float] = None) -> LaneProgram:
    """Map the (algo=, drift=) spelling onto its program."""
    if dp_epsilon is not None:
        if algo != "2u" or drift is not None:
            raise ValueError("the DP rule is 2u-only and drift-free")
        return make_program("2u-dp", epsilon=dp_epsilon)
    if drift is None:
        return family_base(algo)
    if drift.mode == "decay":
        drift.validate_for_algo(algo)
        return make_program("2u-decay", drift=drift)
    return make_program(f"{algo}-window", drift=drift)


def test_instances() -> Tuple[LaneProgram, ...]:
    """One small-parameter instance per registered family, the same set as
    the JAX package's ``test_instances``."""
    return (
        make_program("1u"),
        make_program("2u"),
        make_program("2u-decay", half_life=48),
        make_program("1u-window", window=96),
        make_program("2u-window", window=96),
        make_program("2u-dp", epsilon=0.5),
    )


# ------------------------------------------------------------------ validation
def validate_program(prog: LaneProgram) -> None:
    """Registration lint, the JAX package's ``validate_program`` on CPU
    tensors: every plane declares an invariant domain (heads 'finite'),
    the scalar slots resolve to ints, a smoke tick (one real item, one
    NaN) keeps plane arity, shape and dtype, the words round-trip, and the
    query and trace answer one value per lane. Raises AssertionError."""
    layout = prog.layout
    if prog.algo not in ("1u", "2u"):
        raise AssertionError(f"{prog.family}: algo {prog.algo!r}")
    inv = dict(layout.invariants)
    missing_inv = [f for f in layout.plane_fields if f not in inv]
    if missing_inv:
        raise AssertionError(
            f"{prog.family}: plane field(s) {missing_inv} declare no "
            "invariant domain — add invariants=((field, domain), ...) to the "
            "StateLayout so resilience.health.validate_planes covers them")
    for f in layout.heads:
        if inv[f] != "finite":
            raise AssertionError(
                f"{prog.family}: estimate head {f!r} must declare the "
                f"'finite' invariant, not {inv[f]!r}")
    vals = prog.scalar_values()
    if len(vals) != len(layout.scalar_names):
        raise AssertionError(
            f"{prog.family}: {len(layout.scalar_names)} declared scalar "
            f"slot(s) but scalar_values() resolves {len(vals)}")
    if not all(isinstance(v, int) for v in vals):
        raise AssertionError(f"{prog.family}: scalar slots must be int32 "
                             f"values, got {vals}")

    n = 2
    planes = tuple(torch.full((n,), layout.pad_fill(f), dtype=torch.float32)
                   for f in layout.plane_fields)
    ctx = frugal.TickCtx(
        quantile=torch.full((n,), 0.5, dtype=torch.float32), t=0, seed=1,
        lanes=torch.arange(n, dtype=torch.int32),
        scalars=tuple(max(v, 1) for v in vals))
    item = torch.tensor([3.0, float("nan")], dtype=torch.float32)
    u = torch.full((n,), 0.25, dtype=torch.float32)
    out = prog.run_tick(planes, item, u, ctx)
    if len(out) != len(layout.plane_fields):
        raise AssertionError(
            f"{prog.family}: tick returned {len(out)} plane(s), layout "
            f"declares {len(layout.plane_fields)}")
    for f, p in zip(layout.plane_fields, out):
        if tuple(p.shape) != (n,) or p.dtype != torch.float32:
            raise AssertionError(
                f"{prog.family}: tick output plane {f!r} has "
                f"shape {tuple(p.shape)} dtype {p.dtype}")

    words = layout.pack_planes(out)
    if len(words) != layout.num_words:
        raise AssertionError(f"{prog.family}: packing spec word count")
    for w, dt in zip(words, layout.word_dtypes):
        if w.dtype != dt:
            raise AssertionError(f"{prog.family}: word dtype {w.dtype} != {dt}")
    back = layout.unpack_words(words)
    for f, a, b in zip(layout.plane_fields, out, back):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{prog.family}: plane {f!r} does not round-trip its words")

    m_planes = tuple(np.zeros((n,), np.float32) for _ in layout.query_fields)
    est = prog.run_query(m_planes, t_next=1, seed=0,
                         lanes=np.arange(n, dtype=np.int32))
    if np.shape(est) != (n,):
        raise AssertionError(f"{prog.family}: query shape {np.shape(est)}")
    tr = prog.run_trace(out, 0)
    if tuple(tr.shape) != (n,):
        raise AssertionError(f"{prog.family}: trace shape {tuple(tr.shape)}")


def validate_registry() -> Tuple[str, ...]:
    """Validate every registered family's ``test_instances()`` member;
    returns the family names checked. A family registered but missing
    from ``test_instances()`` fails: it would pass unvalidated."""
    covered = {p.family for p in test_instances()}
    missing = set(_FAMILIES) - covered
    if missing:
        raise AssertionError(
            f"registered famil{'ies' if len(missing) > 1 else 'y'} "
            f"{sorted(missing)} missing from test_instances() — add a "
            "canonical instance so the lint covers it")
    for prog in test_instances():
        validate_program(prog)
    return registered_families()
