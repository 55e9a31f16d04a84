"""LR schedules: pure functions of the step counter, in float32 on the
host (port of the JAX package's ``optim/schedule.py``).

Each value is the float32 the JAX function gives when its operations run
one by one: every operation rounds to float32 in the JAX expression's
order, and the cosine is the C library's ``cosf``, which XLA's CPU
backend calls. Under ``jax.jit`` XLA may rewrite a division by a constant
into a multiplication by its reciprocal and contract a multiply-add, which
moves some steps by an ulp; the port keeps the expression as written.
A schedule returns a Python float (a float32 value), which the optimizer
takes as a scalar on any device.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

_f32 = np.float32


def _load_cosf():
    """The C library's ``cosf`` from the process's own symbols (the
    interpreter links libm), or None where there is none."""
    try:
        fn = ctypes.CDLL(None).cosf
    except (OSError, AttributeError, TypeError):
        return None
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


_COSF = _load_cosf()


def _cos32(x) -> np.float32:
    if _COSF is None:   # no C cosf: the float64 cosine, rounded
        return _f32(math.cos(float(x)))
    return _f32(_COSF(float(x)))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps``."""
    peak, ff = _f32(peak_lr), _f32(final_frac)
    half_span = _f32((1 - final_frac) * 0.5)
    w = _f32(max(warmup_steps, 1))
    span = _f32(max(total_steps - warmup_steps, 1))

    def fn(step) -> float:
        s = _f32(int(step))
        if s < _f32(warmup_steps):
            return float(_f32(_f32(peak * s) / w))
        t = _f32(_f32(s - _f32(warmup_steps)) / span)
        t = min(max(t, _f32(0.0)), _f32(1.0))
        c = _cos32(_f32(_f32(np.pi) * t))
        return float(_f32(peak * _f32(ff + _f32(half_span
                                                * _f32(_f32(1.0) + c)))))
    return fn


def constant(lr: float):
    return lambda step: float(_f32(lr))
