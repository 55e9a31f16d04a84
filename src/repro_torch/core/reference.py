"""Scalar (single-group) pure-Python transcriptions of the paper's pseudocode.

These are the *C-style* algorithms exactly as printed (Algorithms 1-3) and act
as the ground-truth oracles for the vectorized PyTorch implementations and the
CUDA kernel: fed the same uniforms, all three layers must agree bit-exactly.
The port's copy of the JAX package's ``core/reference.py``, statement for
statement (standard library only).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence
import math


def frugal1u_median_scalar(stream: Iterable[float], m: float = 0.0) -> float:
    """Paper Algorithm 1 (Frugal-1U-Median): deterministic, no randomness."""
    for s in stream:
        if s > m:
            m += 1
        elif s < m:
            m -= 1
    return m


def frugal1u_scalar(
    stream: Sequence[float],
    rands: Sequence[float],
    quantile: float = 0.5,
    m: float = 0.0,
    trace: Optional[List[float]] = None,
) -> float:
    """Paper Algorithm 2 (Frugal-1U) with externally supplied uniforms."""
    q = quantile
    for s, r in zip(stream, rands):
        if s > m and r > 1.0 - q:
            m += 1
        elif s < m and r > q:
            m -= 1
        if trace is not None:
            trace.append(m)
    return m


def frugal2u_scalar(
    stream: Sequence[float],
    rands: Sequence[float],
    quantile: float = 0.5,
    m: float = 0.0,
    step: float = 1.0,
    sign: float = 1.0,
    trace: Optional[List[float]] = None,
) -> float:
    """Paper Algorithm 3 (Frugal-2U), f(step) = 1 (constant additive update).

    Literal transcription, including overshoot clamp (lines 7-10 / 18-21) and
    the direction-flip step reset (lines 11-13 / 22-24).
    """
    q = quantile
    for s, r in zip(stream, rands):
        if s > m and r > 1.0 - q:
            step += 1.0 if sign > 0 else -1.0              # line 5
            m += math.ceil(step) if step > 0 else 1.0      # line 6
            if m > s:                                      # line 7
                step += s - m                              # line 8
                m = s                                      # line 9
            if sign < 0 and step > 1:                      # lines 11-13
                step = 1.0
            sign = 1.0                                     # line 14
        elif s < m and r > q:
            step += 1.0 if sign < 0 else -1.0              # line 16
            m -= math.ceil(step) if step > 0 else 1.0      # line 17
            if m < s:                                      # line 18
                step += m - s                              # line 19
                m = s                                      # line 20
            if sign > 0 and step > 1:                      # lines 22-24
                step = 1.0
            sign = -1.0                                    # line 25
        if trace is not None:
            trace.append(m)
    return m


def relative_mass_error(estimate: float, sorted_stream: Sequence[float], quantile: float) -> float:
    """Paper §7 metric: rank mass of the estimate minus the target quantile.

    "if the estimate of 90-% quantile turned out to be 89-% quantile the error
    is then 0.01" (signed: negative = under-estimate). Rank uses R(x) =
    #{s_i < x} (paper §2) normalized by stream length; ties (items == x) count
    half to match the upper-median convention without biasing either side.
    """
    import bisect

    n = len(sorted_stream)
    if n == 0:
        return 0.0
    lo = bisect.bisect_left(sorted_stream, estimate)
    hi = bisect.bisect_right(sorted_stream, estimate)
    mass = (lo + hi) / 2.0 / n
    return mass - quantile
