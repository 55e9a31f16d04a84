"""Frugal-2U's (step, sign) pair packed into one int32 word.

Same encoding as the JAX package's ``core/packing.py``: the direction bit
hides in float32 exponent space that real step values never use.

  * |step| < 2^-63, zero or NaN: ``0`` (sign > 0) or ``0x80000000`` (sign < 0);
  * normal |step| in [2^-63, 2^32): ``bits(step)`` for sign > 0,
    ``bits(step) + (96 << 23)`` for sign < 0 (biased exponents 64..158 and
    160..254 never overlap);
  * |step| >= 2^32, including ±inf, saturates to ``_MAX_STEP`` first.

In-domain values round-trip bit-exactly. int32 tensors throughout, with
right shifts masked into logical shifts.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .rng import srl

_EXP_SHIFT = 23
_EXP_MASK = 0xFF
_EXP_OFFSET = 96 << 23
_EXP_MIN = 64                   # |step| >= 2^-63
_NEG_THRESHOLD = 160            # decoded e' >= 160  =>  sign < 0
_ZERO_NEG = -2 ** 31            # 0x80000000
# Largest float32 below 2^32 (biased exponent 158).
_MAX_STEP = float(np.float32(2.0 ** 32 * (1.0 - 2.0 ** -24)))


def pack_step_sign(step: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """(step f32, sign ±1 f32) -> one int32 word per lane."""
    step = torch.where(torch.isnan(step), 0.0,
                       torch.clamp(step, -_MAX_STEP, _MAX_STEP))
    sb = step.to(torch.float32).contiguous().view(torch.int32)
    e = srl(sb, _EXP_SHIFT) & _EXP_MASK
    neg = sign < 0
    packed_tiny = torch.where(neg, _ZERO_NEG, 0).to(torch.int32)
    packed_norm = sb + torch.where(neg, _EXP_OFFSET, 0).to(torch.int32)
    return torch.where(e < _EXP_MIN, packed_tiny, packed_norm)


def unpack_step_sign(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_step_sign``: int32 word -> (step f32, sign ±1 f32)."""
    if packed.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {packed.dtype}")
    e = srl(packed, _EXP_SHIFT) & _EXP_MASK
    is_zero = e == 0
    is_neg_dir = e >= _NEG_THRESHOLD
    sb = torch.where(is_zero, 0,
                     torch.where(is_neg_dir, packed - _EXP_OFFSET, packed))
    step = sb.to(torch.int32).contiguous().view(torch.float32)
    neg = is_neg_dir | (is_zero & (packed < 0))
    sign = torch.where(neg, -1.0, 1.0).to(torch.float32)
    return step, sign


def step_sign_word_canonical(packed: torch.Tensor) -> torch.Tensor:
    """Bool mask: True where ``packed`` is a word ``pack_step_sign`` can
    emit, i.e. where decode and re-encode give the same bits."""
    return pack_step_sign(*unpack_step_sign(packed)) == packed


class PackedFrugal2UState(NamedTuple):
    """Serialized Frugal-2U lanes: exactly two words per lane."""

    m: torch.Tensor           # [L] float32 estimate
    step_sign: torch.Tensor   # [L] int32, (step, sign) packed


def pack_frugal2u(state) -> PackedFrugal2UState:
    """``core.frugal.Frugal2UState`` -> two-words-per-lane form."""
    return PackedFrugal2UState(
        m=state.m, step_sign=pack_step_sign(state.step, state.sign))


def unpack_frugal2u(packed: PackedFrugal2UState):
    from .frugal import Frugal2UState

    step, sign = unpack_step_sign(packed.step_sign)
    return Frugal2UState(m=packed.m, step=step, sign=sign)
