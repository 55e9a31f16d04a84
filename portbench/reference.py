"""The plain reference that decides ``correct``: the lane programs of
``programs/`` driven over the cell's inputs in plain torch.

It imports nothing of the system under test. It keys each coin flip on
the counter hash the system documents (two rounds of murmur3's fmix32 over
(seed, tick) and then the absolute lane id; the top 23 bits fill the
mantissa of a float in [1, 2), minus 1), here in int64 arithmetic masked
to 32 bits. It takes from the system only the states it judges and the
inputs the benchmark made itself.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_C_TICK, _C_LANE = 0x9E3779B9, 0x85EBCA77
_EXP_ONE = 0x3F800000
PROGRAMS = Path(__file__).resolve().parent / "programs"
# The control's precision: the one below the float32 the configurations
# state.
CONTROL_DTYPE = torch.bfloat16


def load_program(name: str):
    """The reference of lane program ``name`` (``programs/<name>.py``)."""
    path = PROGRAMS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reference for lane program {name!r} under "
                         f"{PROGRAMS}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.programs.p{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mul32(h, c: int):
    """(h * c) mod 2^32 for 0 <= h < 2^32, without leaving int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & MASK


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def tick_hash(seed: int, t):
    """First round of the hash: (seed, tick); ints or int64 tensors."""
    return _fmix32(((seed & MASK) + _mul32(t & MASK, _C_TICK)) & MASK)


def lane_key(lanes):
    """The lane's term of the second round, for int64 absolute lane ids
    (a tensor)."""
    return _mul32(lanes & MASK, _C_LANE)


def uniform(first_round, key):
    """float32 uniforms in [0, 1) from a first-round hash and lane keys
    (int64 tensors)."""
    mant = (_fmix32((first_round + key) & MASK) >> 9) | _EXP_ONE
    return mant.to(torch.int32).view(torch.float32) - 1.0


def lane_quantiles(quantiles, lanes):
    """Each lane's float32 target: lane g * Q + i tracks quantiles[i]."""
    qs = torch.tensor(quantiles, dtype=torch.float32, device=lanes.device)
    return qs[lanes % qs.numel()]


def dense(prog, planes, items, t0: int, seed: int, quantiles, *,
          dtype=torch.float32):
    """Apply a [T, G] item block (torch, on any device) to the planes of
    all G * Q lanes, one tick a row from absolute tick ``t0``, each group's
    item fanned out to its Q lanes; then store the state as a dense call
    does. ``dtype`` is the precision the ticks run in (float32, or lower
    for the control). Returns float32 planes."""
    t_len, groups = items.shape
    nq = len(quantiles)
    dev = items.device
    lanes = torch.arange(groups * nq, dtype=torch.int64, device=dev)
    key = lane_key(lanes)
    q = lane_quantiles(quantiles, lanes).to(dtype)
    planes = tuple(p.to(dtype) for p in planes)
    for r in range(t_len):
        u = uniform(tick_hash(seed, t0 + r), key).to(dtype)
        x = items[r].repeat_interleave(nq).to(dtype)
        planes = prog.tick(planes, x, u, q)
    planes = prog.canonical(planes)
    return tuple(p.to(torch.float32) for p in planes)


def lanes_differ(got, want) -> int:
    """Lanes where any float32 plane differs in its bits (numpy or torch
    planes of one length)."""
    bad = None
    for a, b in zip(got, want):
        a, b = _np_f32(a), _np_f32(b)
        d = a.view(np.int32) != b.view(np.int32)
        bad = d if bad is None else bad | d
    return int(bad.sum()) if bad is not None else 0


def _np_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float32)
