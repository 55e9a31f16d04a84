"""Counter-hash uniforms keyed on (seed, absolute tick, absolute lane).

The same two murmur3 fmix32 rounds as the JAX package's ``core/rng.py``, in
int32 torch tensors: multiplies and adds wrap two's-complement, and every
right shift is masked into a logical shift (torch ``>>`` on int32 is
arithmetic). The CUDA kernel computes the same hash in ``uint32_t``
(``kernels/csrc/frugal_tick.cuh``).

Python ints stand for scalars: a seed or tick given as an int becomes a 0-d
CPU int32 tensor, which PyTorch lets take part in an operation on any
device, so a per-tick hash on the card copies nothing to it.
"""
from __future__ import annotations

import numpy as np
import torch

_M1 = int(np.uint32(0x85EBCA6B).view(np.int32))
_M2 = int(np.uint32(0xC2B2AE35).view(np.int32))
_C_TICK = int(np.uint32(0x9E3779B9).view(np.int32))   # golden ratio
_C_GROUP = int(np.uint32(0x85EBCA77).view(np.int32))
_EXP_ONE = 0x3F800000                                   # f32 bits of 1.0


def _i32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"counter operands must be int32, got {x.dtype}")
        return x
    return torch.tensor(wrap_i32(int(x)), dtype=torch.int32)


def srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int32 tensor by 0 < k < 32."""
    return (h >> k) & ((1 << (32 - k)) - 1)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: bijective full-avalanche mix of an int32 word."""
    h = h ^ srl(h, 16)
    h = h * _M1
    h = h ^ srl(h, 13)
    h = h * _M2
    return h ^ srl(h, 16)


def tick_hash(seed, t) -> torch.Tensor:
    """The first round of ``counter_bits``: it depends on (seed, t) only,
    so the dense kernel computes it once per tick for all lanes."""
    return _fmix32(_i32(seed) + _i32(t) * _C_TICK)


def counter_bits(seed, t, g) -> torch.Tensor:
    """Raw int32 hash word for stream position (t, g) under ``seed``."""
    return _fmix32(tick_hash(seed, t) + _i32(g) * _C_GROUP)


def counter_uniform(seed, t, g) -> torch.Tensor:
    """Uniform in [0, 1): the top 23 hash bits fill the mantissa of a float
    in [1, 2), and 1 is subtracted — exact, no division."""
    mant = srl(counter_bits(seed, t, g), 9) | _EXP_ONE
    return mant.view(torch.float32) - 1.0


def wrap_i32(n: int) -> int:
    """Fold an unbounded Python tick counter into int32 two's-complement."""
    n = int(n) & 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def seed_from_key(key) -> int:
    """One int32 counter seed from an int seed or from uint32 key words.

    An int must lie in int32 range and is the seed itself. Key words (a
    numpy array or sequence of uint32, e.g. ``jax.random.key_data`` of a
    key) fold exactly as the JAX package folds them: word 0, then
    ``fmix32(seed * C_TICK + word_i)`` for each further word.
    """
    if isinstance(key, (int, np.integer)):
        key = int(key)
        if not -2 ** 31 <= key < 2 ** 31:
            raise ValueError(f"int seed {key} is outside int32")
        return key
    words = np.asarray(key)
    if words.dtype not in (np.uint32, np.int32):
        raise TypeError(f"key words must be uint32, got {words.dtype}")
    data = torch.from_numpy(words.reshape(-1).view(np.int32).copy())
    if data.numel() == 0:
        raise ValueError("key has no words")
    seed = data[0]
    for i in range(1, data.numel()):
        seed = _fmix32(seed * _C_TICK + data[i])
    return int(seed)
