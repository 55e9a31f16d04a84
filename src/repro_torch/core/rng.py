"""Counter-hash uniforms keyed on (seed, absolute tick, absolute lane).

The same two murmur3 fmix32 rounds as the JAX package's ``core/rng.py``, in
int32 torch tensors: multiplies and adds wrap two's-complement, and every
right shift is masked into a logical shift (torch ``>>`` on int32 is
arithmetic). The CUDA kernel computes the same hash in ``uint32_t``
(``kernels/csrc/frugal_tick.cuh``).

Python ints stand for scalars: a seed or tick given as an int becomes a 0-d
CPU int32 tensor, which PyTorch lets take part in an operation on any
device, so a per-tick hash on the card copies nothing to it.

The training path threads a JAX-style key: ``prng_key``, ``split`` and
``fold_in`` are threefry2x32 on raw uint32 key words (numpy, on the host),
giving the bits ``jax.random.PRNGKey`` / ``split`` / ``fold_in`` give under
``jax_threefry_partitionable`` (JAX's default): child ``i`` of a split and
``fold_in(key, i)`` are both ``threefry2x32(key, (0, i))``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device

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


# threefry2x32 (Salmon et al. 2011), 20 rounds, as jax.random computes it.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry2x32 block cipher of counter words (x0, x1) under the
    two key words ``key``: uint32 arrays of one shape in, two out."""
    k0, k1 = (np.uint32(w) for w in np.asarray(key, np.uint32).reshape(2))
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(_PARITY)))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two uint32 words for an int32 seed
    (JAX's default 32-bit mode): (0, the seed's bits)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32")
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """[num, 2] uint32 child keys of ``key`` (``jax.random.split``)."""
    hi, lo = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``key`` mixed with a uint32."""
    hi, lo = threefry2x32(key, np.zeros(1, np.uint32),
                          np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([hi, lo])


def tick_uniforms(key, num: int, device=None) -> torch.Tensor:
    """[num] uniforms for one stream tick (monitor fleets: one item per
    group per step): ``counter_uniform`` at t = 0 over lanes 0..num-1,
    seeded by ``seed_from_key(key)``. Fresh uniforms per step come from
    fresh key words per step. On ``device`` (None: the card)."""
    lanes = torch.arange(num, dtype=torch.int32,
                         device=resolve_device(device))
    return counter_uniform(seed_from_key(key), 0, lanes)
