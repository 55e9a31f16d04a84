"""Roofline-driven (block_g, block_t) autotuner for the dense kernel.

Deterministic and model-driven — no on-device timing sweep. In the port's
terms ``block_g`` is threads per CUDA block (a multiple of 32 in [32,
1024]; candidates the powers of two) and ``block_t`` is ``t``: B1 keeps
the state on chip for the whole stream, and kernel_model prices every
shorter ``block_t`` as more launches and more state traffic, nothing
else. The rules are the JAX package's, translated:

  * skip a ``block_g`` whose plan asks more shared memory than the kernel
    allows (kernel_model.SMEM_MAX, ``FT_DENSE_SMEM_MAX``);
  * keep enough blocks to occupy every SM (``HwSpec.cores``): a larger
    block that leaves SMs idle is skipped, the smallest never is;
  * take the argmin of kernel_model.predict_kernel's ``predicted_s``, ties
    broken toward ``DEFAULT_BLOCK_G`` (256, the block size of the
    kernel's sweep on an H100), then toward the larger block.

Results are cached per (family base, layout, hw, g, t, q) via lru_cache,
so ``frugal_update_auto`` pays the model once per shape class. On hardware
the registry doesn't know (HwSpec 'unknown') the tuner does NOT guess a
prediction — it returns ``(DEFAULT_BLOCK_G, t)``.

Bit-exactness: blocking only changes the launch shape, never the update
math — the counter-hash RNG keys on absolute (tick, lane), so tuned blocks
are just another cut of the same call.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

from repro_torch.kernels.frugal_update import DEFAULT_BLOCK_G
from repro_torch.roofline.analysis import HwSpec, detect_hw, hw_for
from repro_torch.roofline.kernel_model import (SMEM_MAX, predict_kernel,
                                               smem_footprint_bytes)

_BLOCK_G_CANDIDATES = (32, 64, 128, 256, 512, 1024)


@functools.lru_cache(maxsize=1024)
def _tuned(family_base_name: str, layout, hw_name: str,
           g: int, t: int, q: int) -> Tuple[int, int]:
    hw = hw_for(hw_name)
    block_t = max(t, 1)
    if not hw.known:
        return (DEFAULT_BLOCK_G, block_t)
    best = None
    for bg in _BLOCK_G_CANDIDATES:
        if smem_footprint_bytes(block_t, g, q, block_g=bg) > SMEM_MAX:
            continue
        pred = predict_kernel(g, block_t, q, layout, block_g=bg,
                              block_t=block_t, hw=hw)
        # keep enough blocks to occupy every SM
        if pred["grid"][0] < hw.cores and bg > _BLOCK_G_CANDIDATES[0]:
            continue
        key = (pred["predicted_s"],
               abs(math.log2(bg / DEFAULT_BLOCK_G)), -bg)
        if best is None or key < best[0]:
            best = (key, (bg, block_t))
    # the smallest block always fits and is never skipped for idle SMs
    return best[1]


def autotune_blocks(program, g: int, t: int, q: int = 1, *,
                    hw: Optional[HwSpec] = None) -> Tuple[int, int]:
    """Tuned (block_g, block_t) for running ``program`` over [t, g] items
    with q lanes per group (``lanes_per_group``) on ``hw`` (default: the
    detected local device).

    Cached per (family_base, layout, hw, g, t, q); the family_base keying
    means parameter variants of one family (decay rates, window sizes)
    share a tuning entry, as they share a kernel instantiation."""
    from repro_torch.core.program import family_base

    hw = hw or detect_hw()
    base = family_base(program.family)
    return _tuned(base.family, program.layout, hw.name,
                  int(g), int(t), int(q))


def autotune_cache_info():
    """lru_cache statistics — test seam for hit/miss behavior."""
    return _tuned.cache_info()


def clear_autotune_cache() -> None:
    _tuned.cache_clear()
