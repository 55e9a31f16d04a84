"""The port's kernels.

  frugal_update.py — the dense program kernel's wrapper (CUDA C++ in
                     csrc/, built by build.py) and its plain PyTorch
                     version.
  ops.py           — the dense entry points: frugal_update_auto (one
                     launch) and frugal_update_blocked (block_t-row
                     launches).
"""
from .frugal_update import (frugal_program_dense,
                            frugal_program_dense_reference)
from .ops import frugal_update_auto, frugal_update_blocked

__all__ = ["frugal_program_dense", "frugal_program_dense_reference",
           "frugal_update_auto", "frugal_update_blocked"]
