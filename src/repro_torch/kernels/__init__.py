"""The port's kernels.

  frugal_update.py — the kernels' wrappers (CUDA C++ in csrc/, built by
                     build.py) and their plain PyTorch versions: the dense
                     program kernel and the sparse run kernel.
  ops.py           — the entry points: frugal_update_auto (one dense
                     launch at the roofline autotuner's block size),
                     frugal_update_blocked (block_t-row dense launches)
                     and frugal_update_sparse (one launch of event runs);
                     block_override, the seam that forces blocks.
"""
from .frugal_update import (frugal_program_dense,
                            frugal_program_dense_planes,
                            frugal_program_dense_reference,
                            frugal_program_scatter,
                            frugal_program_scatter_reference)
from .ops import (block_override, frugal_update_auto, frugal_update_blocked,
                  frugal_update_sparse)

__all__ = ["block_override", "frugal_program_dense",
           "frugal_program_dense_planes", "frugal_program_dense_reference",
           "frugal_program_scatter", "frugal_program_scatter_reference",
           "frugal_update_auto", "frugal_update_blocked",
           "frugal_update_sparse"]
