"""Core arithmetic of the port (the JAX package's ``core/``, module for
module):

  frugal.py     — Frugal-1U / Frugal-2U ticks and the program-generic
                  ingest loop (program_process_seeded / TickCtx).
  program.py    — LaneProgram / StateLayout and the registry of the six
                  lane programs.
  reference.py  — scalar pure-Python transcriptions (bit-exact oracles).
  sketch.py     — GroupedQuantileSketch.
  rng.py        — the counter-hash uniforms shared with the CUDA kernels,
                  and threefry2x32 split / fold_in of JAX-style key words
                  (the training path's keys).
  packing.py    — (step, sign) -> one int32 word.
  drift.py      — decayed 2U and the two-sketch window.
  streaming.py  — chunked dense-kernel ingest of unbounded streams.
  batched.py    — the binomial batch update behind
                  GroupedQuantileSketch.ingest_tensor (its normals from a
                  torch.Generator: a distributional contract).
  baselines/    — GK, q-digest, Selection, reservoir, exact (paper §6).
"""

from .frugal import (
    Frugal1UState,
    Frugal2UState,
    TickCtx,
    frugal1u_init,
    frugal1u_process,
    frugal1u_update,
    frugal2u_init,
    frugal2u_process,
    frugal2u_update,
    program_process_seeded,
)
from .program import (
    LaneProgram,
    StateLayout,
    make_program,
    program_for,
    registered_families,
)
from .sketch import GroupedQuantileSketch, PackedSketchState
from .batched import batched_frugal2u_update
from .drift import DriftConfig, WindowState
from .packing import (
    PackedFrugal2UState,
    pack_frugal2u,
    pack_step_sign,
    unpack_frugal2u,
    unpack_step_sign,
)
from .streaming import ingest_array, ingest_stream

__all__ = [
    "Frugal1UState",
    "Frugal2UState",
    "TickCtx",
    "frugal1u_init",
    "frugal1u_process",
    "frugal1u_update",
    "frugal2u_init",
    "frugal2u_process",
    "frugal2u_update",
    "program_process_seeded",
    "batched_frugal2u_update",
    "LaneProgram",
    "StateLayout",
    "make_program",
    "program_for",
    "registered_families",
    "GroupedQuantileSketch",
    "PackedSketchState",
    "DriftConfig",
    "WindowState",
    "PackedFrugal2UState",
    "pack_frugal2u",
    "pack_step_sign",
    "unpack_frugal2u",
    "unpack_step_sign",
    "ingest_array",
    "ingest_stream",
]
