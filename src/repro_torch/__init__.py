"""repro_torch — the frugal streaming quantile system on PyTorch and CUDA.

A port of the JAX package ``repro`` that keeps its module layout and public
names. The dense per-group ingest path and the sparse event path (per-lane
clocks, ``serve.SLOFleet``) run on an NVIDIA Hopper card through two
hand-written CUDA kernels (``kernels/csrc/frugal_update.cu``,
``kernels/csrc/frugal_scatter.cu``); every module keeps a plain PyTorch
version of the same arithmetic, which the CPU tests hold bit-for-bit
against the JAX package. Fleets survive faults as the JAX package's do:
seeded fault plans and lane health (``resilience``), and format-4
checkpoints (``train.checkpoint``) that either package restores. The
streaming service (``service``) runs on them: put-ahead staging of host
chunks (``data.pipeline``), copy-on-query snapshots and DP-gated tenant
reads that replay bit for bit.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``configs.platform.resolve_device``). The roofline layer
(``roofline``) prices the dense kernel on the detected card and chooses
its block size; ``configs`` and ``models.config`` hold the published model
configurations it prices. ``models`` runs the attention-only decoders of
the model zoo, which ``serve.ServeEngine`` serves (``launch.serve`` is its
driver), with each route's SLO quantiles in an ``SLOFleet``, and trains
them (``train``, ``optim``, ``monitor``; ``launch.train`` is the driver)
with the paper's sketch inside the step: a Frugal-2U q95 of each block's
gradient norm clips the gradients, and frugal fleets track activation
statistics.
"""

# The subpackages, entry point first (``from repro_torch import *`` imports
# them; ``import repro_torch`` alone imports none).
__all__ = ["api", "service", "serve", "data", "resilience", "train",
           "optim", "monitor", "core", "kernels", "roofline", "configs",
           "models", "launch"]
