"""Roofline analysis: the per-platform hardware registry and model
pricing, the dense kernel's model on a CUDA card, the block autotuner,
the dry run's traced cost and placement collectives (``trace_cost``, the
counterpart of the JAX package's ``hlo_parse``: the port has no HLO to
parse) and the dry-run reporter."""

from .analysis import (
    HW_REGISTRY,
    HwSpec,
    RooflineUnknownHardware,
    analytic_hbm_bytes,
    detect_hw,
    hw_for,
    match_device_kind,
    model_flops,
    roofline_terms,
)
from .kernel_model import (
    dense_plan,
    kernel_bytes_per_item,
    kernel_bytes_total,
    operation_bound_ms,
    predict_kernel,
    smem_footprint_bytes,
)
from .autotune import (autotune_blocks, autotune_cache_info,
                       clear_autotune_cache)
from .trace_cost import (collective_bytes, placement_collectives,
                         traced_cost)

__all__ = [
    "HW_REGISTRY",
    "HwSpec",
    "RooflineUnknownHardware",
    "analytic_hbm_bytes",
    "detect_hw",
    "hw_for",
    "match_device_kind",
    "model_flops",
    "roofline_terms",
    "dense_plan",
    "kernel_bytes_per_item",
    "kernel_bytes_total",
    "operation_bound_ms",
    "predict_kernel",
    "smem_footprint_bytes",
    "autotune_blocks",
    "autotune_cache_info",
    "clear_autotune_cache",
    "collective_bytes",
    "placement_collectives",
    "traced_cost",
]
