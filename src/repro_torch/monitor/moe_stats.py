"""MoE router telemetry helpers: experts as the paper's GROUPBY groups
(port of the JAX package's ``monitor/moe_stats.py``)."""
from __future__ import annotations

import torch


def expert_load_groups(num_units: int, num_experts: int) -> int:
    """Group count for per-(layer, expert) load sketches."""
    return num_units * num_experts


def load_imbalance(load_q99: torch.Tensor, num_experts: int) -> torch.Tensor:
    """q99 load of the hottest expert relative to uniform (1/E)."""
    return torch.max(load_q99) * num_experts
