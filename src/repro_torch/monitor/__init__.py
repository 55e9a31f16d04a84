"""Frugal telemetry (port of the JAX package's ``monitor/``): the paper's
GROUPBY quantile sketches woven into training, 2 words per group."""

from .registry import (TrainMonitors, init_train_monitors, monitor_summary,
                       update_train_monitors)
from .moe_stats import expert_load_groups, load_imbalance

__all__ = ["TrainMonitors", "init_train_monitors", "update_train_monitors",
           "monitor_summary", "expert_load_groups", "load_imbalance"]
