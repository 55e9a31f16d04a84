"""Optimizer substrate (port of the JAX package's ``optim/``): AdamW and
Lion, LR schedules, global-norm and frugal quantile clipping (the paper's
sketch applied to gradient-norm streams)."""

from .optimizer import (AdamWState, LionState, Optimizer, adamw_init,
                        adamw_update, lion_init, lion_update)
from .schedule import constant, warmup_cosine
from .clipping import (QuantileClipState, clip_by_global_norm, global_norm,
                       quantile_clip, quantile_clip_init,
                       quantile_clip_scales)

__all__ = [
    "AdamWState", "LionState", "adamw_init", "adamw_update", "lion_init",
    "lion_update", "Optimizer", "warmup_cosine", "constant",
    "global_norm", "clip_by_global_norm", "QuantileClipState",
    "quantile_clip_init", "quantile_clip", "quantile_clip_scales",
]
