"""Where a port entry point runs: the CUDA card unless the caller says so.

Entry points take ``device=None`` to mean the card. Where no card is
present they raise and name ``device="cpu"`` instead of quietly running on
the host: a run that meant to measure the card must never measure the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch version on the host")
    return torch.device("cuda")
