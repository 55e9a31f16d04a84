"""Where a port entry point runs, and what the local device is.

Entry points take ``device=None`` to mean the card. Where no card is
present they raise and name ``device="cpu"`` instead of quietly running on
the host: a run that meant to measure the card must never measure the CPU
(``resolve_device``).

``detect_platform`` and ``detect_device_kind`` are the detection seam of
the JAX package's ``configs/platform.py``: ``roofline.analysis.detect_hw``
maps the kind string onto its hardware registry, and reports stamp both.
They only describe the device. Nothing on a run path routes on them: a
missing card reads as "cpu" here, while every entry point still goes
through ``resolve_device`` and raises.

The JAX module's ``set_platform``, ``set_cpu_devices`` and
``GPU_XLA_FLAGS`` pin JAX's backend and install XLA flags before its
first device init; PyTorch has neither a backend to pin (every call names
its device) nor XLA flags, and the port's counterpart of a forced host
device count is a ``TopologySpec`` of repeated ``"cpu"`` devices. They
are not ported.
"""
from __future__ import annotations

from typing import Optional

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


def detect_platform(device=None) -> str:
    """The platform of ``device``: "gpu" for a CUDA device, "cpu" for the
    host, else the device type. ``None`` means the card where
    ``torch.cuda.is_available()``, else the host. Never raises."""
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def detect_device_kind(device=None) -> str:
    """The hardware kind string of ``device`` (e.g. "NVIDIA H100 80GB
    HBM3", from ``torch.cuda.get_device_name``; "cpu" for the host) —
    what ``roofline.analysis`` matches against its registry. ``None``
    means the device ``detect_platform(None)`` names."""
    if detect_platform(device) != "gpu":
        return "cpu" if device is None else torch.device(device).type
    dev = torch.device("cuda") if device is None else torch.device(device)
    return torch.cuda.get_device_name(dev)


def compiled_kernel_platforms() -> tuple:
    """Platforms the port's hand-written kernels build for: CUDA only
    (on the CPU every wrapper runs its plain version)."""
    return ("gpu",)


def supports_compiled_kernels(platform: Optional[str] = None) -> bool:
    return (detect_platform() if platform is None
            else platform) in compiled_kernel_platforms()
