"""Device resolution for the port's entry points (``platform.py``)."""
from .platform import resolve_device

__all__ = ["resolve_device"]
