"""Resilience hooks of the port (``chaos``): what streaming ingest calls."""
from . import chaos
from .chaos import StreamFault, StreamInterrupted

__all__ = ["chaos", "StreamFault", "StreamInterrupted"]
