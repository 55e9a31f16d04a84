"""Model configurations (``config.py``): the JAX package's ``ModelConfig``,
which the roofline layer prices. The model zoo itself is not ported."""
from .config import ModelConfig

__all__ = ["ModelConfig"]
