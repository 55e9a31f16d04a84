"""The model zoo's attention-only decoders (yi-6b, gemma2-9b, granite-20b,
minitron-4b, qwen2-vl-2b's text path), its MoE and MLA decoders
(olmoe-1b-7b, deepseek-v2-lite-16b), its recurrent ones (rwkv6-1.6b;
zamba2-2.7b's mamba2 backbone with one shared attention block), its
encoder-decoder (whisper-large-v3, ``EncDecLM``) and the configurations
of all ten architectures (``config.py``), which the roofline layer
prices.

``build_model(cfg, device=, generator=)`` makes a ``CausalLM`` (an
``EncDecLM`` for the encoder-decoder) with fresh parameters;
``params_from_numpy(cfg, tree)`` carries the JAX package's parameters
across."""
from .causal_lm import CausalLM
from .config import ModelConfig
from .convert import params_from_numpy
from .encdec import EncDecLM
from .model import build_model

__all__ = ["ModelConfig", "build_model", "CausalLM", "EncDecLM",
           "params_from_numpy"]
