"""Token embeddings, output heads, and learned / sinusoidal position
tables (port of the JAX package's ``models/layers/embedding.py``)."""
from __future__ import annotations

import torch

from .rope import sinusoidal_embedding


def normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``scale`` times a standard normal draw from ``gen`` (the JAX
    package's initialisers draw ``jax.random.normal * scale``)."""
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(scale)


def embedding_init(gen, vocab: int, d: int, dtype=torch.float32,
                   device=None):
    return {"table": normal(gen, (vocab, d), 0.02, dtype, device)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The table cast to the activation dtype, then gathered."""
    return params["table"].to(dtype)[tokens.long()]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied or untied LM head: x [B, S, D] @ table.T -> [B, S, V], in
    float32."""
    return torch.matmul(x.float(), params["table"].float().t())


def learned_pos_init(gen, max_len: int, d: int, dtype=torch.float32,
                     device=None):
    return {"pos_table": normal(gen, (max_len, d), 0.02, dtype, device)}


def learned_pos(params, positions: torch.Tensor, dtype) -> torch.Tensor:
    """positions [B, S] -> [B, S, D]. A position past the table reads its
    last row, as the JAX package's gather clamps."""
    table = params["pos_table"]
    return table.to(dtype)[positions.long().clamp(0, table.shape[0] - 1)]


def sinusoidal_pos(seq: int, d: int, offset: int, dtype,
                   device=None) -> torch.Tensor:
    """Rows offset .. offset + seq of the fixed sinusoidal table."""
    return sinusoidal_embedding(offset + seq, d, dtype, device)[offset:]
