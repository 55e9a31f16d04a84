"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE, and the
fixed sinusoidal table (port of the JAX package's ``models/layers/rope.py``).

M-RoPE (arXiv:2409.12191) splits the head_dim/2 frequency slots into
(temporal, height, width) sections; each section reads its coordinate of
the 3-D position id. For text, t == h == w == pos and M-RoPE is RoPE.
"""
from __future__ import annotations

import itertools
import math
from typing import Tuple

import torch


def _freq(dim: int, theta: float, device) -> torch.Tensor:
    half = dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> cos/sin [..., S, dim//2] (float32)."""
    ang = positions.float()[..., None] * _freq(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D//2], cast to x's dtype first."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos_ = cos[:, :, None, :].to(x.dtype)
    sin_ = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos_ - x2 * sin_, x1 * sin_ + x2 * cos_], dim=-1)


def mrope_angles(positions: torch.Tensor, dim: int, theta: float,
                 sections: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, 3, S] (t, h, w) -> M-RoPE cos/sin [B, S, dim//2].

    ``sections`` sums to dim//2; frequency slot j reads the coordinate of
    the section it falls in (the JAX package selects it by a one-hot
    contraction, which picks the same float32 value)."""
    half = dim // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} do not sum to {half}")
    dev = positions.device
    ang = positions.float()[..., None] * _freq(dim, theta, dev)
    # sect_id[j]: the section slot j falls in (made on the device: no
    # host copy, so a decode step never waits for the card).
    j = torch.arange(half, device=dev)
    sect_id = sum(((j >= b).long() for b in
                   itertools.accumulate(sections[:-1])), torch.zeros_like(j))
    # [B, C, S, half] -> [B, S, half]: slot j from coordinate sect_id[j].
    idx = sect_id.view(1, 1, 1, half).expand(ang.shape[0], 1, ang.shape[2],
                                             half)
    ang = torch.gather(ang, 1, idx)[:, 0]
    return torch.cos(ang), torch.sin(ang)


def positions_from_segment(batch: int, seq: int, offset: int = 0,
                           device=None) -> torch.Tensor:
    return torch.arange(offset, offset + seq, dtype=torch.int32,
                        device=device)[None, :].repeat(batch, 1)


def sinusoidal_embedding(seq: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table [seq, dim]."""
    half = dim // 2
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / (half - 1))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
