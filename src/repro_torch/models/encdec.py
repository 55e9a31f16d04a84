"""Whisper-style encoder-decoder LM (port of the JAX package's
``models/encdec.py``).

The audio frontend is a stub, as in the JAX package: ``encode`` takes
precomputed frame embeddings [B, S_enc, D] (what whisper's two strided
convolutions would produce). Encoder: bidirectional attention over the
frames plus the fixed sinusoidal table. Decoder: causal self-attention,
cross-attention over the encoder's memory, learned positions; the head is
the tied embedding, in float32.

Parameters, as the JAX package names them:

  embed          token embedding (and the head)
  dec_pos        the decoder's learned positions (``max_seq_len`` rows)
  enc_stack      one ``blocks.Block`` of kind ``enc_attn`` per encoder
                 layer (the JAX package stacks each leaf on a leading
                 [enc_layers] axis and scans it)
  dec_stack      one ``dec_cross`` block per decoder layer, likewise
  enc_norm       the encoder's output norm
  dec_norm       the decoder's output norm

``forward`` returns the decoder's per-block stats only, in the scan's
layout (``{"stack": {"absmax": [dec_layers], "rms": [dec_layers]}}``):
the JAX package drops the encoder's. Decode recomputes each layer's
cross-attention K and V from ``memory`` at every call; there is no
cross-attention cache.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from . import blocks
from .causal_lm import _detached, _dt, _pdt
from .layers import embedding as emb_lib
from .layers import rope as rope_lib
from .layers.norm import apply_norm, norm_init


def init_tree(cfg, gen: torch.Generator, device=None) -> Dict:
    """A fresh parameter tree in the port's layout (each stack a list of
    per-layer trees): the JAX package's shapes and initialiser scales,
    the values drawn from ``gen``."""
    pdt = _pdt(cfg)
    return {
        "embed": emb_lib.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        pdt, device),
        "dec_pos": emb_lib.learned_pos_init(gen, cfg.max_seq_len,
                                            cfg.d_model, pdt, device),
        "enc_stack": [blocks.block_init(gen, cfg, "enc_attn", pdt, device)
                      for _ in range(cfg.enc_layers)],
        "dec_stack": [blocks.block_init(gen, cfg, "dec_cross", pdt, device)
                      for _ in range(cfg.dec_layers)],
        "enc_norm": norm_init(cfg, cfg.d_model, pdt, device),
        "dec_norm": norm_init(cfg, cfg.d_model, pdt, device),
    }


class EncDecLM(nn.Module):
    def __init__(self, cfg, tree: Mapping):
        super().__init__()
        self.cfg = cfg
        for key, n in (("enc_stack", cfg.enc_layers),
                       ("dec_stack", cfg.dec_layers)):
            if len(tree[key]) != n:
                raise ValueError(f"{len(tree[key])} {key} layers for the "
                                 f"{n} of {cfg.name}")
        self.embed = blocks.Params(tree["embed"])
        self.dec_pos = blocks.Params(tree["dec_pos"])
        self.enc_stack = nn.ModuleList(blocks.Block(cfg, "enc_attn", t)
                                       for t in tree["enc_stack"])
        self.dec_stack = nn.ModuleList(blocks.Block(cfg, "dec_cross", t)
                                       for t in tree["dec_stack"])
        self.enc_norm = blocks.Params(tree["enc_norm"])
        self.dec_norm = blocks.Params(tree["dec_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S_enc, D] (the stub frontend's output) -> memory
        [B, S_enc, D] in the activation dtype."""
        cfg = self.cfg
        dt = _dt(cfg)
        x = frames.to(dt)
        x = x + rope_lib.sinusoidal_embedding(x.shape[1], cfg.d_model, dt,
                                              x.device)[None]
        for layer in self.enc_stack:
            x, _ = layer(x)
        return apply_norm(cfg, self.enc_norm, x)

    def forward(self, frames: torch.Tensor, dec_tokens: torch.Tensor):
        """frames [B, S_enc, D], dec_tokens [B, S]. Returns (float32 logits
        [B, S, V], the decoder's per-block stats in the JAX scan's
        layout)."""
        cfg = self.cfg
        dt = _dt(cfg)
        memory = self.encode(frames)
        b, s = dec_tokens.shape
        x = emb_lib.embed(self.embed, dec_tokens, dt)
        pos_ids = rope_lib.positions_from_segment(b, s, device=x.device)
        x = x + emb_lib.learned_pos(self.dec_pos, pos_ids, dt)
        stats = []
        for layer in self.dec_stack:
            x, st = layer(x, memory=memory)
            stats.append(st)
        x = apply_norm(cfg, self.dec_norm, x)
        logits = emb_lib.unembed(self.embed, x)
        return logits, {"stack": blocks.stack_stats(stats, ("dec_cross",))[0]}

    def loss(self, batch: Mapping[str, torch.Tensor]):
        """Mean next-token cross-entropy over ``batch``'s frames, tokens
        and targets (no mask). Returns (loss, {"ce_loss", "aux_loss" (zero),
        "stats"}), the dict's entries detached."""
        logits, stats = self(batch["frames"], batch["tokens"])
        targets = batch["targets"].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        loss = torch.mean(nll)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"ce_loss": loss.detach(), "aux_loss": aux,
                      "stats": _detached(stats)}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int,
                   dtype=None) -> List[Dict[str, torch.Tensor]]:
        """One {"k", "v"} [B, max_len, Hkv, hd] per decoder layer (its
        self-attention's), zeros on the model's device."""
        dt = dtype or _dt(self.cfg)
        return [blocks.block_cache_init(self.cfg, "dec_cross", batch,
                                        max_len, dt, self.device)
                for _ in self.dec_stack]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches, pos: int,
                    memory: torch.Tensor):
        """One token for the whole batch at position ``pos``: tokens
        [B, 1], ``memory`` [B, S_enc, D] from ``encode``. The caches are
        updated in place. Returns (float32 logits [B, 1, V], the
        caches)."""
        cfg = self.cfg
        dt = _dt(cfg)
        b = tokens.shape[0]
        x = emb_lib.embed(self.embed, tokens, dt)
        pos_ids = torch.full((b, 1), pos, dtype=torch.int32,
                             device=tokens.device)
        x = x + emb_lib.learned_pos(self.dec_pos, pos_ids, dt)
        new = []
        for layer, cache in zip(self.dec_stack, caches):
            x, cache, _ = layer.decode(x, cache, pos, memory=memory)
            new.append(cache)
        x = apply_norm(cfg, self.dec_norm, x)
        return emb_lib.unembed(self.embed, x), new
