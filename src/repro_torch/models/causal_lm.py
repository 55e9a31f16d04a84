"""Decoder-only causal LM (port of the JAX package's
``models/causal_lm.py``, for the attention-only decoders).

Parameters, as the JAX package names them:

  embed          token embedding (the LM head when tied)
  pos            learned-position table if pos_type == 'learned'
  layers         one ``blocks.Block`` per layer, in the order the JAX
                 package's scan runs them (its ``prefix``, then
                 ``stack[j][u]`` for unit u and unit kind j)
  final_norm     output norm
  lm_head        untied output projection (if not tied)

This module owns embedding, positions (RoPE / M-RoPE / learned /
sinusoidal), the layer loop, the loss and the KV cache; all sequence
compute goes through ``blocks``. The JAX package's ``remat`` and
``unroll_layers`` are settings of its compiler and its sharding
constraints (``shard_activation``, ``seq_sharded_residual``) place
activations across a mesh; none has a meaning on one device, and the
port has none of them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import blocks
from .layers import embedding as emb_lib
from .layers import rope as rope_lib
from .layers.norm import apply_norm, norm_init, softcap


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_tree(cfg, gen: torch.Generator, device=None) -> Dict:
    """A fresh parameter tree in the port's layout (``layers`` a list):
    the JAX package's shapes and initialiser scales, the values drawn
    from ``gen``."""
    pdt = _pdt(cfg)
    tree = {"embed": emb_lib.embedding_init(gen, cfg.vocab_size,
                                            cfg.d_model, pdt, device),
            "final_norm": norm_init(cfg, cfg.d_model, pdt, device)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = emb_lib.embedding_init(gen, cfg.vocab_size,
                                                 cfg.d_model, pdt, device)
    if cfg.pos_type == "learned":
        tree["pos"] = emb_lib.learned_pos_init(gen, cfg.max_seq_len,
                                               cfg.d_model, pdt, device)
    tree["layers"] = [blocks.block_init(gen, cfg, kind, pdt, device)
                      for kind in blocks.layer_kinds(cfg)]
    return tree


class CausalLM(nn.Module):
    def __init__(self, cfg, tree: Mapping):
        super().__init__()
        self.cfg = cfg
        self.prefix_kinds, self.n_units, self.unit_kinds = \
            blocks.stage_unit_kinds(cfg)
        kinds = blocks.layer_kinds(cfg)
        if len(tree["layers"]) != len(kinds):
            raise ValueError(f"{len(tree['layers'])} layers for the "
                             f"{len(kinds)} of {cfg.name}")
        self.embed = blocks.Params(tree["embed"])
        self.final_norm = blocks.Params(tree["final_norm"])
        self.lm_head = None if cfg.tie_embeddings \
            else blocks.Params(tree["lm_head"])
        self.pos = blocks.Params(tree["pos"]) \
            if cfg.pos_type == "learned" else None
        self.layers = nn.ModuleList(blocks.Block(cfg, kind, t)
                                    for kind, t in zip(kinds,
                                                       tree["layers"]))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ------------------------------------------------------------- positions
    def _angles(self, positions: Optional[torch.Tensor], seq: int,
                batch: int):
        """cos/sin of this arch's rotary positions ((None, None) for the
        additive kinds, learned and sinusoidal, which ``forward`` and
        ``decode_step`` add to the embeddings)."""
        cfg = self.cfg
        if cfg.pos_type == "mrope":
            if positions is None:
                p1 = torch.arange(seq, dtype=torch.int32,
                                  device=self.device)[None, None, :]
                positions = p1.expand(batch, 3, seq)
            return rope_lib.mrope_angles(positions, cfg.head_dim,
                                         cfg.rope_theta, cfg.mrope_sections)
        if cfg.pos_type == "rope":
            if positions is None:
                positions = rope_lib.positions_from_segment(
                    batch, seq, device=self.device)
            return rope_lib.rope_angles(positions, cfg.head_dim,
                                        cfg.rope_theta)
        return None, None

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        """gemma2's embedding scale, sqrt(d_model) rounded to x's dtype
        first (on the host: a decode step makes no host-to-card copy)."""
        if not self.cfg.embed_scale:
            return x
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype).item()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(cfg, self.final_norm, x)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        return softcap(emb_lib.unembed(head, x), cfg.final_softcap)

    # --------------------------------------------------------------- forward
    def forward(self, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                last_only: bool = False):
        """tokens [B, S] (or embeds [B, S, D], the VLM stub path);
        positions [B, S], or [B, 3, S] for M-RoPE. Returns (float32 logits
        [B, S or 1, V], per-block stats in the JAX package's layout:
        ``stack`` a list over unit kinds of statistics stacked over
        units)."""
        cfg = self.cfg
        dt = _dt(cfg)
        x = self._scaled(emb_lib.embed(self.embed, tokens, dt)
                         if embeds is None else embeds.to(dt))
        # The JAX package constrains x's sharding here (shard_activation):
        # a placement across a mesh, with no meaning on one device.
        b, s = x.shape[0], x.shape[1]
        if cfg.pos_type == "learned":
            pos_ids = rope_lib.positions_from_segment(b, s, device=x.device)
            x = x + emb_lib.learned_pos(self.pos, pos_ids, dt)
        elif cfg.pos_type == "sinusoidal":
            x = x + rope_lib.sinusoidal_embedding(s, cfg.d_model, dt,
                                                  x.device)[None]
        cos, sin = self._angles(positions, s, b)
        stats_all, stacked = {}, []
        n_prefix = len(self.prefix_kinds)
        for i, layer in enumerate(self.layers):
            x, st = layer(x, cos, sin)
            if i < n_prefix:
                stats_all[f"prefix{i}"] = st
            else:
                stacked.append(st)
        if stacked:
            stats_all["stack"] = blocks.stack_stats(stacked,
                                                    self.unit_kinds)
        if last_only:
            x = x[:, -1:]
        return self._head(x), stats_all

    # ------------------------------------------------------------------ loss
    def loss(self, batch: Mapping[str, torch.Tensor]):
        """Next-token cross-entropy. ``batch``: tokens (or embeds),
        targets, and optionally positions and a mask. Returns (loss + aux,
        {"ce_loss", "aux_loss", "stats"}), the dict's entries detached:
        the monitors read them outside the graph."""
        logits, stats = self(tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             positions=batch.get("positions"))
        targets = batch["targets"].long()
        mask = batch.get("mask")
        logp = torch.log_softmax(logits, dim=-1)
        if self.cfg.onehot_xent:
            # H2 of the JAX package: a one-hot contraction in place of the
            # gather, which keeps the reduction local per vocab shard
            # under SPMD; the same value on one device.
            onehot = F.one_hot(targets, logp.shape[-1]).to(logp.dtype)
            nll = -torch.einsum("bsv,bsv->bs", logp, onehot)
        else:
            nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        if mask is not None:
            mask = mask.to(nll.dtype)
            loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
        else:
            loss = torch.mean(nll)
        aux_loss = _collect_aux_loss(stats, loss.device)
        stats = {k: _detached(v) for k, v in stats.items()}
        return loss + aux_loss, {"ce_loss": loss.detach(),
                                 "aux_loss": aux_loss.detach(),
                                 "stats": stats}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int,
                   dtype=None) -> List[Dict[str, torch.Tensor]]:
        """One {"k", "v"} cache per layer, zeros of the activation dtype
        on the model's device."""
        dt = dtype or _dt(self.cfg)
        return [blocks.block_cache_init(self.cfg, layer.kind, batch,
                                        max_len, dt, self.device)
                for layer in self.layers]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches, pos: int):
        """One token for the whole batch at position ``pos``: tokens
        [B, 1]. Every layer's cache is written at ``pos`` in place.
        Returns (float32 logits [B, 1, V], the caches)."""
        cfg = self.cfg
        dt = _dt(cfg)
        b = tokens.shape[0]
        dev = tokens.device
        x = self._scaled(emb_lib.embed(self.embed, tokens, dt))
        if cfg.pos_type == "learned":
            pos_ids = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
            x = x + emb_lib.learned_pos(self.pos, pos_ids, dt)
        elif cfg.pos_type == "sinusoidal":
            tbl = rope_lib.sinusoidal_embedding(cfg.max_seq_len, cfg.d_model,
                                                dt, dev)
            row = min(max(int(pos), 0), cfg.max_seq_len - 1)
            x = x + tbl[row:row + 1][None]
        if cfg.pos_type == "mrope":
            p = torch.full((b, 3, 1), pos, dtype=torch.int32, device=dev)
            cos, sin = rope_lib.mrope_angles(p, cfg.head_dim, cfg.rope_theta,
                                             cfg.mrope_sections)
        elif cfg.pos_type == "rope":
            p = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
            cos, sin = rope_lib.rope_angles(p, cfg.head_dim, cfg.rope_theta)
        else:
            cos = sin = None
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache, _ = layer.decode(x, cache, pos, cos, sin)
            new.append(cache)
        return self._head(x), new


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def _collect_aux_loss(stats, device=None) -> torch.Tensor:
    """The sum of every block's ``aux_loss`` (MoE balance terms), a
    float32 scalar; zero for the attention-only decoders."""
    total = torch.zeros((), dtype=torch.float32, device=device)

    def add(st):
        nonlocal total
        if isinstance(st, dict) and "aux_loss" in st:
            total = total + torch.sum(st["aux_loss"])

    for v in stats.values():
        if isinstance(v, dict):
            add(v)
        elif isinstance(v, (list, tuple)):
            for st in v:
                add(st)
    return total
