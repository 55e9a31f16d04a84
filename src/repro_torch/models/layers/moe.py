"""Mixture-of-Experts with sequence-local capacity dispatch (port of the
JAX package's ``models/layers/moe.py``).

Each sequence routes its tokens on its own: a top-k of the router's
softmax, a stable argsort of its S*K (token, expert) assignments by
expert, and a scatter into its own [E, cap+1, D] capacity buffer, cap =
int(capacity_factor * S * K / E) + 1. An assignment past an expert's cap
is dropped: it writes the overflow slot ``cap``, which no one reads, and
gets weight 0. The experts' FFNs run over ``buf[:, :, :cap]`` as batched
products; the combine gathers each assignment's output back and sums a
token's K contributions. The JAX package ``vmap``s the dispatch over the
batch; the port does the same index arithmetic batched over B.

Routing is discrete, so the port makes the same choices as the JAX
package, not merely close ones: the top-k is a stable descending sort
(ties go to the lower expert index, as ``jax.lax.top_k`` breaks them),
the assignment sort is stable and the segment starts are left-side
``searchsorted``. The load statistics are computed as XLA computes the
JAX package's: a mean is the sum times the float32 reciprocal of the
count, a division by a constant under ``jit`` is a multiply by its
reciprocal too, and two such multiplies in a row fold into one by the
product of the constants (see ``_reciprocal``).

Experts are the paper's GROUPBY groups: ``expert_load`` ([E], per layer)
feeds the expert-load monitor fleet, 2 words per (layer, expert).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .embedding import normal
from .mlp import _act, mlp, mlp_init


def moe_init(gen, cfg, dtype=torch.float32, device=None):
    """The JAX package's tree (router, w_in, w_gate, w_out, and shared
    when ``moe_shared_experts``) with its shapes and scales; the values
    come from ``gen``."""
    d, e, ff = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"router": normal(gen, (d, e), s_in, dtype, device),
         "w_in": normal(gen, (e, d, ff), s_in, dtype, device),
         "w_gate": normal(gen, (e, d, ff), s_in, dtype, device),
         "w_out": normal(gen, (e, ff, d), s_out, dtype, device)}
    if cfg.moe_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.moe_shared_experts,
                               cfg.gated_mlp, dtype, device)
    return p


def _reciprocal(n: int) -> float:
    """1/n rounded to float32: ``jnp.mean`` multiplies a sum by it, and
    XLA turns a division by the constant n inside ``jit`` (the JAX
    package's model always runs there) into the same multiply. It is not
    the IEEE quotient wherever 1/n is inexact (n = 3, 6, 96, ...), so the
    port multiplies too, on every device: a float32 multiply by a Python
    number is exact on the CPU and the card alike, where ``x / n`` is a
    quotient on the CPU and a reciprocal multiply on the card."""
    return float(np.float32(1.0) / np.float32(n))


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, equal values in ascending index order (a stable sort; the
    order ``torch.topk`` gives equal values is not specified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x, top_w, top_e, e: int, cap: int, dt):
    """Every sequence's scatter into its [E, cap+1, D] capacity buffer.

    x [B, S, D]; top_w/top_e [B, S, K]. Returns (buf [B, E, cap+1, D],
    sorted_e, slot, order, w_sorted, dropped), each [B, S*K] in the
    order of the stable sort by expert (``order``: the assignments'
    flat indices s*K + k, so token ``order // K``)."""
    b, s, k = top_e.shape
    dev = x.device
    flat_e = top_e.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous())
    pos_in_seg = torch.arange(s * k, device=dev) \
        - torch.gather(seg_starts, 1, sorted_e)
    dropped = pos_in_seg >= cap
    slot = torch.where(dropped, cap, pos_in_seg)            # overflow slot
    tok_of = order // k
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, cap + 1, x.shape[-1]), dtype=dt, device=dev)
    # Every dropped assignment writes slot ``cap``: duplicate writes whose
    # winner is unspecified (in JAX too), and nothing reads that slot.
    buf = buf.index_put((rows, sorted_e, slot), x[rows, tok_of].to(dt))
    w_sorted = torch.gather(top_w.reshape(b, s * k), 1, order).to(dt) \
        .masked_fill(dropped, 0.0)
    return buf, sorted_e, slot, order, w_sorted, dropped


def _combine(out_buf, sorted_e, slot, order, w_sorted, s: int, k: int):
    """Gather each assignment's expert output back and weight-combine.

    The JAX package scatter-adds the S*K contributions into token order
    (``.at[tok_of].add``), which on the card would be an unordered atomic
    add. The port puts each contribution back at its assignment's place
    (``order`` is a permutation: no duplicate writes) and sums a token's
    K contributions over the K axis, top-1 first: the same terms, summed
    in a fixed order that may differ from the JAX package's by rounding
    (exactly equal at K = 2, where the order cannot matter)."""
    b = out_buf.shape[0]
    rows = torch.arange(b, device=out_buf.device)[:, None]
    contrib = out_buf[rows, sorted_e, slot] * w_sorted[..., None]
    by_assignment = torch.zeros_like(contrib).index_put(
        (rows.expand_as(order), order), contrib)
    return by_assignment.reshape(b, s, k, -1).sum(2)


def moe_block(params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (out [B, S, D], aux {aux_loss, expert_load [E],
    router_logit_max, drop_fraction})."""
    b, s, _ = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    dt = x.dtype

    logits = torch.einsum("bsd,de->bse", x.float(),
                          params["router"].float())        # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)                          # [B, S, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style), over the whole batch
    me = probs.sum((0, 1)) * _reciprocal(b * s)             # [E]
    counts = F.one_hot(top_e, e).sum((0, 1, 2)).float()    # exact
    ce = counts * _reciprocal(b * s)
    aux_loss = e * torch.sum(me * ce) * cfg.router_aux_coef

    cap = int(cfg.capacity_factor * s * k / e) + 1          # per sequence

    buf, sorted_e, slot, order, w_sorted, dropped = _dispatch(
        x, top_w, top_e, e, cap, dt)
    # The JAX package constrains buf's sharding here (experts over the
    # 'model' axis): a placement across a mesh, no meaning on one device.
    h = buf[:, :, :cap]                                     # [B, E, C, D]
    up = torch.einsum("becd,edf->becf", h, params["w_in"].to(dt))
    gate = torch.einsum("becd,edf->becf", h, params["w_gate"].to(dt))
    act = _act(cfg.act, gate) * up
    out_buf = torch.einsum("becf,efd->becd", act, params["w_out"].to(dt))
    out_buf = F.pad(out_buf, (0, 0, 0, 1))                  # garbage slot

    out = _combine(out_buf, sorted_e, slot, order, w_sorted, s, k)
    if cfg.moe_shared_experts:
        out = out + mlp(params["shared"], x, cfg.act, cfg.gated_mlp)

    aux = {"aux_loss": aux_loss,
           # [E] fraction: jit folds (sum * 1/(B*S)) * 1/k into one
           # multiply by the float32 product of the two reciprocals
           "expert_load": counts * float(np.float32(_reciprocal(b * s))
                                         * np.float32(_reciprocal(k))),
           "router_logit_max": logits.amax(-1).sum() * _reciprocal(b * s),
           "drop_fraction": dropped.float().sum() * _reciprocal(b * s * k)}
    return out, aux
