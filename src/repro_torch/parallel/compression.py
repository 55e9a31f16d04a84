"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (port of the JAX package's
``parallel/compression.py``).

Across pods the gradient all-reduce dominates; int8 + error feedback cuts
wire bytes 4x against float32 (2x against bf16), and the quantization
residual is re-injected the next step, so compression errors telescope
instead of accumulating:

    q, scale = quantize_int8(g + ef)
    g_avg    = all-reduce(dequantize_int8(q, scale)) / n
    ef       = (g + ef) - dequantize_int8(q, scale)

Gradients are dicts keyed by parameter name (``named_parameters()``).
The functions give the bits of the JAX package's eager functions: the
scale is the IEEE quotient ``amax / 127`` (a float32 tensor on the
operand's device divides: on CUDA a division by a Python number is a
multiplication by its reciprocal, which differs for about one value in
twenty), and ``torch.round`` rounds half to even as ``jnp.round`` does.

``compressed_psum`` is the all-reduce placed from one controller process:
it takes the data replicas' gradients and error feedback as sequences in
replica order, each replica's tensors on its own device, and needs no
process group. Its bits are the JAX function's under ``shard_map``: each
replica compresses on its own device; the int8 payloads and scales (the
wire) move to replica 0's device, are dequantized there and summed in a
left fold in replica order; the sum is divided by R as a float32 tensor
on the operands' device (the IEEE quotient, not a reciprocal multiply)
and copied back to every replica's device.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

Grads = Mapping[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q [same shape, int8], 0-d
    float32 scale)."""
    amax = torch.amax(torch.abs(x)).to(torch.float32)
    div = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(amax / div, min=1e-12)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(grads: Grads) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(g, dtype=torch.float32)
            for k, g in grads.items()}


def compress_grads(grads: Grads, ef: Grads):
    """Returns (int8 payloads, scales, new error feedback), each a dict
    keyed as ``grads``."""
    q, s, new_ef = {}, {}, {}
    for k, g in grads.items():
        corrected = g.to(torch.float32) + ef[k]
        q[k], s[k] = quantize_int8(corrected)
        new_ef[k] = corrected - dequantize_int8(q[k], s[k])
    return q, s, new_ef


def decompress_grads(q: Grads, s: Grads) -> Dict[str, torch.Tensor]:
    return {k: dequantize_int8(q[k], s[k]) for k in q}


def compressed_psum(grads: Sequence[Grads], ef: Sequence[Grads]
                    ) -> Tuple[List[Dict[str, torch.Tensor]],
                               List[Dict[str, torch.Tensor]]]:
    """Error-feedback int8 all-reduce over R data replicas: ``grads[r]``
    and ``ef[r]`` are replica r's dicts. Returns (averages, new efs), one
    dict per replica on that replica's devices."""
    if len(grads) != len(ef) or not grads:
        raise ValueError(f"compressed_psum needs one ef per replica and at "
                         f"least one replica, got {len(grads)} gradients "
                         f"and {len(ef)} efs")
    packed = [compress_grads(g, e) for g, e in zip(grads, ef)]
    avg0 = {}
    for k, g0 in grads[0].items():
        dev = g0.device
        acc = None
        for q, s, _ in packed:
            deq = dequantize_int8(q[k].to(dev), s[k].to(dev))
            acc = deq if acc is None else acc + deq
        n = torch.full((), len(grads), dtype=torch.float32, device=dev)
        avg0[k] = acc / n
    avgs = [avg0] + [{k: v.to(g[k].device, copy=True)
                      for k, v in avg0.items()} for g in grads[1:]]
    return avgs, [new_ef for _, _, new_ef in packed]


def wire_bytes(grads: Grads, compressed: bool) -> int:
    """Bytes one all-reduce sends: 1 a value and a float32 scale a
    tensor compressed, 4 a value uncompressed."""
    n = sum(int(g.numel()) for g in grads.values())
    return n * (1 if compressed else 4) + (4 * len(grads) if compressed
                                           else 0)


__all__ = ["quantize_int8", "dequantize_int8", "ef_init", "compress_grads",
           "decompress_grads", "compressed_psum", "wire_bytes"]
