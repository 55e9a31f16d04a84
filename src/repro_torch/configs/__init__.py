"""Assigned-architecture configs (exact published numbers), their smoke
reduction, and the device seam.

`get_config(arch_id)` returns the full ModelConfig; `reduce_for_smoke(cfg)`
shrinks it to a same-family toy (few layers, narrow, tiny vocab). Both are
copies of the JAX package's, which the roofline layer prices.

`platform.py` (re-exported here) resolves the device of every entry point
(`resolve_device`: the card unless the caller names another) and detects
the local device for the roofline registry (`detect_platform`,
`detect_device_kind`).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.configs.platform import (
    compiled_kernel_platforms,
    detect_device_kind,
    detect_platform,
    resolve_device,
    supports_compiled_kernels,
)

ARCH_IDS = [
    "qwen2_vl_2b",
    "zamba2_2p7b",
    "yi_6b",
    "minitron_4b",
    "gemma2_9b",
    "granite_20b",
    "deepseek_v2_lite",
    "olmoe_1b_7b",
    "whisper_large_v3",
    "rwkv6_1p6b",
]

# canonical external ids (as listed in the assignment) -> module names
ALIASES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "zamba2-2.7b": "zamba2_2p7b",
    "yi-6b": "yi_6b",
    "minitron-4b": "minitron_4b",
    "gemma2-9b": "gemma2_9b",
    "granite-20b": "granite_20b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-1.6b": "rwkv6_1p6b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same-family miniature for CPU smoke tests."""
    r = dict(
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=256,
        dtype="float32",
        remat=False,
    )
    if cfg.num_kv_heads == 1:
        r["num_kv_heads"] = 1
    if cfg.layer_pattern:
        r["num_layers"] = 2 * len(cfg.layer_pattern)
    elif cfg.window_pattern:
        r["num_layers"] = 2 * len(cfg.window_pattern)
    else:
        r["num_layers"] = 2 + cfg.moe_first_dense
    if cfg.use_mla:
        r.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16,
                 first_dense_d_ff=256 if cfg.first_dense_d_ff else 0)
    if cfg.moe_experts:
        r.update(moe_experts=8, moe_topk=2, moe_d_ff=64)
    if cfg.ssm_state:
        r.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.family == "ssm":
        r.update(d_ff=224, rwkv_head_size=32)  # d_ff multiple of d? any; head 128/32=4
    if cfg.is_encdec:
        r.update(enc_layers=2, dec_layers=2, enc_seq_len=64)
    if cfg.mrope_sections:
        r["mrope_sections"] = (4, 6, 6)  # sums to head_dim//2 = 16
    return dataclasses.replace(cfg, **r)


__all__ = [
    "ARCH_IDS",
    "ALIASES",
    "ModelConfig",
    "get_config",
    "reduce_for_smoke",
    "compiled_kernel_platforms",
    "detect_device_kind",
    "detect_platform",
    "resolve_device",
    "supports_compiled_kernels",
]
