"""Zamba2-2.7B [arXiv:2411.15242; hf].

54 layers, d_model 2560: Mamba2 backbone with ONE shared attention block
(32 heads, kv=32, d_ff 10240) applied every 6th layer (the published model
interleaves two shared blocks; we keep one shared block — the memory-saving
trick is identical, noted in DESIGN.md). ssm_state 64, headdim 64, expand 2.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10_240,
        vocab_size=32_000,
        max_seq_len=524_288,
        pos_type="rope",
        act="gelu",
        gated_mlp=True,
        layer_pattern=("attn", "mamba", "mamba", "mamba", "mamba", "mamba"),
        shared_attention=True,
        ssm_state=64,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=128,
        conv_kernel=4,
    )
