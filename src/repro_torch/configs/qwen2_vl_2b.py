"""Qwen2-VL-2B backbone [arXiv:2409.12191; hf].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936, M-RoPE with
(16, 24, 24) sections over head_dim 128. Vision frontend (ViT + dynamic
resolution) is a STUB: input_specs() supplies precomputed patch embeddings
and 3-D (t, h, w) position ids; the backbone compute is exact.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        max_seq_len=32_768,
        pos_type="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        act="silu",
        gated_mlp=True,
        tie_embeddings=True,
        frontend_stub="vision",
    )
