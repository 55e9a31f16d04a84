"""Granite-20B-Code [arXiv:2405.04324; hf]: GPT-BigCode arch.

52L, d_model 6144, 48 heads with MQA (kv=1), d_ff 24576 (ungated GELU),
vocab 49152, learned absolute positions, LayerNorm.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24_576,
        vocab_size=49_152,
        max_seq_len=32_768,
        pos_type="learned",
        norm_type="layernorm",
        act="gelu",
        gated_mlp=False,
        tie_embeddings=True,
    )
