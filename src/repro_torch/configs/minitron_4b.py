"""Minitron-4B [arXiv:2407.14679; hf]: pruned Nemotron.

32L, d_model 3072, 24 heads (GQA kv=8), d_ff 9216 (ungated squared-ReLU MLP,
nemotron-style), vocab 256000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256_000,
        max_seq_len=32_768,
        pos_type="rope",
        act="relu2",
        gated_mlp=False,
    )
