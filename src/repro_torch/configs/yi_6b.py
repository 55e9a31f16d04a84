"""Yi-6B [arXiv:2403.04652; hf]: llama-arch GQA.

32L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11_008,
        vocab_size=64_000,
        max_seq_len=32_768,
        pos_type="rope",
        rope_theta=5_000_000.0,
        act="silu",
        gated_mlp=True,
    )
