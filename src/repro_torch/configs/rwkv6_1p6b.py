"""RWKV6-1.6B "Finch" [arXiv:2404.05892].

24L, d_model 2048, attention-free (time-mix with data-dependent decay,
head_size 64), channel-mix d_ff 7168, vocab 65536.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,          # derived: d_model / rwkv_head_size
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65_536,
        max_seq_len=524_288,
        pos_type="none",
        act="relu2",
        gated_mlp=False,
        rwkv_head_size=64,
        ssm_chunk=128,
    )
