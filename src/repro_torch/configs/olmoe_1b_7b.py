"""OLMoE-1B-7B [arXiv:2409.02060; hf].

16L, d_model 2048, 16 heads (kv=16), vocab 50304. MoE: 64 experts top-8,
expert d_ff 1024, no shared experts, every layer MoE.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50_304,
        max_seq_len=32_768,
        pos_type="rope",
        act="silu",
        gated_mlp=True,
        moe_experts=64,
        moe_topk=8,
        moe_d_ff=1024,
        capacity_factor=1.25,
    )
