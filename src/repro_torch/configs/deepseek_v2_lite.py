"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434; hf].

27L, d_model 2048, 16 heads, MLA (kv_lora 512, qk_nope 128, qk_rope 64,
v_head 128), vocab 102400. MoE: 64 routed experts top-6 + 2 shared,
expert d_ff 1408; layer 0 is dense with d_ff 10944.

Note: the assignment's prose mentions "160 routed" (the V2-full number); the
header line pins 64 experts top-6 (the Lite config) — we implement the header.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,          # nominal (unused by MLA paths)
        d_ff=1408,
        vocab_size=102_400,
        max_seq_len=32_768,
        pos_type="rope",
        act="silu",
        gated_mlp=True,
        use_mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        moe_experts=64,
        moe_topk=6,
        moe_d_ff=1408,
        moe_shared_experts=2,
        moe_first_dense=1,
        first_dense_d_ff=10_944,
        capacity_factor=1.25,
    )
