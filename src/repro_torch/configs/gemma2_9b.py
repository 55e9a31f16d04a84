"""Gemma2-9B [arXiv:2408.00118; hf].

42L, d_model 3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336 (GeGLU),
vocab 256000. Local(4096)/global alternating attention, attn logit softcap 50,
final logit softcap 30, pre+post RMSNorms, scaled embeddings, tied head.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14_336,
        vocab_size=256_000,
        max_seq_len=32_768,
        pos_type="rope",
        act="gelu",
        gated_mlp=True,
        window_pattern=(4096, 0),   # (local, global) repeating unit
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        gemma_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        attn_scale=256 ** -0.5,     # query_pre_attn_scalar = 256
    )
