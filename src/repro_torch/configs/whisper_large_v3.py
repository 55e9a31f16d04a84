"""Whisper-large-v3 [arXiv:2212.04356].

Enc-dec, 32+32 layers, d_model 1280, 20 heads (kv=20, head_dim 64), d_ff 5120
(ungated GELU), vocab 51866. Conv audio frontend is a STUB: input_specs()
supplies precomputed frame embeddings.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        is_encdec=True,
        num_layers=32,            # per stack
        enc_layers=32,
        dec_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51_866,
        max_seq_len=32_768,       # decoder cache bound for the decode shapes
        enc_seq_len=1500,
        pos_type="learned",       # decoder side; encoder uses sinusoidal
        norm_type="layernorm",
        act="gelu",
        gated_mlp=False,
        tie_embeddings=True,
        frontend_stub="audio",
    )
