"""One model configuration dataclass for the ten assigned architectures.

A field-for-field copy of the JAX package's ``models/config.py``
(``ModelConfig``, ``q_dim``, ``kv_dim``, ``n_params``,
``n_active_params``): each ``repro_torch/configs/<arch>.py`` instantiates
it with the exact published numbers, and ``roofline.analysis`` prices it
(``model_flops``, ``analytic_hbm_bytes``). The layer fields describe the
JAX package's model zoo, which the port does not have yet; their meaning
is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192

    # norms / activations
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"              # silu | gelu | relu2
    gated_mlp: bool = True         # GLU-style two-matrix up-proj
    post_norms: bool = False       # gemma2: extra norm after attn/mlp
    gemma_norm: bool = False       # RMSNorm scale = (1 + w)

    # positions
    pos_type: str = "rope"         # rope | mrope | learned | sinusoidal | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()

    # attention extras
    window_pattern: Tuple[int, ...] = ()   # e.g. (4096, 0): local/global alt; 0=global
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_scale: Optional[float] = None     # override 1/sqrt(head_dim)

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_d_ff: int = 0
    moe_shared_experts: int = 0
    moe_first_dense: int = 0       # leading dense layers (deepseek: 1)
    first_dense_d_ff: int = 0      # d_ff of those leading dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4

    # hybrid stacking: repeating unit, e.g. ("attn", "mamba", ..., "mamba")
    layer_pattern: Tuple[str, ...] = ()
    shared_attention: bool = False  # zamba2: one attention block reused

    # RWKV6
    rwkv_head_size: int = 64

    # encoder-decoder (whisper)
    is_encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0
    enc_seq_len: int = 1500        # whisper: 30 s of audio at 50 fps

    # modality frontend stub: '' | 'audio' | 'vision'
    frontend_stub: str = ""

    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma2: multiply embeddings by sqrt(d)
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    remat: bool = True             # activation checkpointing per block
    # Dry-run fidelity: XLA cost_analysis counts while-loop bodies ONCE, so
    # the launcher unrolls the layer scan when lowering for roofline numbers.
    unroll_layers: bool = False
    # chunked-attention block sizes (probes set attn_chunk=seq for trip=1)
    attn_chunk: int = 1024
    decode_chunk: int = 2048

    # ---- §Perf hillclimb variants (default-off; see EXPERIMENTS.md §Perf)
    # H1: factorized-decay RWKV6 time-mix (subchunk-exact 3-factor form —
    #     kills the [c, c, n] decay materialization)
    rwkv_factorized: bool = False
    rwkv_subchunk: int = 16
    # H3: blocked local attention (window-sized q blocks attend only their
    #     own + previous kv block — S·2w instead of S² for local layers)
    local_block_attn: bool = False
    # H2: sharded-vocab-safe cross-entropy (one-hot einsum instead of
    #     take_along_axis gather on the vocab-sharded logits)
    onehot_xent: bool = False
    # H2b: sequence parallelism — residual stream sharded over 'model'
    #      between blocks (AG before attn/mlp, RS after: halves activation
    #      collective bytes vs 2x all-reduce)
    seq_sharded_residual: bool = False
    # H3b: local-attention decode reads only the last `window` cache slots
    local_decode_slice: bool = False
    logical_batch_axes: Tuple[str, ...] = ("pod", "data")

    # --------------------------------------------------------------- derived
    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and not self.layer_pattern

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6·N·D. MoE counts ALL expert params; n_active_params()
        counts routed-active only."""
        return _count_params(self, active_only=False)

    def n_active_params(self) -> int:
        return _count_params(self, active_only=True)


def _attn_params(c: ModelConfig) -> int:
    if c.use_mla:
        q = c.d_model * c.num_heads * (c.qk_nope_dim + c.qk_rope_dim)
        dkv = c.d_model * (c.kv_lora_rank + c.qk_rope_dim)
        uk = c.kv_lora_rank * c.num_heads * c.qk_nope_dim
        uv = c.kv_lora_rank * c.num_heads * c.v_head_dim
        o = c.num_heads * c.v_head_dim * c.d_model
        return q + dkv + uk + uv + o
    q = c.d_model * c.num_heads * c.head_dim
    kv = 2 * c.d_model * c.num_kv_heads * c.head_dim
    o = c.num_heads * c.head_dim * c.d_model
    return q + kv + o


def _mlp_params(c: ModelConfig, d_ff: int) -> int:
    mats = 3 if c.gated_mlp else 2
    return mats * c.d_model * d_ff


def _mamba_params(c: ModelConfig) -> int:
    d_in = c.ssm_expand * c.d_model
    nheads = d_in // c.ssm_headdim
    in_proj = c.d_model * (2 * d_in + 2 * c.ssm_state + nheads)
    out_proj = d_in * c.d_model
    conv = c.conv_kernel * (d_in + 2 * c.ssm_state)
    return in_proj + out_proj + conv + 2 * nheads


def _rwkv_params(c: ModelConfig) -> int:
    d = c.d_model
    tm = 4 * d * d + d * c.d_ff // 2  # r,k,v,g,o + w lora (approx)
    cm = 2 * d * c.d_ff
    return tm + cm


def _count_params(c: ModelConfig, active_only: bool) -> int:
    emb = c.vocab_size * c.d_model * (1 if c.tie_embeddings else 2)
    total = emb
    if c.is_encdec:
        per = _attn_params(c) + _mlp_params(c, c.d_ff)
        cross = _attn_params(c)
        total += c.enc_layers * per + c.dec_layers * (per + cross)
        return total
    if c.family == "ssm":
        total += c.num_layers * _rwkv_params(c)
        return total
    if c.family == "hybrid":
        pattern = c.layer_pattern or ("mamba",)
        n_units = c.num_layers // len(pattern)
        mamba_per_unit = sum(1 for k in pattern if k == "mamba")
        attn_per_unit = sum(1 for k in pattern if k == "attn")
        total += c.num_layers // len(pattern) * mamba_per_unit * _mamba_params(c)
        attn_blk = _attn_params(c) + _mlp_params(c, c.d_ff)
        if c.shared_attention:
            total += attn_blk  # ONE shared block
        else:
            total += n_units * attn_per_unit * attn_blk
        return total
    # dense / moe / vlm decoder stack
    n_moe = 0
    if c.moe_experts:
        n_moe = c.num_layers - c.moe_first_dense
        dense_ff = c.first_dense_d_ff or c.d_ff
        total += c.moe_first_dense * (_attn_params(c) + _mlp_params(c, dense_ff))
        e_params = _mlp_params(c, c.moe_d_ff)
        routed = c.moe_topk if active_only else c.moe_experts
        total += n_moe * (_attn_params(c)
                          + routed * e_params
                          + c.moe_shared_experts * e_params
                          + c.d_model * c.moe_experts)
    else:
        total += c.num_layers * (_attn_params(c) + _mlp_params(c, c.d_ff))
    return total
