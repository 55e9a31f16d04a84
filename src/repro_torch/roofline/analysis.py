"""Roofline terms and the per-platform hardware registry (a copy of the
JAX package's ``roofline/analysis.py``).

Every prediction names the HwSpec it was computed against; the spec is
DETECTED from the local device (``detect_hw``: the port's
``configs.platform.detect_device_kind``, on the card
``torch.cuda.get_device_name``), and an unrecognized device maps to the
explicit ``unknown`` entry — whose numbers are all zero and which every
predictor REFUSES (RooflineUnknownHardware) rather than pricing a device
it does not know.

The registry's figures are published part numbers (data sheets), not
measurements; the ``cpu`` entry is nominal.

Roofline terms (seconds per step, per chip):
  compute    = device_FLOPs / peak_flops
  memory     = device_HBM_bytes / hbm_bw
  collective = device_wire_bytes / (ici_bw_per_link × links)

`links`: links usable concurrently per chip for the dominant collective.
``model_flops`` and ``analytic_hbm_bytes`` price a ``models.config``
ModelConfig (6·N·D and a per-device HBM traffic model).

The program kernel's model on the card (bytes, shared memory, issue
slots) lives in roofline/kernel_model.py; the block autotuner in
roofline/autotune.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


class RooflineUnknownHardware(ValueError):
    """Raised when a prediction is requested against the ``unknown``
    HwSpec — the registry refuses to guess bandwidth numbers."""


@dataclasses.dataclass(frozen=True)
class HwSpec:
    """One platform's roofline constants.

    peak_flops / hbm_bw are the headline chip numbers; vmem_bytes bounds
    what the autotuner may keep resident per core (VMEM on TPU, L2+shared
    budget on GPU, last-level cache slice on CPU); cores is the number of
    parallel grid executors (TensorCores / SMs / host threads) the G-block
    grid should at least fill; grid_step_s and dma_issue_s are per-step /
    per-transfer fixed overheads the block model charges, so the tuner
    trades tile count against residency instead of always maxing tiles.
    """

    name: str                 # registry key, e.g. "tpu-v5e"
    platform: str             # "tpu" | "gpu" | "cpu" | "unknown"
    peak_flops: float         # FLOP/s (bf16 on TPU, dense fp16/bf16 on GPU)
    hbm_bw: float             # bytes/s main-memory bandwidth
    vmem_bytes: float         # fast-memory residency budget per core
    cores: int                # parallel grid executors to fill
    ici_bw_per_link: float = 0.0
    ici_links: int = 0
    dcn_bw: float = 0.0
    grid_step_s: float = 1e-6     # fixed cost per grid step dispatched
    dma_issue_s: float = 2e-6     # fixed cost per DMA/tile transfer issued
    nominal: bool = False         # True when hbm_bw is a class estimate,
                                  # not a measured part number (cpu entry)

    @property
    def known(self) -> bool:
        return self.platform != "unknown"

    def require_known(self) -> "HwSpec":
        if not self.known:
            raise RooflineUnknownHardware(
                "roofline: local device did not match any registered "
                "HwSpec — refusing to predict against unknown hardware. "
                f"Registered platforms: {', '.join(sorted(HW_REGISTRY))}. "
                "Add an entry to repro_torch.roofline.analysis.HW_REGISTRY "
                "(or pass hw= explicitly) to price this device.")
        return self


# Published part numbers (peak dense bf16/fp16 FLOP/s, HBM/DRAM bandwidth).
# vmem: TPU VMEM per core; GPU L2+smem budget per SM kept conservative; CPU
# an L2-slice figure. The cpu entry is NOMINAL (class-typical DDR5 dual
# channel) — good enough to contextualize interpret-mode rows, flagged so
# gates never anchor on it.
HW_REGISTRY: Dict[str, HwSpec] = {
    "tpu-v4": HwSpec("tpu-v4", "tpu", peak_flops=275e12, hbm_bw=1228e9,
                     vmem_bytes=128 * 2**20, cores=2,
                     ici_bw_per_link=50e9, ici_links=6, dcn_bw=25e9),
    "tpu-v5e": HwSpec("tpu-v5e", "tpu", peak_flops=197e12, hbm_bw=819e9,
                      vmem_bytes=128 * 2**20, cores=1,
                      ici_bw_per_link=50e9, ici_links=4, dcn_bw=25e9),
    "tpu-v5p": HwSpec("tpu-v5p", "tpu", peak_flops=459e12, hbm_bw=2765e9,
                      vmem_bytes=128 * 2**20, cores=2,
                      ici_bw_per_link=100e9, ici_links=6, dcn_bw=25e9),
    "tpu-v6e": HwSpec("tpu-v6e", "tpu", peak_flops=918e12, hbm_bw=1640e9,
                      vmem_bytes=128 * 2**20, cores=1,
                      ici_bw_per_link=100e9, ici_links=4, dcn_bw=25e9),
    "gpu-a100": HwSpec("gpu-a100", "gpu", peak_flops=312e12, hbm_bw=2039e9,
                       vmem_bytes=40 * 2**20, cores=108,
                       ici_bw_per_link=600e9, ici_links=1,
                       grid_step_s=3e-6, dma_issue_s=1e-6),
    "gpu-h100": HwSpec("gpu-h100", "gpu", peak_flops=989e12, hbm_bw=3350e9,
                       vmem_bytes=50 * 2**20, cores=132,
                       ici_bw_per_link=900e9, ici_links=1,
                       grid_step_s=3e-6, dma_issue_s=1e-6),
    "cpu": HwSpec("cpu", "cpu", peak_flops=1e12, hbm_bw=40e9,
                  vmem_bytes=1 * 2**20, cores=8, nominal=True),
    "unknown": HwSpec("unknown", "unknown", peak_flops=0.0, hbm_bw=0.0,
                      vmem_bytes=0.0, cores=0),
}

# device kind substring -> registry key, checked in order (first match
# wins). Kinds read e.g. "TPU v5 lite", "TPU v4", "NVIDIA A100-SXM4-80GB",
# "NVIDIA H100 80GB HBM3" (torch.cuda.get_device_name), "cpu".
_KIND_PATTERNS = (
    ("tpu v5 lite", "tpu-v5e"),
    ("tpu v5e", "tpu-v5e"),
    ("tpu v5p", "tpu-v5p"),
    ("tpu v5", "tpu-v5p"),
    ("tpu v4", "tpu-v4"),
    ("tpu v6 lite", "tpu-v6e"),
    ("tpu v6e", "tpu-v6e"),
    ("a100", "gpu-a100"),
    ("h100", "gpu-h100"),
    ("cpu", "cpu"),
)


def hw_for(name: str) -> HwSpec:
    """Registry lookup by key; unknown keys are a hard error (the sentinel
    entry is reachable as hw_for('unknown'), which every predictor then
    refuses)."""
    if name not in HW_REGISTRY:
        raise KeyError(f"no HwSpec registered under {name!r}; registered: "
                       f"{', '.join(sorted(HW_REGISTRY))}")
    return HW_REGISTRY[name]


def match_device_kind(kind: str) -> HwSpec:
    """Map a device kind string onto the registry; no match ->
    the explicit ``unknown`` entry (predictors refuse it)."""
    low = kind.lower()
    for pat, key in _KIND_PATTERNS:
        if pat in low:
            return HW_REGISTRY[key]
    return HW_REGISTRY["unknown"]


def detect_hw(device=None) -> HwSpec:
    """The local device's HwSpec — the registry seam every prediction,
    autotune key, and bench meta stamp reads."""
    from repro_torch.configs.platform import detect_device_kind

    return match_device_kind(detect_device_kind(device))


def roofline_terms(
    device_flops: float,
    device_bytes: float,
    device_collective_bytes: float,
    *,
    hw: HwSpec,
    model_flops_global: Optional[float] = None,
    n_chips: int = 1,
    links: Optional[int] = None,
) -> Dict[str, float]:
    """Three-term roofline against an EXPLICIT HwSpec (detect_hw() or a
    registry entry — there is no implicit default hardware anymore)."""
    hw.require_known()
    if links is None:
        links = max(hw.ici_links, 1)
    compute_s = device_flops / hw.peak_flops
    memory_s = device_bytes / hw.hbm_bw
    coll_s = (device_collective_bytes / (hw.ici_bw_per_link * links)
              if device_collective_bytes else 0.0)
    terms = {
        "hw": hw.name,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bound": max(
            ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
            key=lambda kv: kv[1])[0],
        "step_lower_bound_s": max(compute_s, memory_s, coll_s),
    }
    if model_flops_global:
        hlo_global = device_flops * n_chips
        terms["model_flops_global"] = model_flops_global
        terms["useful_compute_ratio"] = (
            model_flops_global / hlo_global if hlo_global else 0.0)
        # MFU-at-roofline: useful FLOPs / (chips × peak × step time lower bound)
        denom = n_chips * hw.peak_flops * terms["step_lower_bound_s"]
        terms["roofline_mfu"] = model_flops_global / denom if denom else 0.0
    return terms


def model_flops(cfg, tokens_per_step: int, kind: str = "train") -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); forward-only kinds use 2·N·D."""
    n = cfg.n_active_params() if cfg.moe_experts else cfg.n_params()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens_per_step


def analytic_hbm_bytes(cfg, kind: str, batch: int, seq: int,
                       dp: int, model: int) -> float:
    """Per-device HBM traffic model (bytes/step) — the roofline memory term.

    XLA:CPU `bytes accessed` counts every post-fusion dataflow edge, including
    flash-attention score tiles that live in VMEM on TPU, so it wildly
    overstates HBM traffic (kept as a diagnostic). This model counts what a
    well-blocked TPU program actually moves per device:

      weights   gathered shard P/model × 4B × (fwd [+ bwd]) under FSDP
      optimizer local shard P/(model·dp) × 4B × 7 (grad, m r/w, v r/w, p r/w)
      acts      tokens_dev × per-layer activation columns × 2B ×
                (1 fwd | 3 fwd+recompute+bwd with remat)
      logits    tokens_dev × V/model × 4B × (1 | 3)
      caches    full KV/latent/state read per decode step
      quadratic intra-chunk tensors that exceed VMEM (rwkv [c,c,n] decay,
                mamba/rwkv chunk matrices) — counted because they spill.
    """
    p_total = float(cfg.n_params())
    tokens_global = batch * (1 if kind == "decode" else seq)
    tokens_dev = tokens_global / dp
    b_dev = max(batch / dp, 1.0)

    # ---- per-layer activation columns (model-sharded dims divided by model)
    d = cfg.d_model
    if cfg.use_mla:
        attn_cols = (cfg.q_dim + cfg.kv_lora_rank + cfg.qk_rope_dim
                     + cfg.num_heads * cfg.v_head_dim) / model
    else:
        attn_cols = (2 * cfg.q_dim + 2 * cfg.kv_dim) / model
    if cfg.moe_experts:
        ff = cfg.moe_d_ff * (cfg.moe_topk + cfg.moe_shared_experts) * cfg.capacity_factor
    else:
        ff = cfg.d_ff
    mlp_cols = (2 + (1 if cfg.gated_mlp else 0)) * ff / model
    resid_cols = 6 * d        # residuals, norms, embed in/out
    n_layers = (cfg.enc_layers + cfg.dec_layers) if cfg.is_encdec else cfg.num_layers
    cols = attn_cols + mlp_cols + resid_cols

    # family-specific quadratic intra-chunk tensors (spill past VMEM)
    quad = 0.0
    if cfg.family == "ssm":       # rwkv decay [c, c, n] per chunk per head
        nh = d // cfg.rwkv_head_size
        if getattr(cfg, "rwkv_factorized", False):
            # H1: [P,u,u,n] exact-diag + [P,P,u,n] bridges per chunk
            per_tok = (cfg.rwkv_subchunk
                       + cfg.ssm_chunk // cfg.rwkv_subchunk) * cfg.rwkv_head_size
        else:
            per_tok = cfg.ssm_chunk * cfg.rwkv_head_size
        quad = tokens_dev * per_tok * nh * 4.0
    if cfg.family == "hybrid":    # mamba2 chunk matrices [c, c] per head
        nh = cfg.ssm_expand * d // cfg.ssm_headdim
        quad = tokens_dev * cfg.ssm_chunk * nh * 4.0

    passes = 3.0 if kind == "train" else 1.0
    act = tokens_dev * cols * 2.0 * passes * n_layers + quad * passes

    w = p_total / model * 4.0 * (2.0 if kind == "train" else 1.0)
    opt = p_total / (model * dp) * 4.0 * 7.0 if kind == "train" else 0.0
    logit_rows = tokens_dev if kind == "train" else b_dev
    logits = logit_rows * cfg.vocab_size / model * 4.0 * passes

    cache = 0.0
    if kind == "decode":
        if cfg.is_encdec:
            per_tok = 2 * cfg.kv_dim * 2.0
            cache = cfg.dec_layers * seq * batch * per_tok / (dp * 1.0)
        elif cfg.use_mla:
            per_tok = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0
            cache = cfg.num_layers * seq * batch * per_tok / dp
        elif cfg.family == "ssm":
            nh = d // cfg.rwkv_head_size
            cache = cfg.num_layers * batch * nh * cfg.rwkv_head_size ** 2 * 4.0
        elif cfg.family == "hybrid":
            unit = len(cfg.layer_pattern)
            n_attn = cfg.num_layers // unit
            n_mamba = cfg.num_layers - n_attn
            kv_shard = model if cfg.num_kv_heads % model == 0 else 1
            cache = n_attn * seq * batch * 2 * cfg.kv_dim * 2.0 / (dp * kv_shard)
            d_in = cfg.ssm_expand * d
            cache += n_mamba * batch * (d_in // cfg.ssm_headdim) \
                * cfg.ssm_headdim * cfg.ssm_state * 4.0 / dp
        else:
            kv_shard = model if cfg.num_kv_heads % model == 0 else 1
            cache = cfg.num_layers * seq * batch * 2 * cfg.kv_dim * 2.0 \
                / (dp * kv_shard)
    if kind == "prefill":
        # flash attention: K/V read once per q block (~2x) already in cols;
        # whisper encoder runs at enc frames = seq
        pass
    return act + w + opt + logits + cache
