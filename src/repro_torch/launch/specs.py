"""Abstract inputs and step functions for every (arch × shape) dry-run
cell (port of the JAX package's ``launch/specs.py``).

Everything here lives on ``torch.device("meta")``: shapes and dtypes, no
storage, on no device. Shapes:

  train_4k     seq 4,096   global_batch 256   (train_step)
  prefill_32k  seq 32,768  global_batch 32    (prefill, last-token logits)
  decode_32k   seq 32,768  global_batch 128   (serve_step, KV cache of 32k)
  long_500k    seq 524,288 global_batch 1     (serve_step; SSM/hybrid only)

Modality stubs: whisper gets precomputed frame embeddings [B, S_enc, D];
qwen2-vl's text path carries 3-D M-RoPE position ids.

Skip table (as the JAX package's):
  long_500k  -> pure full-attention archs skipped (quadratic); runs for
                zamba2-2.7b, rwkv6-1.6b.
  whisper    -> prefill_32k = 32k-frame encoder pass + 448-token decoder;
                decode_32k  = decoder step with a 32k self-attn cache.

The port runs every layer and attention chunk of the step it traces
(``roofline/trace_cost.py``), so the JAX package's shallow unrolled
probes (``probe_overrides``) have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}

LONG_CAPABLE = {"zamba2-2.7b", "rwkv6-1.6b"}

DEC_TOKENS = 448       # whisper's decoder length in train / prefill cells

# The JAX package's perf variants that change what the port traces or
# prices: name -> config overrides ("exclude_vocab_fsdp" is a sharding
# option, not a config field). Its ``seq_residual``, ``h1_combo``,
# ``h2_combo`` and ``h3_combo`` set ``seq_sharded_residual``, an
# activation sharding the port does not model (ROADMAP A, "Left out").
VARIANTS = {
    "baseline": {},
    # H1: rwkv6 memory
    "rwkv_factorized": {"rwkv_factorized": True},
    "rwkv_factorized_u8": {"rwkv_factorized": True, "rwkv_subchunk": 8},
    "rwkv_factorized_u32": {"rwkv_factorized": True, "rwkv_subchunk": 32},
    # H2: yi-6b collectives
    "onehot_xent": {"onehot_xent": True},
    "vocab_nofsdp": {"exclude_vocab_fsdp": True},           # sharding-level
    # H3: gemma2 local attention
    "blocked_local": {"local_block_attn": True},
    "local_decode_slice": {"local_decode_slice": True},
}

# The override keys some code of the port reads: the model's rwkv6, loss
# and attention paths, ``analytic_hbm_bytes`` and ``param_shardings``.
VARIANT_KEYS = frozenset({"rwkv_factorized", "rwkv_subchunk", "onehot_xent",
                          "local_block_attn", "local_decode_slice",
                          "exclude_vocab_fsdp"})


def variant_overrides(name: str) -> Tuple[Dict[str, Any], bool]:
    """(config overrides, exclude_vocab_fsdp) of the variant ``name``;
    ValueError for a name VARIANTS lacks or a key no port code reads."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; known: "
                         f"{', '.join(VARIANTS)}")
    ov = dict(VARIANTS[name])
    unread = set(ov) - VARIANT_KEYS
    if unread:
        raise ValueError(f"variant {name!r} sets {sorted(unread)}, which "
                         "no code of the port reads")
    return ov, bool(ov.pop("exclude_vocab_fsdp", False))


Shape = Union[str, Dict[str, Any]]


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.name not in LONG_CAPABLE:
        return False, ("full quadratic attention at 524k decode is infeasible "
                       "by design; sub-quadratic archs only (see DESIGN.md)")
    return True, ""


def _shape(shape: Shape) -> Dict[str, Any]:
    """A SHAPES name, or a dict of the same keys (seq, batch, kind)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, shape: Shape) -> Dict[str, Any]:
    """The abstract batch of a cell: meta tensors of the JAX package's
    shapes and dtypes. A decode cell's ``pos`` is a host int (the port's
    ``decode_step`` takes one; JAX's is a 0-d int32): the cache's last
    slot, ``seq - 1``."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    p = _shape(shape)
    b, s = p["batch"], p["seq"]
    if p["kind"] == "decode":
        return {"tokens": _meta((b, 1)), "pos": s - 1}
    if cfg.is_encdec:
        batch = {"frames": _meta((b, s, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((b, DEC_TOKENS))}
        if p["kind"] == "train":
            batch["targets"] = _meta((b, DEC_TOKENS))
        return batch
    batch = {"tokens": _meta((b, s))}
    if p["kind"] == "train":
        batch["targets"] = _meta((b, s))
    if cfg.pos_type == "mrope":
        batch["positions"] = _meta((b, 3, s))
    return batch


def abstract_params(cfg):
    """The model of ``cfg`` on ``meta``: its parameters are the cell's
    abstract params."""
    return build_model(cfg, device=META)


def abstract_caches(model, batch: int, max_len: int):
    """``init_cache`` of a meta model: bf16 caches (the recurrent states
    float32, as the model makes them) on ``meta``."""
    return model.init_cache(batch, max_len, torch.bfloat16)


def build_cell(arch: str, shape: Shape, overrides: Optional[dict] = None):
    """(fn, abstract args, donate) of a cell; ``fn(*args)`` runs its step
    on the meta tensors.

      train:   fn(state, batch)           (train/steps.py's train_step)
      prefill: fn(model, batch)           -> last-token logits
      decode:  fn(model, tokens, caches, pos[, memory])
    """
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = abstract_params(cfg)
    p = _shape(shape)
    b, s = p["batch"], p["seq"]

    if p["kind"] == "train":
        from repro_torch.core import rng as crng
        from repro_torch.optim import Optimizer, warmup_cosine
        from repro_torch.train.steps import make_train_step
        from repro_torch.train.train_state import abstract_train_state

        opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(3e-4, 100, 10_000))
        batch = input_specs(cfg, p)
        state = abstract_train_state(model, opt, crng.prng_key(0),
                                     example_batch=batch)
        return make_train_step(model, opt), (state, batch), (0,)

    if p["kind"] == "prefill":
        batch = input_specs(cfg, p)

        @torch.no_grad()
        def prefill(model, batch):
            if cfg.is_encdec:
                logits, _ = model(batch["frames"], batch["tokens"])
                return logits[:, -1:]
            logits, _ = model(tokens=batch["tokens"],
                              positions=batch.get("positions"),
                              last_only=True)
            return logits
        return prefill, (model, batch), ()

    # decode: one new token against a cache of length s
    caches = abstract_caches(model, b, s)
    spec = input_specs(cfg, p)
    args = (model, spec["tokens"], caches, spec["pos"])
    if cfg.is_encdec:   # ``encode``'s output: the activation dtype (bf16)
        memory = _meta((b, cfg.enc_seq_len, cfg.d_model),
                       getattr(torch, cfg.dtype))
        args += (memory,)

    def serve_step(model, *rest):
        return model.decode_step(*rest)
    return serve_step, args, (2,)


__all__ = ["SHAPES", "LONG_CAPABLE", "VARIANTS", "VARIANT_KEYS",
           "variant_overrides", "cell_supported",
           "input_specs", "abstract_params", "abstract_caches", "build_cell"]
