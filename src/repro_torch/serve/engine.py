"""Batched serving engine with slot-based batching and frugal per-route
SLO sketches (port of the JAX package's ``serve/engine.py``).

The engine keeps B decode slots. Requests (prompt token lists, tagged with
a ``route``: model, tenant or endpoint) are admitted into free slots,
prefilled, and then every active slot decodes in lockstep, one
``CausalLM.decode_step`` per tick. Finished sequences free their slots.

Per route the engine tracks q99 of the time to first token, q50 of the
per-token decode latency and q50 of the output length: one lane of one
``SLOFleet`` (serve/slo.py) per (route, metric), two words of state each,
updated in one flush per engine step. A deployment with 10^6 routes holds
3 x 2^20 lanes, so every flush takes the fleet's sparse branch: one launch
of the run kernel per step.

The engine does what the reference does, step for step, so that the same
model and prompts give the same tokens and the same SLO state:

- ``_admit`` prefills a slot one prompt token at a time, each a
  whole-batch ``decode_step`` at that slot's position, which writes KV at
  that position in every row, the other active slots' included, and
  advances every row's recurrent state (mamba2's ``ssm`` and ``conv``,
  rwkv6's ``wkv``, ``x_tm`` and ``x_cm``) on the other rows' token 0; a
  newly admitted slot starts from the state its previous request left,
  as nothing resets it;
- ``step`` decodes every active slot at the largest slot position, so a
  slot with a shorter history attends zero-filled (or overwritten) rows;
- a prompt that runs past ``max_len`` writes its KV at the last cache
  row (the decode step clamps the write, as the reference's
  ``dynamic_update_slice`` does); the cache is the model's list of
  per-layer caches, {"k", "v"} for attention, {"ckv", "kr"} (the
  latent and the shared rope key) for MLA, {"ssm", "conv"} for mamba2
  and {"wkv", "x_tm", "x_cm"} for rwkv6, written in place;
- the host clock (``time.time``) is read where the reference reads it.
  ``dt_ms`` covers the dispatch of the decode call: the logits' host copy
  comes after the clock is read, and nothing synchronises the card before
  it;
- sampling runs on the host with numpy, on float32 logits (so ties break
  as numpy's ``argmax`` breaks them).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device

from .slo import SLOFleet


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    route: str = "default"
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    """Serves ``model`` (a ``models.CausalLM``, which holds its
    parameters) from ``batch_slots`` KV-cache slots of ``max_len``
    positions on ``device`` (None: the card; raises where there is none).
    An encoder-decoder is refused, as the JAX package's engine cannot
    serve one (it calls ``decode_step`` without the encoder's memory):
    decode it through ``train.make_serve_step(model, encdec_memory=True)``.
    The model must live on that device; the SLO fleet is made there.
    ``telemetry`` is any object with ``.count(name, n)``: it receives
    ``requests_submitted``, ``requests_completed`` and the SLO fleet's
    flush counts."""

    def __init__(self, model, batch_slots: int = 4, max_len: int = 512,
                 temperature: float = 0.0, seed: int = 0, telemetry=None,
                 device=None):
        if model.cfg.is_encdec:
            raise ValueError(
                f"{model.cfg.name} is an encoder-decoder, which the engine "
                "does not serve (its decode step needs the encoder's "
                "memory): use train.make_serve_step(model, "
                "encdec_memory=True)")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine on {self.device}")
        self.model = model
        self.b = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.caches = model.init_cache(batch_slots, max_len)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, dtype=np.int64)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.telemetry = telemetry
        # Per-(route, metric) Frugal-2U lanes, one fleet; lane uniform
        # streams derive from the counter hash on the absolute lane index.
        self.slo = SLOFleet(seed=seed, telemetry=telemetry,
                            device=self.device)
        self._rng = np.random.default_rng(seed)
        self._decode = model.decode_step

    # ------------------------------------------------------------------ api
    def submit(self, req: Request):
        req.t_submit = time.time()
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.count("requests_submitted")

    # ------------------------------------------------------------ internals
    def _tokens(self) -> torch.Tensor:
        return torch.zeros((self.b, 1), dtype=torch.int32,
                           device=self.device)

    def _admit(self):
        """Fill free slots; prefill is a teacher-forced decode of the
        prompt, one whole-batch decode step per token."""
        for slot in range(self.b):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                for tok in req.prompt:
                    tok_arr = self._tokens()
                    tok_arr[slot, 0] = tok
                    _, self.caches = self._decode(
                        tok_arr, self.caches, int(self.slot_pos[slot]))
                    self.slot_pos[slot] += 1
                req.t_first = time.time()
                self.slo.observe(req.route, "ttft_q99_ms",
                                 (req.t_first - req.t_submit) * 1e3)

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        z = logits_row / self.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    def step(self) -> int:
        """One engine tick: admit, then one decode step for all active
        slots and one SLO flush. Returns the number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        t0 = time.time()
        last = self._tokens()
        for i in active:
            r = self.slot_req[i]
            last[i, 0] = r.output[-1] if r.output else r.prompt[-1]
        pos = int(max(self.slot_pos[i] for i in active))
        logits, self.caches = self._decode(last, self.caches, pos)
        dt_ms = (time.time() - t0) * 1e3
        logits_np = logits[:, 0].float().cpu().numpy()
        for i in active:
            r = self.slot_req[i]
            r.output.append(self._sample(logits_np[i]))
            self.slot_pos[i] += 1
            self.slo.observe(r.route, "tok_q50_ms", dt_ms)
            if len(r.output) >= r.max_new_tokens \
                    or self.slot_pos[i] >= self.max_len - 1:
                r.t_done = time.time()
                self.slo.observe(r.route, "len_q50", float(len(r.output)))
                self.done.append(r)
                self.slot_req[i] = None
                if self.telemetry is not None:
                    self.telemetry.count("requests_completed")
        # One flush for everything this step observed.
        self.slo.flush()
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks

    def stats_snapshot(self):
        """A consistent ``service.Snapshot`` of the SLO route fleet,
        pinned to one cursor and held on the host."""
        return self.slo.snapshot()

    def stats_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-route {metric: estimate}, every route's numbers from one
        snapshot."""
        plane = self.stats_snapshot().estimate()    # [cap_routes, metrics]
        return {route: {name: float(plane[idx, i])
                        for i, (name, _) in enumerate(self.slo.metrics)}
                for route, idx in self.slo._routes.items()}
