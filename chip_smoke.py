#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and the CUDA
toolkit (``nvcc``, ``cuobjdump``), imports nothing of JAX, and exits
non-zero, printing no result, if any phase fails. Phases, one result line
each or more:

  1. device and build: the card's name and power limit, a clean build of
     both kernels (one nvcc per source, started together), registers and
     spills per instantiation of each; per dense family and Q = 1..5 the
     lanes per thread, static and dynamic shared memory, resident blocks
     per SM, and SASS instructions per lane-tick (the tick loop's
     instructions over its ticks and lanes per thread);
  2. dense kernel vs plain version: all six lane programs at 21,845 groups
     x 3 quantiles, T = 1024 ticks across the int32 wrap with NaN ticks,
     block sizes 32 / 256 / 1024 and the 128-row launches, then at every
     lanes-per-thread variant (Q = 1..5), each item producer (TMA where G %
     4 == 0, cp.async else) and Q = 5 with both, each bit-identical to the
     plain PyTorch version run on the card; the launches per producer;
  3. run kernel vs plain version: all six programs at 65,535 lanes, 16
     rounds of K = 4096 distinct-lane event slots (NaN events, mask-0
     slots, pads on one lane with no event, clocks across the int32 wrap),
     in place; then, per program, two batches of 4096 slots in runs of one
     lane's events (Zipf(1.2) lanes, longest run at least 256, NaN items
     and mask-0 slots inside runs, pad-only runs, hot lanes' clocks across
     the int32 wrap and window-epoch edges), one with a mask and one with
     mask=None, each in one launch; all bit-identical to the plain version
     run on the card (which applies runs round by round);
  4. golden: both kernels on the committed inputs of
     tests/data/torch_port_golden.npz equal the JAX package's outputs
     (dense words, sparse rounds, and one run batch against the JAX
     rounds applied in order);
  5. the dense main path at full width: FleetSpec(2^22 groups,
     q50/q90/q99, 2u, chunk_t 512), QuantileFleet.create on the card,
     ingest_stream of 8 chunks of [512, 2^22] lognormal items made on the
     card, estimate() after chunks 1, 4 and 8; the dense kernel's launch
     count over that run and its producer; the first and last 4096 groups'
     lanes equal to the plain version; a torch.profiler trace of the run
     (CUDA activity): the dense kernel's and the device's share of it and
     the largest device activities per chunk;
  6. the sparse main path at full width: per-lane-clock QuantileFleets of
     2^16 and 2^22 lanes in turns, twice (q90, 2u), each fed 72 rounds of
     K = 4096 distinct Zipf(1.2) lanes with lognormal items made on the
     card, and an SLOFleet of 10^6 routes x 3 metrics on the card fed 9
     flushes of 4096 Zipf(1.2)-routed observations; the run kernel's
     launch count (one per round for the fleets, one per flush for the
     SLOFleet), per-round ms, SLO events/s, peak memory; every plane and
     clock equal to the plain version run on the same events (the SLO
     fleet's: a second SLOFleet on the CPU);
  7. the kernels' times against their bounds and the plain versions'
     times: B1 (one launch over a [512, 2^22] chunk), B2 (the same chunk as
     128-row launches); B1 at 64 and 512 ticks and B2 at 512, at the dense
     shape (2^22 groups, Q = 3, 2u) and the service's (2^20, Q = 1,
     2u-decay), one launch between events and launches queued back to
     back, split into per-tick and per-launch cost, with the launch plan
     and producer; and B3 twice (one round of K = 4096 at L = 2^22; one
     SLO-sized flush of 4096 events in runs at L = 3 x 2^20, with its
     longest run and the serial-chain floor, the longest run times one
     tick's dependent latency measured on one thread), as the
     {"kernels": [...]} line;
  8. resilience on the main path, at phase 5's width with health policy
     "quarantine" and chunks made on the card from a generator seeded per
     chunk index: (a) a seeded stream kill in ingest_stream and a resume
     with skip_items; (b) a bit flip (sign plane, bit 22, a seeded lane)
     in the fourth chunk, caught by health() and healed by check_health();
     (c) a format-4 checkpoint after 4 chunks, restored on the card and
     continued; (d) the JAX package's committed checkpoints
     (tests/data/jax_checkpoints) restored on the card and continued to
     their golden words; (e) the SLO fleet of phase 6's size: a flush,
     check_health(), a checkpoint with events pending, a restore and 4
     more flushes. Each result bit-identical to the uninterrupted run (the
     healed lane to a lane created at its cursor); save, restore and
     health-scan times, bytes on disk, and the phase's dense and run
     kernel launches;
  9. the streaming service on the card, the JAX package's e14 deployment
     (benchmarks/bench_service_e2e.py): FleetSpec(2^20 groups, q50,
     2u-decay with half-life 2^16, chunk_t 64), seed 17, a "partner"
     tenant at epsilon 0.8, 24 chunks of [64, 2^20] items made on the
     host with numpy before any timed window (chunk k from seed (17, k),
     normal(50, 15)). (a) ingest only with put-ahead depth 1 and (a0)
     depth 0: items/s, apply ms, pin ms and H2D ms per chunk (CUDA events
     on the staging stream), the chunks-in-flight peak, peak device
     memory; (b) ingest with a reader paced as e14's (trusted and DP reads
     in turn): items/s against (a), query ms, the telemetry's own
     quantiles; (c) every answer of (b) bit-identical to a single-threaded
     replay on the card, whose last planes equal the plain version's
     replay; (d) a seeded query stall under load: counted once, ingest
     unperturbed, the retried read exact; (e) the JAX service's answers
     and telemetry histogram at 4096 groups (golden file); (f)
     SLOFleet.snapshot() at 10^6 routes x 3 metrics with events pending,
     unchanged by 3 donated flushes; (g) the token corpus staged on the
     card, 64 batches equal to numpy's; one more (a) run under
     torch.profiler: the dense kernel's and the device's share of it; the
     dense kernel at the service's chunk shape against its plain version
     and bound (one launch between events, and launches queued back to
     back); the phase's dense and run kernel launches and producers;
 10. the paper's evaluation through the fleet API, as
     benchmarks/bench_groupby_tcp.py and bench_groupby_twitter.py run it
     at full size: E3 (flow sizes and durations, 532 and 548 streams
     padded with NaN to [11996, 532] and [11988, 548]) and E5 (2392 user
     streams to [3198, 2392], 905 daily streams to [19990, 905]), each
     made with the port's data.streams, its CRC32 checked against the
     golden file first; per workload, algo 1u / 2u and q 0.5 / 0.9 one
     FleetSpec(G, (q,), chunk_t 4096) created with the key words of
     jax.random.PRNGKey(0) and fed the numpy block: estimates equal to the
     JAX package's (golden file), the q 0.5 fleets' planes to the plain
     version on the card (backend "jnp"), the fraction of streams within
     0.1 relative mass error, B1's launches and producer (TMA where
     G % 4 == 0, cp.async else), ms per ingest and of B1's launches
     alone on the stream (CUDA events; at the tuned block size, as the
     fleet launches them), items/s, B1's share of its bound, peak device
     memory; a
     FrugalEstimator (q50 and q90, 1u and 2u: B1 at G = 1) over one E3
     stream, equal to the plain version and the JAX package's; GK,
     q-digest and Selection on the first 40 E3 size streams at q = 0.5,
     equal to the JAX package's, with their fraction within 0.1, memory
     words and seconds on the host;
 11. placement across devices through the fleet API, per-device fleets on
     repeated entries of cuda:0 (the port's counterpart of a forced host
     device count) and loop-mode fleets: (a) E15 at its full size
     (benchmarks/bench_mesh2d.py: 2^20 groups, q50, 2u, chunk_t 64, the
     [512, 2^20] block of numpy seed 0, its CRC32 checked first) under a
     single placement, TopologySpec(lanes=8), (data=2, lanes=4) per device
     and in loop mode, each fed the host block: 1-D equal to single, 2 x 4
     per device equal to loop mode and to the JAX package's CRC32s, a split
     at row 301 equal to one ingest; then the elastic sequence (rows 0-255
     under 2 x 4, reshard to 4 x 2, rows 256-511, sync on the card equal to
     the numpy fold, reshard back, grow_groups(2^20 + 2^16), a checkpoint
     restored onto single, 1-D x 8 and 4 x 2, a quarantine of one replica's
     non-finite lane), each step against the golden CRC32s; ms per host-fed
     ingest, B1's device ms per ingest (torch.profiler), launches and
     producer, sync, reshard and checkpoint ms, peak memory and the
     device's busy share of a traced 2 x 4 ingest; (b) phase 5's dense cell
     under TopologySpec(data=2) (loop mode) fed phase 5's 8 chunks made on
     the card: each replica equal to a single fleet that ran only its
     chunks at their absolute offsets, the merged estimate and the card's
     sync equal to the numpy fold, ms per chunk period beside phase 5's;
     (c) the six programs at 1000 groups x 2 quantiles, T = 700, chunk_t 64
     under TopologySpec(data=3, lanes=2) in both modes: replica and merged
     planes equal to the golden file's, the card's sync at R = 3 equal to
     the numpy fold;
 12. the roofline layer on the card (repro_torch.roofline): (a) detection
     (detect_platform "gpu", detect_device_kind the card's name,
     detect_hw gpu-h100 with the device's SM count) and each family's
     issue-slot table at or below phase 1's SASS per lane-tick; (d) at
     every B1 launch shape of phases 5, 9, 10 and 11 (recorded from the
     entry points) and E16's: the tuner's block size, the model's plan
     (lanes per thread, tile rows and columns, shared memory, blocks)
     equal to dense_launch_info, 256 at phases 5 and 9, and the bound per
     launch, per E15 ingest and per data=2 chunk period; (f) E16's model
     check (analytic bytes at or above the operand floor); (c) the six
     programs at E3's shape, tuned blocks equal to 256; (e) B1 alone at
     the E3 and E5 blocks, at the tuned block size and at 256 (CUDA
     events); (b) E16 in full mode (benchmarks/bench_roofline.py: a
     [4096, 2^22] block of integers 0..999 made on the card, 1u / 2u /
     2u-window at Q = 1 and 2u at Q = 3) through frugal_update_auto at
     tuned blocks, one launch each: the prediction, measured items/s,
     fraction_of_roofline beside E16's 0.35 gate (information), and (c)
     the planes equal at 256, as 512-row launches, to the plain version
     over the block and over a 2^16-column slice at its lane offset;
 13. the serving engine (repro_torch.serve.ServeEngine, the port of the
     JAX package's serve/engine.py; its docstring prices 10^6 routes):
     (a) the golden file's reduced float32 yi-6b (the JAX package's
     weights) through params_from_numpy and the engine on the card under
     the golden maker's fake clock: the JAX engine's tokens, its first
     step logits within 1e-4, its stats_summary() and SLO state bit for
     bit; (b) yi-6b at full width (launch/serve.py's default arch: 32
     layers, d_model 4096, 32/4 GQA heads, d_ff 11008, vocab 64000,
     float32 parameters from a seeded torch generator, bf16 activations),
     ServeEngine(batch_slots=4, max_len=512) with 10^6 routes registered
     (3 x 2^20 SLO lanes, so every flush is one run kernel launch), 8
     requests from numpy seed 0 (prompts of 8-32 tokens, 16-32 new
     tokens, Zipf(1.2) routes): every request served with its token
     count, one B3 launch per engine step, the SLO planes and clocks
     bit-identical to a CPU SLOFleet replaying the engine's observations
     and flushes, the decode path's logits within 3e-2 x max|logit| of
     forward(..., last_only=True) over one request's tokens; ms per step
     (CUDA events around the decode call, the engine's host clock),
     decode tokens/s, TTFT p50/p99, B3 per flush, peak device memory, the
     step's bound (each layer's float32 weights once per use, the head,
     the embedding rows gathered and the KV cache read once at the
     gpu-h100 HwSpec's 3.35 TB/s) and its share, and a torch.profiler
     trace of 8 steps of a second engine (busy share, top device ops);
 14. the training path (repro_torch.train, optim, monitor, the port of the
     JAX package's train/ scaffold), which launches none of the port's
     kernels: (a) the golden file's narrowed float32 yi-6b TrainState (the
     JAX package's) carried onto the card through train_state_from_numpy,
     8 train steps on the golden batches (step-1 loss within 1e-5 relative
     and gradients within 1e-4 x max|g|, every loss within 1e-4 relative),
     the quantile clip and both monitor fleets fed the golden block norms
     and stats, bit for bit, and the committed JAX TrainState checkpoint
     (tests/data/jax_checkpoints/train, step 4) restored on the card and
     continued to step 8; (b) qwen2-vl-2b at full width (28 layers,
     d_model 1536, 12/2 GQA heads, d_ff 8960, vocab 151,936, tied, M-RoPE;
     1.544 B float32 parameters from a seeded generator, bf16
     activations) trained by Trainer.run for 30 steps with AdamW under
     warmup_cosine(1e-3, 10, 30), the quantile clip and the monitors on,
     on SyntheticCorpus batches of 8 x 64: the loss falling (mean of the
     last 5 below the first 5), qclip.warmup 30 with m moved off 1.0, the
     monitors positive, stragglers; ms per step (host clock, CUDA events),
     tokens/s, peak device memory, the step's bound (24 B per parameter
     at 3.35 TB/s against 6 x params x tokens matmul operations) and its
     share, and a torch.profiler trace of 2 more steps; (c)
     launch/train.py on the card killed at step 30 of 60 (exit 42) and
     restarted: resumed from step 30, finished at 60.

 15. the MoE and MLA families (repro_torch.models.layers.moe / mla, the
     blocks' moe / mla / mla_moe kinds, deepseek's dense prefix, the
     expert-load monitor's real groups): (a) the golden file's narrowed
     olmoe-1b-7b and deepseek-v2-lite-16b (the JAX package's TrainStates,
     moe/* keys) on the card: a forward's expert loads and drop fractions
     bit for bit (the routing), the engine under the fake clock (tokens,
     first step logits within 1e-4, summary and SLO state bit for bit),
     four train steps (losses within 1e-4 relative, the expert-load fleet
     bit for bit after each); (b) deepseek-v2-lite-16b at full width (27
     layers, d_model 2048, MLA with kv_lora 512, qk 128 + 64, v 128; 64
     experts top 6 plus 2 shared of d_ff 1408; a dense layer 0 of d_ff
     10,944; vocab 102,400; 15.7 B float32 parameters, 62.8 GB, from a
     seeded generator on the card after the earlier phases' memory is
     released and the free memory checked; bf16 activations) served as
     phase 13 (b) serves yi-6b (but 16 requests): 4 slots x 512, 10^6
     routes, one B3 launch per step, SLO state vs a CPU replay, the decode
     path vs forward at capacity factor 16.0 (no drops, as tests/test_arch_smoke.py
     holds JAX) within 3e-2 x max|logit|, ms per step, tokens/s, TTFT, peak
     memory, the byte bound's share, a traced second engine; (c)
     olmoe-1b-7b at full width (16 layers, 6.9 B parameters), 4 requests,
     the same checks, no trace; (d) olmoe at full width with its depth cut
     to 4 layers (1.88 B parameters, about 30 GB of AdamW state; reduced:
     all 16 would need 110.7 GB) trained by Trainer.run for 20 steps (AdamW,
     clip and monitors on, 8 x 64 tokens): the loss falling, the aux loss
     positive, the expert-load fleet's 4 x 64 = 256 lanes positive,
     load_imbalance, ms per step against its bound. (b) and (c) are the
     main path: B3 is counted from 0 around each run.
 16. the recurrent families (repro_torch.models.layers.mamba2 / rwkv6, the
     blocks' mamba / rwkv kinds, zamba2's one shared attention block):
     (a) the golden file's narrowed zamba2-2.7b, rwkv6-1.6b and rwkv6 in
     its H1 factorized form (the JAX package's TrainStates with every
     parameter leaf redrawn, ssm/* keys) on the card: forward logits and
     the engine's first step logits within 1e-4, its tokens, summary and
     SLO state bit for bit (the lockstep prefill advancing every row's
     recurrent state, as the JAX engine's does), four train steps (losses
     within 1e-4 relative, both activation fleets' sign planes and
     cursors bit for bit, m and step within 1e-4 x |m|); (b) zamba2-2.7b
     at full width (54 layers, d_model 2560: 45 mamba2 layers of d_inner
     5120 in 80 heads of 64, state 64, conv 4, chunk 128, and one shared
     attention block of 32 x 80 heads with a gated GELU MLP of d_ff
     10,240 at 9 positions; vocab 32,000 untied; 2.06 B float32
     parameters from a seeded generator, bf16 activations) and (c)
     rwkv6-1.6b at full width (24 layers, d_model 2048, 32 heads of 64,
     d_ff 7168, vocab 65,536, the baseline chunked form; 1.48 B
     parameters), each served as phase 13 (b) serves yi-6b: 4 slots x
     512, 10^6 routes, 8 requests, one B3 launch per step, SLO state vs
     a CPU replay, a fresh row's float32 decode vs forward over a
     136-token prompt (two chunks, the second padded) within 1e-4 x
     max|logit| (the bf16 difference reported), ms per step, tokens/s,
     TTFT, peak memory, the share of phase 13's byte bound (the shared
     block read at each of its 9 uses; the recurrent state in place of
     a KV cache), and a traced second engine; (d) rwkv6-1.6b at full width trained by
     Trainer.run for 20 steps (AdamW, clip and monitors on, 8 x 64
     tokens) after the earlier phases' memory is released and the free
     memory checked: the loss falling, the monitors positive, no frugal
     kernel launched, ms per step against its bound. (b) and (c) are the
     main path: B3 is counted from 0 around each run.
 17. the encoder-decoder (repro_torch.models.encdec.EncDecLM, the blocks'
     enc_attn / dec_cross kinds, make_serve_step(encdec_memory=True), the
     launcher's frames batch), which launches none of the port's kernels
     (both counts set to 0 before (b) and (c) and read after): (a) the
     golden file's reduced whisper-large-v3 at attention chunks of 16
     (the JAX package's parameters, every leaf redrawn, encdec/* keys) on
     the card: memory, forward logits and 12 serve_step calls' logits
     within 1e-4 x max |value|, the greedy tokens equal, three train
     steps from create_train_state (losses and grad norms within 1e-4
     relative, the clip's and both activation fleets' sign planes and
     cursors bit for bit, m and step within 1e-4 x |m|); (b)
     whisper-large-v3 at full width (32 + 32 layers, d_model 1280, 20
     heads of 64, d_ff 5120, vocab 51,866, tied; 1,576,752,640 float32
     parameters from a seeded generator, bf16 activations): 8 requests in
     two batches of 4, each batch's frames [4, 1500, 1280] from a seeded
     generator encoded once (two attention chunks), 4-token prompts fed
     one a call, then 60 greedy tokens through the serve step with a
     448-row cache: ms per encode and per decode call (CUDA events),
     tokens/s, peak memory, the call's bound (bytes against the cross
     K/V recomputed at every call) and share, traced windows of an encode
     and 8 calls; a fresh row's float32 decode against forward over 136
     tokens at every position within 1e-4 x max|logit| (the bf16 gap
     reported); (c) trained as launch/train.py trains it (8 x 64 tokens,
     frames [8, 16, 1280], AdamW, the clip's 6 groups and 32 monitor
     groups) for 20 steps: the loss falling, ms per step against its
     bound.

frugal_update_auto launches B1 at the roofline autotuner's block size
(repro_torch.roofline.autotune: 256 at the shapes of phases 5 and 9,
fewer threads at phase 10's). The last line is {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
GOLDEN_MAKER = ROOT / "tests" / "make_torch_port_golden.py"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/frugal_update.cu"
SCATTER_SOURCE = "src/repro_torch/kernels/csrc/frugal_scatter.cu"
TPU_KERNEL = "src/repro/kernels/frugal_update.py:393"
TPU_KERNEL_B2 = "src/repro/kernels/frugal_update.py:341"
TPU_KERNEL_B3 = "src/repro/kernels/frugal_update.py:271"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_trace(torch, fn):
    """Run ``fn()`` under torch.profiler with CUDA activity only. Returns
    (its result, {device activity: [calls, ms]}, ms the device was busy:
    the union of the activities' intervals). The dict and the busy time
    are None, and the reason printed, where the profiler gave no trace or
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        out = fn()
        torch.cuda.synchronize()
    names, spans = {}, []
    try:
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001 — a trace is a report only
        say("trace", note=f"no trace: {e!r}")
        return out, None, None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        name = re.sub(r"^void ", "", e.name).split("(")[0]
        row = names.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (b - a) / 1e3
        spans.append((a, b))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not names:
        say("trace", note="the profiler recorded no device activity")
        return out, None, None
    return out, names, busy / 1e3


def say_window(tag, of, names, busy_ms, window_ms, per, unit, card, top=6,
               **fields):
    """A traced window of ``per`` ``unit``s (chunks, calls, steps): its
    device busy share, ``fields``, and its ``top`` device activities, each
    per ``unit``. Without a trace (``names`` None) the share prints as
    null: not measured."""
    if names is None:
        say(tag, check="trace", of=of, window_ms=f"{window_ms:.4f}",
            device_busy_share="null", card=card,
            note="no device trace: not measured")
        return
    say(tag, check="trace", of=of, **{f"{unit}s": per},
        window_ms=f"{window_ms:.4f}", device_busy_ms=f"{busy_ms:.4f}",
        device_busy_share=f"{busy_ms / window_ms:.4f}", **fields,
        device_activities=sum(c for c, _ in names.values()), card=card,
        note="torch.profiler, CUDA activity only")
    for name, (calls, ms) in sorted(names.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        say(tag, check="trace", of=of, activity=name[:90], calls=calls,
            **{f"ms_per_{unit}": f"{ms / per:.4f}"},
            share=f"{ms / window_ms:.4f}")


def say_trace(phase, names, busy_ms, window_ms, per, card, top=6):
    """say_window of a fleet phase's ``per`` chunks, with the dense
    kernel's share of the window."""
    dense = {}
    if names is not None:
        ms = sum(ms for n, (_, ms) in names.items() if "frugal_dense" in n)
        dense = {"dense_kernel_ms": f"{ms:.4f}",
                 "dense_kernel_share": f"{ms / window_ms:.4f}"}
    say_window("trace", phase, names, busy_ms, window_ms, per, "chunk", card,
               top, **dense)


# --------------------------------------------------------------- phase 1
def _template_args(mangled: str):
    """(kernel, template int arguments) of a mangled frugal kernel name,
    or None."""
    m = re.search(r"(frugal_\w+_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return None
    return m.group(1), tuple(int(v) for v in re.findall(r"Li(\d+)E",
                                                        m.group(2)))


def ptxas_summary(log: str, kernel: str) -> dict:
    """{template arguments: (registers, spill store bytes, static shared
    memory bytes)} of ``kernel``'s instantiations, from nvcc -Xptxas -v.
    A dense instantiation's arguments are (family id, lanes per thread,
    block-size bound)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            got = _template_args(m.group(1))
            key = got[1] if got and got[0] == kernel else None
            continue
        if key is None:
            continue
        row = out.setdefault(key, [None, None, 0])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            row[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            row[2] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def sass_tick_loops(so_path: Path) -> dict:
    """{template arguments: instructions in the tick loop} of each dense
    instantiation, from cuobjdump -sass.

    Backward branches mark loops; the tick loop is the longest innermost
    one (no other loop inside it), which leaves out the tile loop around
    it. sm_90 instructions are 16 bytes, so a loop's length is its
    address span / 16."""
    from repro_torch.kernels.build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(so_path)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()}")
    spans, key = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            got = _template_args(m.group(1))
            key = got[1] if got and got[0] == "frugal_dense_kernel" else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/.*\bBRA\b[^;]*?0x([0-9a-f]+)",
                      line)
        if m and key is not None:
            at, target = int(m.group(1), 16), int(m.group(2), 16)
            if target < at:
                spans.setdefault(key, []).append((target, at))
    loops = {}
    for key, ss in spans.items():
        inner = [(a, b) for a, b in ss
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in ss)]
        loops[key] = max((b - a) // 16 + 1 for a, b in inner)
    return loops


BUILD_QS = (1, 2, 3, 4, 5)     # lanes per group reported in phase 1


def phase_build():
    """Returns {family: SASS instructions per lane-tick at Q = 3}."""
    from repro_torch.kernels import build
    from repro_torch.kernels import frugal_update as fk

    res = build.build_library(force=True)
    names = {v: k for k, v in fk.FAMILY_IDS.items()}
    regs = ptxas_summary(res.log, "frugal_dense_kernel")
    scatter_regs = ptxas_summary(res.log, "frugal_scatter_kernel")
    loops = sass_tick_loops(res.path)
    fams = sorted(names)
    if sorted({k[0] for k in regs}) != fams or sorted(regs) != sorted(loops) \
            or sorted(k[0] for k in scatter_regs) != fams:
        fail(f"build: dense {sorted(regs)} / loops {sorted(loops)} / "
             f"scatter {sorted(scatter_regs)} != families {fams}"
             f"\n{res.log}")
    say("build", seconds=f"{res.seconds:.2f}", library=res.path.name,
        sources="+".join(build.KERNEL_SOURCES), note="one nvcc per source")
    build.load_library()
    per_lane_tick = {}
    for fid in fams:
        for q in BUILD_QS:
            info = fk.dense_launch_info(fid, CHUNK_T, G_FULL, q)
            # (family, lanes per thread, the block-size bound it was built
            # for: 256, or 1024 for larger blocks)
            key = (fid, info["lanes_per_thread"],
                   256 if info["block_threads"] <= 256 else 1024)
            if key not in regs:
                fail(f"build: no dense instantiation {key} for Q = {q}")
            r, spill, smem = regs[key]
            lt = loops[key] / (info["ticks_per_step"]
                               * info["lanes_per_thread"])
            if q == len(QS):
                per_lane_tick[names[fid]] = lt
            say("build", kernel="dense", family=names[fid], q=q,
                lanes_per_thread=info["lanes_per_thread"], registers=r,
                spill_store_bytes=spill, static_smem_bytes=smem,
                dynamic_smem_bytes=info["smem_bytes"],
                blocks_per_sm=info["blocks_per_sm"],
                block_threads=info["block_threads"],
                sass_loop_instructions=loops[key],
                ticks_per_loop=info["ticks_per_step"],
                sass_per_lane_tick=f"{lt:.2f}")
    for (fid,), (r, spill, _) in sorted(scatter_regs.items()):
        say("build", kernel="scatter", family=names[fid], registers=r,
            spill_store_bytes=spill)
    return per_lane_tick


# --------------------------------------------------------------- phase 2
def random_planes(torch, prog, lanes, gen, dev):
    planes = []
    for f in prog.layout.plane_fields:
        if f in prog.layout.heads:
            x = torch.randn(lanes, generator=gen, device=dev) * 200.0
        elif f.startswith("step"):
            x = torch.randint(-8, 9, (lanes,), generator=gen,
                              device=dev).float()
        else:
            x = torch.randint(0, 2, (lanes,), generator=gen,
                              device=dev).float() * 2.0 - 1.0
        planes.append(x)
    return tuple(planes)


# (G, Q) of phase 2: 21845 x 3 at three block sizes and as 128-row
# launches (cp.async, G % 4 = 1); then every lanes-per-thread variant, each
# producer, and Q = 5 (one lane per thread) with each producer.
FAMILY_SHAPES = ((21845, 3), (21844, 3), (65536, 1), (32767, 2), (16384, 4),
                 (13107, 5), (13108, 5))


def producers_since(fk, before) -> str:
    return ",".join(f"{k}={v - before[k]}"
                    for k, v in fk.producer_launch_count.items())


def phase_families(torch):
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    t = 1024
    t_off, g_off, seed = 2 ** 31 - 300, 12345, 777
    g_max = max(g for g, _ in FAMILY_SHAPES)
    all_items = torch.empty((t, g_max), device=dev).log_normal_(
        3.0, 1.0, generator=gen)
    all_items[torch.rand((t, g_max), generator=gen, device=dev) < 0.03] = \
        float("nan")
    all_items[::97] = float("nan")                   # whole NaN rows
    before = dict(fk.producer_launch_count)
    for prog in program_mod.test_instances():
        runs_done = 0
        for g, q in FAMILY_SHAPES:
            lanes = g * q
            items = all_items[:, :g].contiguous()
            quantile = torch.tensor([0.5, 0.9, 0.99, 0.1, 0.75][:q],
                                    device=dev).repeat(g)
            planes = random_planes(torch, prog, lanes, gen, dev)
            words = tuple(w.contiguous()
                          for w in prog.layout.pack_planes(planes))
            want = fk.frugal_program_dense_reference(
                prog, items, words, quantile, seed, t_offset=t_off,
                g_offset=g_off, lanes_per_group=q)
            kw = dict(program=prog, t_offset=t_off, g_offset=g_off,
                      lanes_per_group=q)
            sizes = (32, 256, 1024) if (g, q) == FAMILY_SHAPES[0] else (256,)
            runs = {f"G={g},Q={q} auto/block_g={bg}": (
                lambda bg=bg: ops.frugal_update_auto(
                    items, planes, quantile, seed=seed, block_g=bg, **kw))
                for bg in sizes}
            if (g, q) == FAMILY_SHAPES[0]:
                runs[f"G={g},Q={q} blocked/block_g=256,block_t=128"] = (
                    lambda: ops.frugal_update_blocked(
                        items, planes, quantile, seed, block_g=256,
                        block_t=128, **kw))
            for label, run in runs.items():
                got_words = prog.layout.pack_planes(run())
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(got_words, want)):
                    diff = a.view(torch.int32) != b.view(torch.int32)
                    if bool(diff.any()):
                        fail(f"{prog.family} {label}: word {i} differs from "
                             f"the plain version in {int(diff.sum())} "
                             "lane(s)")
            runs_done += len(runs)
        say("families", program=prog.family,
            shapes=";".join(f"{g}x{q}" for g, q in FAMILY_SHAPES), ticks=t,
            runs=runs_done, result="bit-identical")
    say("families", producers=producers_since(fk, before))


# --------------------------------------------------------------- phase 3
SCATTER_LANES, SCATTER_K, SCATTER_ROUNDS = 65535, 4096, 16
SCATTER_G_OFFSET = 2 ** 31 - 30000   # absolute lane ids wrap
RUN_LONGEST_MIN = 256


def golden_module():
    """tests/make_torch_port_golden.py (numpy only at import): the sparse
    round and run batch generators and the golden file's sparse and run
    keys."""
    spec = importlib.util.spec_from_file_location("make_torch_port_golden",
                                                  GOLDEN_MAKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_bits(torch, got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def phase_scatter(torch, gm):
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    for i, prog in enumerate(program_mod.test_instances()):
        planes, ticks, quantile, rounds = gm.sparse_case(
            prog, SCATTER_LANES, SCATTER_K, SCATTER_ROUNDS, 20 + i)
        kp = tuple(torch.from_numpy(p).to(dev) for p in planes)
        kt = torch.from_numpy(ticks).to(dev)
        rp, rt = tuple(p.clone() for p in kp), kt.clone()
        q = torch.from_numpy(quantile).to(dev)
        ptrs = [p.data_ptr() for p in kp] + [kt.data_ptr()]
        for lanes, items, mask in rounds:
            ev = [torch.from_numpy(x).to(dev) for x in (lanes, items, mask)]
            kp, kt = ops.frugal_update_sparse(
                *ev, kp, kt, q, 555, program=prog,
                g_offset=SCATTER_G_OFFSET, donate=True)
            rp, rt = fk.frugal_program_scatter_reference(
                prog, *ev, rp, rt, q, 555, g_offset=SCATTER_G_OFFSET)
        torch.cuda.synchronize()
        if [p.data_ptr() for p in kp] + [kt.data_ptr()] != ptrs:
            fail(f"scatter {prog.family}: donate=True moved the state")
        if not same_bits(torch, kp + (kt,), rp + (rt,)):
            fail(f"scatter {prog.family}: planes or clocks differ from the "
                 "plain version")
        say("scatter", program=prog.family, lanes=SCATTER_LANES,
            rounds=SCATTER_ROUNDS, slots_per_round=SCATTER_K,
            mask0_slots_per_round=40, in_place="yes", result="bit-identical")
    for i, prog in enumerate(program_mod.test_instances()):
        for masked in (True, False):
            run_batch_vs_plain(torch, gm, prog, 40 + i, masked)


def run_batch_vs_plain(torch, gm, prog, seed, masked):
    """One batch of event runs (gm.run_events: Zipf(1.2) lanes, NaN items
    and mask-0 slots inside runs, pad-only runs, hot lanes' clocks across
    the int32 wrap and window-epoch edges) in one launch, against the
    plain version's rounds. With a mask, mask-0 slots carry finite items,
    which both must force to NaN; without one, mask=None."""
    import numpy as np
    from repro_torch.kernels import frugal_update as fk

    dev = torch.device("cuda")
    planes, ticks, quantile, (lanes, items, mask), _ = gm.run_case(
        prog, SCATTER_LANES, SCATTER_K, seed)
    longest = int(gm.run_lengths(lanes).max())
    if longest < RUN_LONGEST_MIN:
        fail(f"runs {prog.family}: longest run {longest} < "
             f"{RUN_LONGEST_MIN}")
    if masked:
        items = np.where(mask == 0, np.float32(123.0), items)
    ev = [torch.from_numpy(x).to(dev) for x in (lanes, items, mask)]
    if not masked:
        ev[2] = None
    kp = tuple(torch.from_numpy(p).to(dev) for p in planes)
    kt = torch.from_numpy(ticks).to(dev)
    rp, rt = tuple(p.clone() for p in kp), kt.clone()
    q = torch.from_numpy(quantile).to(dev)
    before = fk.scatter_launch_count
    fk.frugal_program_scatter(prog, *ev, kp, kt, q, 555,
                              g_offset=SCATTER_G_OFFSET)
    launches = fk.scatter_launch_count - before
    fk.frugal_program_scatter_reference(prog, *ev, rp, rt, q, 555,
                                        g_offset=SCATTER_G_OFFSET)
    torch.cuda.synchronize()
    if launches != 1:
        fail(f"runs {prog.family}: {launches} launches for one batch")
    if not same_bits(torch, kp + (kt,), rp + (rt,)):
        fail(f"runs {prog.family} ({'mask' if masked else 'mask=None'}): "
             "planes or clocks differ from the plain version's rounds")
    say("runs", program=prog.family, lanes=SCATTER_LANES,
        slots=len(lanes), runs=len(gm.run_lengths(lanes)),
        longest_run=longest, mask="given" if masked else "None",
        launches=launches, result="bit-identical to the plain version's "
        f"{longest} rounds")


# --------------------------------------------------------------- phase 4
def phase_golden(torch, gm):
    import numpy as np
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk

    data = np.load(GOLDEN)
    g, q, t, t_off, g_off, seed = (int(v) for v in data["meta"])
    dev = torch.device("cuda")
    items = torch.from_numpy(data["items"]).to(dev)
    quantile = torch.from_numpy(data["quantile"]).to(dev)
    staged = dict(fk.producer_launch_count)
    for prog in program_mod.test_instances():
        n = prog.layout.num_words
        words = tuple(torch.from_numpy(data[f"{prog.family}/in{i}"]).to(dev)
                      for i in range(n))
        scalars = tuple(int(s) for s in data[f"{prog.family}/scalars"])
        out = fk.frugal_program_dense(prog, items, words, quantile, seed,
                                      scalars, t_offset=t_off,
                                      g_offset=g_off, lanes_per_group=q)
        for i, o in enumerate(out):
            want = data[f"{prog.family}/out{i}"]
            if not np.array_equal(o.cpu().numpy().view(np.int32),
                                  want.view(np.int32)):
                fail(f"golden: {prog.family} word {i} differs from the JAX "
                     "package's output")
    say("golden", kernel="dense", programs=len(program_mod.test_instances()),
        lanes=g * q, ticks=t, producers=producers_since(fk, staged),
        result="bit-identical to the JAX package")
    q_sparse = torch.from_numpy(data["sparse/quantile"]).to(dev)
    rounds = gm.sparse_rounds(data, lambda x: torch.from_numpy(x).to(dev))
    for prog in program_mod.test_instances():
        ps, tk = gm.sparse_start(data, prog,
                                 lambda x: torch.from_numpy(x).to(dev))
        for lanes, items, mask in rounds:
            ps, tk = fk.frugal_program_scatter(
                prog, lanes, items, mask, ps, tk, q_sparse,
                gm.COUNTER_SEED, g_offset=gm.SPARSE_G_OFFSET)
        want = [torch.from_numpy(w).to(dev)
                for w in gm.sparse_final(data, prog)]
        if not same_bits(torch, ps + (tk,), want):
            fail(f"golden: scatter {prog.family} differs from the JAX "
                 "package's sparse rounds")
    say("golden", kernel="scatter",
        programs=len(program_mod.test_instances()),
        lanes=int(q_sparse.numel()), rounds=len(rounds),
        result="bit-identical to the JAX package")
    batch = gm.runs_batch(data, lambda x: torch.from_numpy(x).to(dev))
    for prog in program_mod.test_instances():
        ps, tk = gm.runs_start(data, prog,
                               lambda x: torch.from_numpy(x).to(dev))
        ps, tk = fk.frugal_program_scatter(prog, *batch, ps, tk, q_sparse,
                                           gm.COUNTER_SEED,
                                           g_offset=gm.SPARSE_G_OFFSET)
        want = [torch.from_numpy(w).to(dev)
                for w in gm.runs_final(data, prog)]
        if not same_bits(torch, ps + (tk,), want):
            fail(f"golden: run batch {prog.family} differs from the JAX "
                 "package's rounds")
    say("golden", kernel="scatter (one run batch)",
        programs=len(program_mod.test_instances()),
        slots=int(batch[0].numel()),
        longest_run=int(gm.run_lengths(data["runs/lanes"]).max()),
        result="bit-identical to the JAX package's rounds")


# --------------------------------------------------------------- phase 5
G_FULL, QS, CHUNK_T, N_CHUNKS, EDGE = 2 ** 22, (0.5, 0.9, 0.99), 512, 8, 4096
B2_ROWS = 128


def phase_main_path(torch, card):
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet
    from repro_torch.core import frugal
    from repro_torch.kernels import frugal_update as fk

    dev = torch.device("cuda")
    spec = FleetSpec(num_groups=G_FULL, quantiles=QS, program="2u",
                     chunk_t=CHUNK_T)
    fleet = QuantileFleet.create(spec, seed=0)
    if fleet.device.type != "cuda":
        fail(f"the fleet was created on {fleet.device}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    exp_scale = torch.exp(torch.empty(G_FULL, device=dev).uniform_(
        3.0, 8.0, generator=gen))
    sample = torch.randperm(G_FULL, generator=gen, device=dev)[:EDGE]
    kept, marks = [], []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def chunks():
        for _ in range(N_CHUNKS):
            mark()                      # stream time at the chunk's start
            x = torch.empty((CHUNK_T, G_FULL), device=dev).log_normal_(
                0.0, 1.0, generator=gen)
            x.mul_(exp_scale)
            kept.append((x[:, :EDGE].clone(), x[:, -EDGE:].clone(),
                         x[:, sample]))
            yield x

    def run(fleet):
        stream = chunks()
        ingest_s, est_ms, estimates = 0.0, [], None
        for n in (1, 3, 4):             # estimate() after chunks 1, 4, 8
            t0 = time.perf_counter()
            fleet = fleet.ingest_stream(itertools.islice(stream, n))
            torch.cuda.synchronize()
            ingest_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            estimates = fleet.estimate()
            est_ms.append((time.perf_counter() - t0) * 1e3)
            if estimates.shape != (G_FULL, len(QS)) or \
                    not np.isfinite(estimates).all():
                fail(f"estimate(): shape {estimates.shape}, finite "
                     f"{np.isfinite(estimates).mean():.6f}")
        mark()
        return fleet, ingest_s, est_ms, estimates

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = 0
    staged = dict(fk.producer_launch_count)
    (fleet, ingest_s, est_ms, estimates), names, busy = device_trace(
        torch, lambda: run(fleet))
    launches = fk.launch_count
    producers = producers_since(fk, staged)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    # Chunk periods on the stream (make items + kernel + packing), after
    # the first chunk; the periods of chunks 4 and 8 include estimate().
    periods = [a.elapsed_time(b) for a, b in zip(marks[1:-1], marks[2:])]
    if launches != N_CHUNKS:
        fail(f"main path launched the kernel {launches} times, expected "
             f"{N_CHUNKS}")
    t_total = CHUNK_T * N_CHUNKS
    if fleet.cursor.t_offset != t_total:
        fail(f"cursor at {fleet.cursor.t_offset}, expected {t_total}")

    # The first and last 4096 groups' lanes against the plain version on
    # the card, each slice keyed at its own absolute lane offset.
    q = len(QS)
    quantile = torch.tensor(QS, dtype=torch.float32, device=dev).repeat(EDGE)
    prog = spec.program
    for name, idx, lane0 in (("first", 0, 0),
                             ("last", 1, spec.num_lanes - q * EDGE)):
        items = torch.cat([k[idx] for k in kept])
        fresh = (torch.zeros(q * EDGE, device=dev),
                 torch.ones(q * EDGE, device=dev),
                 torch.ones(q * EDGE, device=dev))
        want, _ = frugal.program_process_seeded(
            prog, fresh, items, 0, quantile, g_offset=lane0,
            lanes_per_group=q)
        for f, w in zip(prog.layout.plane_fields, want):
            got = getattr(fleet.state, f)[lane0:lane0 + q * EDGE]
            if not torch.equal(got.view(torch.int32), w.view(torch.int32)):
                fail(f"main path: {name} {EDGE} groups, plane {f} differs "
                     "from the plain version")

    sampled = torch.cat([k[2] for k in kept])
    truth = torch.quantile(sampled, torch.tensor(QS, device=dev), dim=0)
    est = torch.from_numpy(estimates).to(dev)[sample]
    rel = [float((est[:, i] / truth[i] - 1.0).abs().median())
           for i in range(q)]
    items_total = t_total * G_FULL
    say("main", groups=G_FULL, quantiles=",".join(map(str, QS)),
        lanes=spec.num_lanes, ticks=t_total, chunks=N_CHUNKS,
        kernel_launches=launches, producers=producers,
        edge_slices="bit-identical", estimates="finite")
    say("main", items_per_s=f"{items_total / ingest_s:.4e}",
        lane_ticks_per_s=f"{items_total * q / ingest_s:.4e}",
        ingest_s=f"{ingest_s:.4f}", note="includes making items on the card")
    say("main", chunk_period_ms=",".join(f"{v:.4f}" for v in periods),
        median_chunk_period_ms=f"{statistics.median(periods):.4f}")
    say("main", estimate_ms=",".join(f"{v:.2f}" for v in est_ms),
        max_memory_allocated_bytes=peak)
    # The trace covers all 8 chunks and the three estimate() calls; the
    # kernel's share of a chunk period leaves the estimates out.
    say_trace(5, names, busy, marks[0].elapsed_time(marks[-1]), N_CHUNKS,
              card)
    if names is not None:
        per_chunk = sum(ms for n, (_, ms) in names.items()
                        if "frugal_dense" in n) / N_CHUNKS
        say("trace", of=5, dense_kernel_ms_per_chunk=f"{per_chunk:.4f}",
            median_chunk_period_ms=f"{statistics.median(periods):.4f}",
            dense_kernel_share_of_period=(
                f"{per_chunk / statistics.median(periods):.4f}"))
    say("main", median_rel_err=",".join(f"q{int(round(qq * 100))}={r:.4f}"
                                        for qq, r in zip(QS, rel)),
        sampled_groups=EDGE, note="informational")
    return launches, statistics.median(periods)


# --------------------------------------------------------------- phase 6
L_SMALL, L_LARGE, K_ROUND, ZIPF_A = 2 ** 16, 2 ** 22, 4096, 1.2
ROUNDS_WARM, ROUNDS_TIMED = 8, 64
SLO_ROUTES, SLO_FLUSHES, SLO_EVENTS, SLO_HOT = 10 ** 6, 8, 4096, 16


def zipf_rounds(torch, n_lanes, n, gen):
    """n rounds of (K_ROUND distinct Zipf(1.2) lane ids, sorted; lognormal
    items), made on the card: lane i is drawn with weight (i+1)^-1.2,
    without replacement within a round."""
    dev = torch.device("cuda")
    weights = torch.arange(1, n_lanes + 1, dtype=torch.float64,
                           device=dev).pow_(-ZIPF_A)
    rounds = []
    for _ in range(n):
        lanes = torch.multinomial(weights, K_ROUND, replacement=False,
                                  generator=gen)
        items = torch.empty(K_ROUND, device=dev).log_normal_(
            3.0, 0.5, generator=gen)
        rounds.append((lanes.sort().values.to(torch.int32), items))
    return rounds


def sparse_fleet_run(torch, n_lanes, gen):
    """A per-lane-clock fleet of n_lanes (q90, 2u) on the card through
    ROUNDS_WARM + ROUNDS_TIMED rounds of tick_lanes_sparse(donate=True);
    its planes and clocks checked against the plain version's replay."""
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet
    from repro_torch.kernels import frugal_update as fk

    dev = torch.device("cuda")
    spec = FleetSpec(num_groups=n_lanes, quantiles=(0.9,), program="2u")
    rounds = zipf_rounds(torch, n_lanes, ROUNDS_WARM + ROUNDS_TIMED, gen)
    fleet = QuantileFleet.create(spec, seed=0, per_lane_clock=True)
    if fleet.device.type != "cuda":
        fail(f"the sparse fleet was created on {fleet.device}")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    fk.scatter_launch_count = 0
    for i, (lanes, items) in enumerate(rounds):
        if i == ROUNDS_WARM:
            torch.cuda.synchronize()
            a.record()
            t0 = time.perf_counter()
        fleet = fleet.tick_lanes_sparse(lanes, items, donate=True)
    b.record()
    host_s = time.perf_counter() - t0
    b.synchronize()
    launches = fk.scatter_launch_count
    if launches != len(rounds):
        fail(f"sparse L={n_lanes}: {launches} scatter launches for "
             f"{len(rounds)} rounds")
    prog = spec.program
    planes = (torch.zeros(n_lanes, device=dev),
              torch.ones(n_lanes, device=dev),
              torch.ones(n_lanes, device=dev))
    ticks = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    mask = torch.ones(K_ROUND, dtype=torch.int32, device=dev)
    for lanes, items in rounds:
        planes, ticks = fk.frugal_program_scatter_reference(
            prog, lanes, items, mask, planes, ticks, fleet.state.quantile, 0)
    if not same_bits(torch, fleet.state.planes() + (fleet.cursor.t_offset,),
                     planes + (ticks,)):
        fail(f"sparse L={n_lanes}: planes or clocks differ from the plain "
             "version")
    est = fleet.estimate()
    if est.shape != (n_lanes, 1) or not np.isfinite(est).all():
        fail(f"sparse L={n_lanes}: estimate() shape {est.shape}")
    events = int(fleet.cursor.t_offset.sum())
    if events != len(rounds) * K_ROUND:
        fail(f"sparse L={n_lanes}: clocks hold {events} events")
    stream_ms = a.elapsed_time(b) / ROUNDS_TIMED
    say("sparse", lanes=n_lanes, rounds=len(rounds),
        events_per_round=K_ROUND, kernel_launches=launches,
        round_ms_stream=f"{stream_ms:.5f}",
        round_ms_host=f"{host_s * 1e3 / ROUNDS_TIMED:.5f}",
        events_per_s=f"{K_ROUND / stream_ms * 1e3:.4e}",
        planes_and_clocks="bit-identical to the plain version (all lanes)")
    return launches, stream_ms


def slo_run(torch):
    """SLOFleet at 10^6 routes x 3 metrics on the card through observe()
    and flush(); the same observations into an SLOFleet on the CPU (the
    plain version); the hottest routes' summaries and all state equal."""
    import numpy as np
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.serve import DEFAULT_METRICS, SLOFleet

    metrics = [m for m, _ in DEFAULT_METRICS]
    rng = np.random.default_rng(0)
    names = [f"route-{i}" for i in range(SLO_ROUTES)]
    flushes = [((rng.zipf(ZIPF_A, SLO_EVENTS) - 1) % SLO_ROUTES,
                rng.integers(0, len(metrics), SLO_EVENTS),
                rng.lognormal(3.0, 1.0, SLO_EVENTS))
               for _ in range(1 + SLO_FLUSHES)]
    # A per-round path would split a flush into as many rounds as its
    # busiest lane has events; the run kernel takes the flush in one launch.
    rounds = sum(int(np.unique(r * len(metrics) + m,
                               return_counts=True)[1].max())
                 for r, m, _ in flushes)

    def drive(fleet):
        seconds = []
        for r, m, v in flushes:
            t0 = time.perf_counter()
            for ri, mi, vi in zip(r.tolist(), m.tolist(), v.tolist()):
                fleet.observe(names[ri], metrics[mi], vi)
            fleet.flush()
            if fleet.device.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return seconds

    card = SLOFleet(seed=0, capacity=64)
    if card.device.type != "cuda":
        fail(f"the SLO fleet was created on {card.device}")
    t0 = time.perf_counter()
    card.ensure_routes(names)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    fk.scatter_launch_count = 0
    seconds = drive(card)
    launches = fk.scatter_launch_count
    if launches != len(flushes):
        fail(f"SLO path: {launches} scatter launches for {len(flushes)} "
             "flushes")
    plain = SLOFleet(seed=0, capacity=64, device="cpu")
    plain.ensure_routes(names)
    drive(plain)
    counts = np.bincount(np.concatenate([r for r, _, _ in flushes]),
                         minlength=SLO_ROUTES)
    hot = [names[i] for i in np.argsort(-counts, kind="stable")[:SLO_HOT]]
    for route in hot:
        got, want = card.summary(route), plain.summary(route)
        if any(np.float32(got[k]).view(np.int32)
               != np.float32(want[k]).view(np.int32) for k in metrics):
            fail(f"SLO path: summary of {route} {got} != plain {want}")
    for name in ("_m", "_step", "_sign", "_ticks"):
        if not torch.equal(getattr(card, name).cpu(), getattr(plain, name)):
            fail(f"SLO path: {name} differs from the plain version")
    timed = seconds[1:]
    events_per_s = SLO_EVENTS * len(timed) / sum(timed)
    say("slo", routes=SLO_ROUTES, metrics=len(metrics),
        lanes=card._cap_routes * len(metrics), flushes=len(flushes),
        events_per_flush=SLO_EVENTS, longest_runs_summed=rounds,
        kernel_launches=launches, register_routes_s=f"{register_s:.3f}")
    say("slo", events_per_s=f"{events_per_s:.1f}",
        flush_ms=",".join(f"{x * 1e3:.2f}" for x in timed),
        median_flush_ms=f"{statistics.median(timed) * 1e3:.3f}",
        note="host clock: observe() x 4096 + flush() + sync, after one "
             "warm-up flush")
    say("slo", hottest_routes=SLO_HOT, summaries="bit-identical to the "
        "plain version", state="all lanes and clocks bit-identical")
    return launches


def phase_sparse_path(torch):
    """(launches of the per-round fleets, launches of the SLO fleet)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Small and large in turns, twice: the spread of the per-round time
    # shows beside the difference the lane count makes.
    launches, ms = 0, {L_SMALL: [], L_LARGE: []}
    for n_lanes in (L_SMALL, L_LARGE, L_SMALL, L_LARGE):
        n, round_ms = sparse_fleet_run(torch, n_lanes, gen)
        launches += n
        ms[n_lanes].append(round_ms)
    slo_launches = slo_run(torch)
    peak = torch.cuda.max_memory_allocated()
    say("sparse", round_ms_ratio_large_over_small=",".join(
        f"{b / a:.4f}" for a, b in zip(ms[L_SMALL], ms[L_LARGE])),
        max_memory_allocated_bytes=peak, kernel_launches=launches,
        slo_kernel_launches=slo_launches)
    return launches, slo_launches


# --------------------------------------------------------------- phase 7
def event_ms(torch, fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def card_sm_clocks_per_s(torch):
    """(SM clocks per second over the whole card, max SM clock in Hz)."""
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return props.multi_processor_count * clock_hz, clock_hz


def card_hw(torch):
    """The card's HwSpec in the roofline registry: gpu-h100, with the
    device's own SM count (the model prices the operations over
    ``cores`` SMs)."""
    from repro_torch.roofline import detect_hw

    hw = detect_hw("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if hw.name != "gpu-h100" or hw.cores != sms:
        fail(f"roofline: the card reads as HwSpec {hw.name!r} with "
             f"{hw.cores} SMs, the device has {sms}: this run prices an "
             "H100 (gpu-h100, 132 SMs)")
    return hw


def tuned_block_g(torch, prog, g, t, q):
    """The roofline autotuner's block size on the card for [t, g] items at
    q lanes per group (what frugal_update_auto launches)."""
    from repro_torch.roofline import autotune_blocks

    return autotune_blocks(prog, g, t, q, hw=card_hw(torch))[0]


def dense_bound(torch, prog, g, t, q, real_items=None):
    """The roofline model of one dense call of [t, g] items at q lanes per
    group (repro_torch.roofline.predict_kernel, block_t = t: the
    function's bytes, each input read and each output written once), its
    operations priced at the card's maximum SM clock."""
    from repro_torch.roofline import predict_kernel

    _, clock_hz = card_sm_clocks_per_s(torch)
    return predict_kernel(g, t, q, prog.layout, block_g=256, block_t=t,
                          hw=card_hw(torch), sm_clock_hz=clock_hz,
                          real_items=real_items)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bytes_ms, ops_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def max_abs_err(planes_a, planes_b) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(planes_a,
                                                          planes_b))


def phase_timing(torch, loops, launches, card):
    """B1 (one launch over a [512, 2^22] chunk) and B2 (the same chunk as
    128-row launches, the tick offset advanced): the same function, so
    one bound."""
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.roofline import kernel_model as km

    dev = torch.device("cuda")
    prog = program_mod.make_program("2u")
    q = len(QS)
    lanes = G_FULL * q
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    items = torch.empty((CHUNK_T, G_FULL), device=dev).log_normal_(
        5.0, 1.0, generator=gen)
    gen_ms = event_ms(torch, lambda: torch.empty(
        (CHUNK_T, G_FULL), device=dev).log_normal_(0.0, 1.0, generator=gen),
        3)
    quantile = torch.tensor(QS, device=dev).repeat(G_FULL)
    planes = (torch.zeros(lanes, device=dev), torch.ones(lanes, device=dev),
              torch.ones(lanes, device=dev))
    words = tuple(w.contiguous() for w in prog.layout.pack_planes(planes))
    res = {}

    def kernel():
        res["kernel"] = fk.frugal_program_dense(prog, items, words, quantile,
                                                0, lanes_per_group=q)

    def blocked(run):
        w = words
        for r0 in range(0, CHUNK_T, B2_ROWS):
            w = run(prog, items[r0:r0 + B2_ROWS], w, quantile, 0,
                    t_offset=r0, lanes_per_group=q)
        return w

    def kernel_b2():
        res["kernel_b2"] = blocked(fk.frugal_program_dense)

    def plain():
        res["plain"] = fk.frugal_program_dense_reference(
            prog, items, words, quantile, 0, lanes_per_group=q)

    def plain_b2():
        res["plain_b2"] = blocked(fk.frugal_program_dense_reference)

    kernel_ms = event_ms(torch, kernel, 8)[1:]          # one warm-up
    b2_ms = event_ms(torch, kernel_b2, 8)[1:]
    plain_ms = event_ms(torch, plain, 1)
    plain_b2_ms = event_ms(torch, plain_b2, 1)
    errs = {}
    for got, want in (("kernel", "plain"), ("kernel_b2", "plain_b2")):
        errs[got] = max_abs_err(prog.layout.unpack_words(res[got]),
                                prog.layout.unpack_words(res[want]))
        if not all(torch.equal(a, b) for a, b in zip(res[got], res[want])):
            fail(f"full-width chunk: {got} differs from the plain version "
                 f"(max abs err {errs[got]})")
    if not all(torch.equal(a, b) for a, b in zip(res["kernel"],
                                                 res["kernel_b2"])):
        fail("full-width chunk: 128-row launches differ from one launch")

    pred = dense_bound(torch, prog, G_FULL, CHUNK_T, q)
    nbytes = int(pred["bytes_total"])
    bytes_ms = pred["bandwidth_s"] * 1e3
    ops_ms, ops_binding = pred["operations_s"] * 1e3, \
        pred["operations_bound_by"]
    sm_clocks_per_s, clock_hz = card_sm_clocks_per_s(torch)
    lane_ticks = CHUNK_T * lanes
    sass_ms = (loops["2u"] * lane_ticks
               / (sm_clocks_per_s * km.ISSUE_PER_SM_CLOCK) * 1e3)
    ms, ms_b2 = statistics.median(kernel_ms), statistics.median(b2_ms)
    bound = max(bytes_ms, ops_ms)
    say("timing", kernel="B1", kernel_ms=",".join(f"{v:.4f}"
                                                  for v in kernel_ms),
        plain_ms=f"{plain_ms[0]:.2f}",
        make_chunk_ms=",".join(f"{v:.4f}" for v in gen_ms))
    say("timing", kernel="B2", rows_per_launch=B2_ROWS,
        launches=CHUNK_T // B2_ROWS,
        kernel_ms=",".join(f"{v:.4f}" for v in b2_ms),
        plain_ms=f"{plain_b2_ms[0]:.2f}",
        bound_share=f"{bound / ms_b2:.4f}")
    say("timing", bytes=nbytes, bytes_ms=f"{bytes_ms:.4f}",
        operations_per_lane_tick=km.issue_slots(km.OPS_2U_LANE_TICK),
        operations_ms=f"{ops_ms:.4f}", operations_bound_by=ops_binding,
        lane_ticks=lane_ticks, sms=round(sm_clocks_per_s / clock_hz),
        max_sm_clock_hz=f"{clock_hz:.4e}",
        lane_ticks_per_s=f"{lane_ticks / ms * 1e3:.4e}",
        bound_share=f"{bound / ms:.4f}")
    say("timing", sass_per_lane_tick=f"{loops['2u']:.2f}",
        sass_issue_ms=f"{sass_ms:.4f}",
        note="diagnostic: this build's loop, not the function's need")
    dense_split(torch, "dense", prog, items, words, quantile, q, card)
    svc_prog = program_mod.make_program("2u-decay", half_life=1 << 16)
    svc_items = torch.empty((CHUNK_T, SVC_G), device=dev).normal_(
        50.0, 15.0, generator=gen)
    svc_words = tuple(w.contiguous() for w in svc_prog.layout.pack_planes(
        random_planes(torch, svc_prog, SVC_G, gen, dev)))
    dense_split(torch, "service", svc_prog, svc_items, svc_words,
                torch.full((SVC_G,), 0.5, device=dev), 1, card)
    del svc_items
    return [kernel_entry("frugal_program_dense", KERNEL_SOURCE, TPU_KERNEL,
                         launches, errs["kernel"], ms, plain_ms[0],
                         bytes_ms, ops_ms),
            # B2 is the same wrapper launched per B2_ROWS rows: its count
            # is the wrapper's, whose path launches run 512 rows each.
            kernel_entry(f"frugal_program_dense[{B2_ROWS}-row launches]",
                         KERNEL_SOURCE, TPU_KERNEL_B2, launches,
                         errs["kernel_b2"], ms_b2, plain_b2_ms[0], bytes_ms,
                         ops_ms)]


SPLIT_T = (64, 512)
SPLIT_QUEUED = 10       # launches queued back to back per device timing


def dense_split(torch, label, prog, items, words, quantile, q, card):
    """B1 over the first 64 and all 512 rows of ``items`` [512, G] at Q =
    ``q``, and B2 over all 512 as 128-row launches. Two timings each: one
    launch between CUDA events, median of 7 after a warm-up (the method of
    the kernel table; it includes the host's enqueue where the card waits
    for it), and the device time per launch of SPLIT_QUEUED launches queued
    back to back (median of 5). From the queued times: the per-tick cost
    (the difference over 448 ticks) and the per-launch rest; each length's
    bound and share; the launch plan (tile, producer, occupancy)."""
    from repro_torch.kernels import frugal_update as fk

    g = items.shape[1]
    lanes = g * q
    _, clock_hz = card_sm_clocks_per_s(torch)
    ms, dev_ms, bound = {}, {}, {}

    def b1(x):
        return lambda: fk.frugal_program_dense(prog, x, words, quantile, 0,
                                               lanes_per_group=q)

    def b2():
        w = words
        for r0 in range(0, SPLIT_T[-1], B2_ROWS):
            w = fk.frugal_program_dense(prog, items[r0:r0 + B2_ROWS], w,
                                        quantile, 0, t_offset=r0,
                                        lanes_per_group=q)

    for t in SPLIT_T:
        fn = b1(items[:t])
        ms[t] = statistics.median(event_ms(torch, fn, 8)[1:])
        dev_ms[t] = statistics.median(
            queued_ms(torch, fn, SPLIT_QUEUED, clock_hz)[0])
        bound[t] = dense_bound(torch, prog, g, t, q)["bound_s"] * 1e3
    b2_ms = statistics.median(event_ms(torch, b2, 8)[1:])
    b2_dev = statistics.median(queued_ms(torch, b2, 3, clock_hz)[0])
    lo, hi = SPLIT_T
    per_tick = (dev_ms[hi] - dev_ms[lo]) / (hi - lo)
    info = fk.dense_launch_info(fk.FAMILY_IDS[prog.kernel_family], hi, g, q,
                                items_ptr=items.data_ptr())
    say("timing", split=label, program=prog.family, groups=g, q=q,
        **{f"b1_ms_t{t}": f"{ms[t]:.4f}" for t in SPLIT_T},
        **{f"b1_device_ms_t{t}": f"{dev_ms[t]:.4f}" for t in SPLIT_T},
        b2_ms_t512=f"{b2_ms:.4f}", b2_device_ms_t512=f"{b2_dev:.4f}",
        **{f"bound_ms_t{t}": f"{bound[t]:.4f}" for t in SPLIT_T},
        **{f"b1_share_t{t}": f"{bound[t] / ms[t]:.4f}" for t in SPLIT_T},
        **{f"b1_device_share_t{t}": f"{bound[t] / dev_ms[t]:.4f}"
           for t in SPLIT_T},
        b2_share_t512=f"{bound[hi] / b2_ms:.4f}", card=card)
    say("timing", split=label, us_per_tick=f"{per_tick * 1e3:.4f}",
        ps_per_lane_tick=f"{per_tick * 1e9 / lanes:.4f}",
        per_launch_ms=f"{dev_ms[lo] - lo * per_tick:.4f}",
        producer=fk.PRODUCERS.get(info["producer"], "per-thread loads"),
        **{k: v for k, v in info.items() if k != "producer"},
        note="split from the queued device times")


L_FLUSH = 3 * 2 ** 20          # the SLO fleet's lanes: 2^20 routes x 3
CHAIN_TICKS = 4096


def queued_ms(torch, fn, n, clock_hz, reps=5):
    """(device ms per call, host us per call), ``reps`` times: n calls of
    ``fn`` with the stream held behind a ~30 ms sleep, so the launches
    queue up and run back to back."""
    device_ms, host_us = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.03 * clock_hz))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_us.append((time.perf_counter() - t0) / n * 1e6)
        b.record()
        b.synchronize()
        device_ms.append(a.elapsed_time(b) / n)
    return device_ms, host_us


def b3_batches(torch):
    """{label: (lanes, items, mask, quantile)} on the card: one round of
    K_ROUND distinct Zipf(1.2) lanes at L_LARGE (q90), and one SLO-sized
    flush at L_FLUSH: 4096 observations on Zipf(1.2) routes of 10^6 and a
    uniform metric, stably sorted by lane (the SLOFleet's runs), with the
    fleet's per-lane targets."""
    import numpy as np
    from repro_torch.serve import DEFAULT_METRICS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lanes, items = zipf_rounds(torch, L_LARGE, 1, gen)[0]
    ones = torch.ones(K_ROUND, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    flush = ((rng.zipf(ZIPF_A, SLO_EVENTS) - 1) % SLO_ROUTES * 3
             + rng.integers(0, 3, SLO_EVENTS))      # lane ids
    order = np.argsort(flush, kind="stable")
    vals = rng.lognormal(3.0, 1.0, SLO_EVENTS).astype(np.float32)[order]
    q_slo = torch.tensor([q for _, q in DEFAULT_METRICS],
                         device=dev).repeat(L_FLUSH // 3)
    return {
        "round": (lanes, items, ones, torch.full((L_LARGE,), 0.9,
                                                 device=dev)),
        "flush": (torch.from_numpy(flush[order].astype(np.int32)).to(dev),
                  torch.from_numpy(vals).to(dev),
                  torch.ones(SLO_EVENTS, dtype=torch.int32, device=dev),
                  q_slo)}


def phase_scatter_timing(torch, gm, launches):
    """B3 timed twice: one round of K_ROUND distinct lanes at L_LARGE (the
    per-round path, runs of length 1) and one SLO-sized flush at L_FLUSH
    (runs of one lane's events, the SLOFleet's path), each held against
    the plain version first. The serial-chain floor of a batch is its
    longest run times one tick's dependent latency, measured as one run
    of CHAIN_TICKS events on one lane (one thread) divided by CHAIN_TICKS.
    ``launches`` is (per-round fleets', SLO fleet's) from phase 6."""
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.roofline import kernel_model as km

    dev = torch.device("cuda")
    prog = program_mod.make_program("2u")
    sm_clocks_per_s, clock_hz = card_sm_clocks_per_s(torch)
    hw = card_hw(torch)

    def fresh(n_lanes):
        return (torch.zeros(n_lanes, device=dev),
                torch.ones(n_lanes, device=dev),
                torch.ones(n_lanes, device=dev),
                torch.zeros(n_lanes, dtype=torch.int32, device=dev))

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    chain_items = torch.empty(CHAIN_TICKS, device=dev).log_normal_(
        3.0, 1.0, generator=gen)
    chain_lanes = torch.zeros(CHAIN_TICKS, dtype=torch.int32, device=dev)
    st = fresh(1)
    chain_q = torch.full((1,), 0.9, device=dev)
    tick_ms = {}
    for masked in (False, True):
        mask = torch.ones(CHAIN_TICKS, dtype=torch.int32, device=dev) \
            if masked else None
        chain_ms, _ = queued_ms(torch, lambda: fk.frugal_program_scatter(
            prog, chain_lanes, chain_items, mask, st[:3], st[3], chain_q, 0),
            20, clock_hz)
        tick_ms[masked] = statistics.median(chain_ms) / CHAIN_TICKS
        say("timing", kernel="B3", serial_chain_run=CHAIN_TICKS,
            mask="given" if masked else "None",
            device_ms_per_launch=",".join(f"{v:.5f}" for v in chain_ms),
            tick_latency_us=f"{tick_ms[masked] * 1e3:.5f}",
            note="one lane, one thread: the dependent latency of a tick")

    entries = []
    for (label, (lanes, items, mask, q)), n_launches in zip(
            b3_batches(torch).items(), launches):
        n_lanes = q.numel()
        runs = gm.run_lengths(lanes.cpu().numpy())
        longest = int(runs.max())
        kp, rp = fresh(n_lanes), fresh(n_lanes)
        fk.frugal_program_scatter(prog, lanes, items, mask, kp[:3], kp[3],
                                  q, 0)
        fk.frugal_program_scatter_reference(prog, lanes, items, mask,
                                            rp[:3], rp[3], q, 0)
        torch.cuda.synchronize()
        if not same_bits(torch, kp, rp):
            fail(f"B3 timing ({label}): the kernel differs from the plain "
                 "version")
        err = max_abs_err(kp[:3], rp[:3])
        device_ms, host_us = queued_ms(
            torch, lambda: fk.frugal_program_scatter(
                prog, lanes, items, mask, kp[:3], kp[3], q, 0),
            200, clock_hz)
        plain_ms = event_ms(
            torch, lambda: fk.frugal_program_scatter_reference(
                prog, lanes, items, mask, rp[:3], rp[3], q, 0), 3)[1:]
        k = lanes.numel()
        per_slot = lanes.element_size() + items.element_size() \
            + mask.element_size()
        per_run = q.element_size() + 2 * sum(x.element_size() for x in kp)
        nbytes = k * per_slot + len(runs) * per_run
        bytes_ms = nbytes / hw.hbm_bw * 1e3
        ops_ms, ops_binding = km.operation_bound_ms(
            ((km.OPS_2U_LANE_TICK, k), (km.OPS_TICK, k), (km.OPS_CLOCK, k)),
            sm_clocks_per_s)
        ms = statistics.median(device_ms)
        floor_ms = longest * tick_ms[mask is not None]
        say("timing", kernel="B3", batch=label, lanes=n_lanes, events=k,
            runs=len(runs), longest_run=longest,
            device_ms_per_launch=",".join(f"{v:.5f}" for v in device_ms),
            host_us_per_call=",".join(f"{v:.2f}" for v in host_us),
            plain_ms=",".join(f"{v:.4f}" for v in plain_ms))
        say("timing", kernel="B3", batch=label, bytes=nbytes,
            bytes_per_slot=per_slot, bytes_per_run=per_run,
            bytes_ms=f"{bytes_ms:.4e}", operations_ms=f"{ops_ms:.4e}",
            operations_bound_by=ops_binding,
            bound_share=f"{max(bytes_ms, ops_ms) / ms:.4e}",
            serial_chain_floor_ms=f"{floor_ms:.5f}",
            serial_chain_share=f"{floor_ms / ms:.4f}")
        name = {"round": f"frugal_program_scatter[round: {k} distinct "
                         f"lanes, L={n_lanes}]",
                "flush": f"frugal_program_scatter[SLO flush: {k} events in "
                         f"{len(runs)} runs, L={n_lanes}]"}[label]
        entries.append(kernel_entry(name, SCATTER_SOURCE, TPU_KERNEL_B3,
                                    n_launches, err, ms,
                                    statistics.median(plain_ms), bytes_ms,
                                    ops_ms))
    return entries


# --------------------------------------------------------------- phase 8
RES_KILL_SEED, RES_FLIP_SEED, RES_CHUNK_SEED = 12, 8, 1000
RES_SLO_FLUSHES = 6        # 1, check_health, 1 pending, checkpoint, 4


def same_state(torch, a, b, skip_lane=None) -> bool:
    """Two fleets hold the same planes (int32 views) and cursor; with
    ``skip_lane``, every lane but that one."""
    if tuple(a.cursor) != tuple(b.cursor):
        return False
    for x, y in zip(a.state.planes(), b.state.planes()):
        diff = x.view(torch.int32) != y.view(torch.int32)
        if skip_lane is not None:
            diff[skip_lane] = False
        if bool(diff.any()):
            return False
    return True


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def timed(torch, fn):
    """(result, host ms) of ``fn`` between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_resilience(torch, gm, card):
    """Phase 8; returns (dense launches, run kernel launches) of the
    phase."""
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet, StreamCursor
    from repro_torch.core.program import make_program
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.resilience import Fault, FaultPlan, chaos
    from repro_torch.serve import DEFAULT_METRICS, SLOFleet
    from repro_torch.train import checkpoint as ckpt

    dev = torch.device("cuda")
    q = len(QS)
    spec = FleetSpec(num_groups=G_FULL, quantiles=QS, program="2u",
                     chunk_t=CHUNK_T, health="quarantine")
    gen = torch.Generator(device=dev)
    gen.manual_seed(RES_CHUNK_SEED - 1)
    scale = torch.exp(torch.empty(G_FULL, device=dev).uniform_(
        3.0, 8.0, generator=gen))

    def chunk(i):
        """Chunk i of the stream, made again identically on every call."""
        g = torch.Generator(device=dev)
        g.manual_seed(RES_CHUNK_SEED + i)
        return torch.empty((CHUNK_T, G_FULL), device=dev).log_normal_(
            0.0, 1.0, generator=g).mul_(scale)

    def stream(lo, hi):
        return (chunk(i) for i in range(lo, hi))

    def create():
        return QuantileFleet.create(spec, seed=0)

    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.synchronize()
    fk.launch_count = fk.scatter_launch_count = 0
    try:
        ref4 = create().ingest_stream(stream(0, 4))
        ref = ref4.ingest_stream(stream(4, N_CHUNKS))

        # (a) a seeded kill, resumed from err.fleet with skip_items.
        plan = FaultPlan.seeded_kill(RES_KILL_SEED, N_CHUNKS)
        kill_at = plan.faults[0].at
        try:
            with chaos.armed(plan):
                create().ingest_stream(stream(0, N_CHUNKS))
            fail("resilience (a): the armed kill did not fire")
        except chaos.StreamInterrupted as err:
            interrupted = err
        if interrupted.items_applied != kill_at * CHUNK_T \
                or interrupted.fleet.cursor.t_offset != kill_at * CHUNK_T:
            fail(f"resilience (a): killed after "
                 f"{interrupted.items_applied} items, expected "
                 f"{kill_at * CHUNK_T}")
        resumed = interrupted.fleet.ingest_stream(
            stream(0, N_CHUNKS), skip_items=interrupted.items_applied)
        if not same_state(torch, resumed, ref):
            fail("resilience (a): the resumed fleet differs from the "
                 "uninterrupted run")
        say("resilience", check="a", kill_plan_seed=RES_KILL_SEED,
            killed_after_chunks=kill_at,
            items_applied=interrupted.items_applied,
            result="resumed bit-identical to the uninterrupted run")

        # (b) a sign-plane bit flip in chunk 4, caught and healed.
        rng = np.random.default_rng(RES_FLIP_SEED)
        lane = int(rng.integers(0, spec.num_lanes))
        at = 3 * CHUNK_T + int(rng.integers(0, CHUNK_T))
        plan = FaultPlan(faults=[Fault(kind="flip", at=at, plane=2,
                                       lane=lane, bit=22)])
        with chaos.armed(plan):
            flipped = create().ingest_stream(stream(0, 4))
        if plan.fired() != 1:
            fail(f"resilience (b): {plan.fired()} flips fired, expected 1")
        scans = []
        for _ in range(3):
            rep, ms = timed(torch, flipped.health)
            scans.append(ms)
        if rep.lane_ids != (lane,):
            fail(f"resilience (b): health() flagged {rep.lane_ids[:8]} "
                 f"({rep.corrupt_lanes} lanes), expected ({lane},)")
        (healed, rep), check_ms = timed(torch, flipped.check_health)
        if rep.quarantined != 1 or not healed.health().healthy:
            fail(f"resilience (b): check_health() quarantined "
                 f"{rep.quarantined} lane(s); {healed.health()}")
        healed = healed.ingest_stream(stream(4, N_CHUNKS))
        if not same_state(torch, healed, ref, skip_lane=lane):
            fail("resilience (b): a lane other than the healed one differs "
                 "from the uninterrupted run")
        group, qi = divmod(lane, q)
        fresh = QuantileFleet.create(
            FleetSpec(num_groups=1, quantiles=QS, program="2u",
                      chunk_t=CHUNK_T),
            cursor=StreamCursor.create(seed=0, t_offset=4 * CHUNK_T,
                                       g_offset=group * q))
        fresh = fresh.ingest_stream(
            chunk(i)[:, group:group + 1].contiguous()
            for i in range(4, N_CHUNKS))
        for f, a, b in zip(spec.program.layout.plane_fields,
                           healed.state.planes(), fresh.state.planes()):
            if not torch.equal(a[lane].view(torch.int32),
                               b[qi].view(torch.int32)):
                fail(f"resilience (b): healed lane {lane} plane {f} "
                     "differs from a lane created at its cursor")
        say("resilience", check="b", lanes=spec.num_lanes, flipped_lane=lane,
            flip_tick=at, plane="sign", bit=22, flagged=len(rep.lane_ids),
            quarantined=rep.quarantined,
            result=f"healed lane = a lane created at tick {4 * CHUNK_T}; "
                   "every other lane bit-identical to the uninterrupted run")
        say("resilience", health_scan_ms=",".join(f"{v:.3f}" for v in scans),
            check_health_ms=f"{check_ms:.3f}", lanes=spec.num_lanes,
            card=card, note="host clock between synchronizations")

        # (c) a format-4 checkpoint after 4 chunks, restored on the card.
        ckdir = Path(work) / "dense"
        _, save_ms = timed(torch, lambda: ref4.checkpoint(str(ckdir), step=4))
        restored, restore_ms = timed(
            torch, lambda: QuantileFleet.restore(str(ckdir), spec))
        manifest = ckpt.read_manifest(str(ckdir))
        if restored.device.type != "cuda" or manifest["format"] != 4:
            fail(f"resilience (c): restored on {restored.device}, format "
                 f"{manifest['format']}")
        if not same_state(torch, restored, ref4):
            fail("resilience (c): the restored fleet differs from the "
                 "saved one")
        if not same_state(torch, restored.ingest_stream(
                stream(4, N_CHUNKS)), ref):
            fail("resilience (c): the restored fleet continued differs "
                 "from the uninterrupted run")
        say("resilience", check="c", step=4, leaves=manifest["num_leaves"],
            shapes=manifest["shapes"], dtypes=",".join(manifest["dtypes"]),
            result="restored and continued bit-identical to the "
                   "uninterrupted run")
        say("resilience", checkpoint_save_ms=f"{save_ms:.1f}",
            restore_ms=f"{restore_ms:.1f}", bytes_on_disk=dir_bytes(ckdir),
            lanes=spec.num_lanes, card=card,
            note="save: D2H + pack + npz + fsync + CRC32; restore: read + "
                 "CRC32 + H2D + unpack; host clock")
        del ref4, resumed, flipped, healed, restored, interrupted

        # (d) the JAX package's committed checkpoints on the card.
        data = np.load(GOLDEN)
        for family, kw in gm.CKPT_PROGRAMS.items():
            copy = shutil.copytree(Path(gm.CKPT_ROOT) / family,
                                   Path(work) / ("jax-" + family))
            gspec = FleetSpec(num_groups=gm.CKPT_G, quantiles=gm.QUANTILES,
                              chunk_t=gm.CKPT_CHUNK_T,
                              program=make_program(family, **kw))
            fleet = QuantileFleet.restore(str(copy), gspec).ingest(
                gm.ckpt_items(family, 1))
            packed = fleet.state.packed()
            for name in packed._fields:
                x = getattr(packed, name)
                if x is not None and not np.array_equal(
                        x.cpu().numpy().view(np.int32),
                        data[f"ckpt/{family}/{name}"].view(np.int32)):
                    fail(f"resilience (d): {family} {name} differs from "
                         "the JAX package's continuation")
            if list(fleet.cursor) != data[f"ckpt/{family}/cursor"].tolist():
                fail(f"resilience (d): {family} cursor {fleet.cursor}")
        metrics = [m for m, _ in DEFAULT_METRICS]
        copy = shutil.copytree(Path(gm.CKPT_ROOT) / "slo",
                               Path(work) / "jax-slo")
        st, _ = ckpt.restore_checkpoint(
            str(copy), SLOFleet(capacity=1).checkpoint_template())
        slo = SLOFleet.from_checkpoint_state(st)
        gm.feed_slo(slo, metrics, gm.slo_continuation(data))
        for name in ("m", "step", "sign", "ticks"):
            if not np.array_equal(
                    getattr(slo, "_" + name).cpu().numpy().view(np.int32),
                    data[f"ckpt/slo/{name}"].view(np.int32)):
                fail(f"resilience (d): SLO {name} differs from the JAX "
                     "package's continuation")
        say("resilience", check="d",
            checkpoints=",".join(list(gm.CKPT_PROGRAMS) + ["slo"]),
            result="JAX-written checkpoints restored on the card and "
                   "continued bit-identical to the JAX package")

        # (e) the SLO fleet at 10^6 routes through a checkpoint.
        rng = np.random.default_rng(5)
        names = [f"route-{i}" for i in range(SLO_ROUTES)]
        batches = [((rng.zipf(ZIPF_A, SLO_EVENTS) - 1) % SLO_ROUTES,
                    rng.integers(0, len(metrics), SLO_EVENTS),
                    rng.lognormal(3.0, 1.0, SLO_EVENTS))
                   for _ in range(RES_SLO_FLUSHES)]

        def observe(fleet, batch):
            for ri, mi, vi in zip(*(x.tolist() for x in batch)):
                fleet.observe(names[ri], metrics[mi], vi)

        whole, cut = SLOFleet(seed=0, capacity=64), \
            SLOFleet(seed=0, capacity=64)
        for fl in (whole, cut):
            fl.ensure_routes(names)
        for batch in batches:
            observe(whole, batch)
            whole.flush()
        observe(cut, batches[0])
        cut.flush()
        rep = cut.check_health()
        observe(cut, batches[1])            # pending at the checkpoint
        slo_dir = Path(work) / "slo"
        _, slo_save_ms = timed(torch, lambda: ckpt.save_checkpoint(
            str(slo_dir), 1, cut.checkpoint_state()))
        template = cut.checkpoint_template()
        del cut
        cut, slo_restore_ms = timed(
            torch, lambda: SLOFleet.from_checkpoint_state(
                ckpt.restore_checkpoint(str(slo_dir), template)[0]))
        for batch in batches[2:]:
            observe(cut, batch)
            cut.flush()
        if not rep.healthy or cut.routes() != whole.routes():
            fail(f"resilience (e): {rep}; routes differ")
        for name in ("_m", "_step", "_sign", "_ticks"):
            if not torch.equal(getattr(cut, name), getattr(whole, name)):
                fail(f"resilience (e): SLO {name} differs from the "
                     "uninterrupted fleet")
        say("resilience", check="e", routes=SLO_ROUTES,
            lanes=whole._cap_routes * len(metrics), flushes=len(batches),
            events_per_flush=SLO_EVENTS, health=str(rep),
            result="restored and flushed 4 more times bit-identical to "
                   "the uninterrupted fleet")
        say("resilience", slo_checkpoint_save_ms=f"{slo_save_ms:.1f}",
            slo_restore_ms=f"{slo_restore_ms:.1f}",
            slo_bytes_on_disk=dir_bytes(slo_dir), card=card,
            note="save includes the pending flush and the route table's "
                 "JSON; host clock")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = (fk.launch_count, fk.scatter_launch_count)
    if min(launches) == 0:
        fail(f"resilience: the phase launched the dense / run kernels "
             f"{launches} times")
    say("resilience", dense_kernel_launches=launches[0],
        run_kernel_launches=launches[1])
    return launches


# --------------------------------------------------------------- phase 9
SVC_G, SVC_CHUNK_T, SVC_CHUNKS = 2 ** 20, 64, 24
QUERY_DUTY, E14_GATE = 9.0, 0.85          # e14's reader pacing and gate
SVC_STALL_SEED, SVC_STALL_QUERIES = 3, 4
SLO_SNAP_FLUSHES, SLO_SNAP_HOT = 3, 16
CORPUS_BATCHES = 64
SVC_JOIN_S = 600.0


def pct(xs, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


def same_answer(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def service_run(torch, spec, chunks, gm, depth, reader=None):
    """One StreamingService run over ``chunks`` on the card with put-ahead
    ``depth``: the service's pipeline stages through a DeviceStager that
    logs its pin times and copy events; ``reader(svc, tel, stop)`` (if
    given) runs on a thread of its own while ingest runs. The dense
    kernel's count is set to 0 just before the run and read after the
    telemetry's latency read (its flush is a launch too)."""
    import threading

    from repro_torch.data.pipeline import DeviceStager
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.service import (IngestPipeline, StreamingService,
                                     Telemetry, TenantPolicy)

    class Recording(Telemetry):
        """Telemetry that also keeps every raw latency and each gauge's
        peak."""

        def __init__(self):
            super().__init__()
            self.raw = {"ingest_chunk_ms": [], "query_ms": []}
            self.peaks = {}
            self._peak_lock = threading.Lock()

        def observe_ms(self, metric, ms):
            super().observe_ms(metric, ms)
            self.raw[metric].append(float(ms))

        def gauge(self, name, value):
            super().gauge(name, value)
            with self._peak_lock:
                self.peaks[name] = max(self.peaks.get(name, value), value)

    dev = torch.device("cuda")
    tel = Recording()
    svc = StreamingService(spec, seed=gm.SERVICE_SEED, telemetry=tel,
                           prefetch_depth=depth, tenants=[TenantPolicy(
                               "partner", epsilon=gm.SERVICE_EPSILON)])
    if svc.fleet.device.type != dev.type:
        fail(f"service: the fleet was created on {svc.fleet.device}")
    log = []
    svc.pipeline = IngestPipeline(depth=depth, telemetry=tel,
                                  transfer=DeviceStager(dev, log=log))
    stop, errors = threading.Event(), []

    def guarded():
        try:
            reader(svc, tel, stop)
        except BaseException as e:  # noqa: BLE001 — reported by fail()
            errors.append(e)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = 0
    staged = dict(fk.producer_launch_count)
    t0 = time.perf_counter()
    svc.start(iter(chunks))
    rt = None
    if reader is not None:
        rt = threading.Thread(target=guarded, name="service-reader",
                              daemon=True)
        rt.start()
    svc.join(timeout=SVC_JOIN_S)
    wall = time.perf_counter() - t0
    if rt is not None:
        stop.set()
        rt.join(timeout=60.0)
        if rt.is_alive():
            fail("service: the reader thread did not stop")
    torch.cuda.synchronize()
    lat = tel.latency_quantiles()
    launches = fk.launch_count
    if errors:
        fail(f"service: the reader failed: {errors[0]!r}")
    return {"svc": svc, "tel": tel, "log": log, "wall": wall, "lat": lat,
            "peak": torch.cuda.max_memory_allocated(), "launches": launches,
            "producers": producers_since(fk, staged)}


def say_run(label, run, chunk_bytes, card):
    pin = [p for p, _, _ in run["log"]]
    h2d = [a.elapsed_time(b) for _, a, b in run["log"]]
    apply_ms = run["tel"].raw["ingest_chunk_ms"]
    items = len(apply_ms) * chunk_bytes // 4
    say("service", run=label, items_per_s=f"{items / run['wall']:.4e}",
        wall_s=f"{run['wall']:.4f}", chunks=len(apply_ms),
        dense_kernel_launches=run["launches"], producers=run["producers"],
        max_memory_allocated_bytes=run["peak"], card=card)
    say("service", run=label,
        apply_ms_p50=f"{pct(apply_ms, 50):.4f}",
        apply_ms_p99=f"{pct(apply_ms, 99):.4f}",
        pin_ms_p50=f"{pct(pin, 50):.4f}", pin_ms_p99=f"{pct(pin, 99):.4f}",
        h2d_ms_p50=f"{pct(h2d, 50):.4f}", h2d_ms_p99=f"{pct(h2d, 99):.4f}",
        h2d_gb_per_s=f"{chunk_bytes / pct(h2d, 50) / 1e6:.3f}",
        chunks_in_flight_max=run["tel"].peaks.get("chunks_in_flight"),
        note="apply and pin on the host clock; H2D on the side stream "
             "(CUDA events)")


def phase_service(torch, gm, card):
    """Phase 9; returns the kernels-line entry of the dense kernel at the
    service's chunk shape."""
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet
    from repro_torch.core.program import make_program
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.resilience import FaultPlan, QueryStalled, chaos
    from repro_torch.serve import DEFAULT_METRICS, SLOFleet
    from repro_torch.service import (Snapshot, StreamingService, Telemetry,
                                     TenantPolicy)

    dev = torch.device("cuda")
    phase_t0 = time.perf_counter()
    eps = gm.SERVICE_EPSILON
    prog = make_program("2u-decay", half_life=gm.SERVICE_HALF_LIFE)
    spec = FleetSpec(num_groups=SVC_G, quantiles=(0.5,),
                     chunk_t=SVC_CHUNK_T, program=prog)
    chunks, make_ms = [], []
    for k in range(SVC_CHUNKS):
        t0 = time.perf_counter()
        chunks.append(gm.service_chunk(k, SVC_CHUNK_T, SVC_G))
        make_ms.append((time.perf_counter() - t0) * 1e3)
    chunk_bytes = chunks[0].nbytes
    items_total = SVC_CHUNKS * SVC_CHUNK_T * SVC_G
    say("service", groups=SVC_G, quantiles="0.5", program="2u-decay",
        half_life=gm.SERVICE_HALF_LIFE, seed=gm.SERVICE_SEED,
        chunk=f"[{SVC_CHUNK_T},{SVC_G}]", chunks=SVC_CHUNKS,
        items=items_total, chunk_bytes=chunk_bytes,
        host_bytes=chunk_bytes * SVC_CHUNKS, tenant=f"partner eps={eps}")
    say("service", make_chunk_ms=f"{make_ms[0]:.2f}",
        median_make_chunk_ms=f"{statistics.median(make_ms):.2f}",
        note="numpy normal(50, 15) on the host from seed (17, k), before "
             "any timed window")

    # (a) ingest only, put-ahead depth 1; (a0) the same, staged in line;
    # in turns (a, a0, a0, a) after a warm-up run over 4 chunks, whose
    # first pinned blocks are page-locked anew.
    say_run("warm-up depth=1", service_run(torch, spec, chunks[:4], gm, 1),
            chunk_bytes, card)
    runs = {}
    for label, depth in (("a", 1), ("a0", 0), ("a0", 0), ("a", 1)):
        run = service_run(torch, spec, chunks, gm, depth)
        runs.setdefault(label, []).append(run)
        say_run(f"{label} depth={depth} #{len(runs[label])}", run,
                chunk_bytes, card)
    # One more (a) run under the profiler: the device's and the dense
    # kernel's share of the run's wall time.
    traced, names, busy = device_trace(
        torch, lambda: service_run(torch, spec, chunks, gm, 1))
    say_run("a depth=1, traced", traced, chunk_bytes, card)
    say_trace("9a", names, busy, traced["wall"] * 1e3, SVC_CHUNKS, card)
    wall = {k: statistics.mean(r["wall"] for r in v)
            for k, v in runs.items()}
    say("service", a0_over_a=f"{wall['a'] / wall['a0']:.4f}",
        note="items/s of depth 0 over depth 1, mean walls of two runs each")

    # (b) ingest with a reader paced as e14's: it sleeps QUERY_DUTY times
    # its last query's cost, alternating a trusted and a DP read.
    answers, q_ms = {}, {"raw": [], "dp": []}

    def reader(svc, tel, stop):
        dp_turn = False
        while not stop.is_set():
            t0 = time.perf_counter()
            snap = svc.snapshot()
            kind = "dp" if dp_turn else "raw"
            ans = snap.estimate_dp(eps) if dp_turn else snap.estimate()
            dt = time.perf_counter() - t0
            q_ms[kind].append(dt * 1e3)
            tel.observe_ms("query_ms", dt * 1e3)
            tel.count("queries_served")
            slot = answers.setdefault(snap.items_ingested, {})
            if kind in slot and not same_answer(slot[kind], ans):
                raise AssertionError(f"two {kind} answers at cursor "
                                     f"{snap.items_ingested} differ")
            slot.setdefault(kind, ans)
            dp_turn = not dp_turn
            stop.wait(min(2.0, QUERY_DUTY * dt))

    run_b = service_run(torch, spec, chunks, gm, 1, reader)
    final = run_b["svc"].snapshot()
    answers.setdefault(final.items_ingested, {})["raw"] = final.estimate()
    say_run("b depth=1 + reader", run_b, chunk_bytes, card)
    fraction = wall["a"] / run_b["wall"]
    served = run_b["tel"].counters().get("queries_served", 0)
    lat_b = run_b["lat"]
    say("service", run="b", fraction_of_a=f"{fraction:.4f}",
        e14_gate=E14_GATE, e14_gate_met=fraction >= E14_GATE,
        note="the gate is information here: it fails nothing")
    say("service", run="b", queries_served=served,
        trusted_queries=len(q_ms["raw"]), dp_queries=len(q_ms["dp"]),
        trusted_ms_p50=f"{pct(q_ms['raw'], 50):.3f}",
        trusted_ms_p99=f"{pct(q_ms['raw'], 99):.3f}",
        dp_ms_p50=f"{pct(q_ms['dp'], 50):.3f}",
        dp_ms_p99=f"{pct(q_ms['dp'], 99):.3f}", card=card)
    say("service", run="b", **{
        f"telemetry_{m}_{p}": f"{lat_b[m][p]:.4f}"
        for m in ("ingest_chunk_ms", "query_ms") for p in ("p50", "p99")},
        note="the service's own frugal histogram (2u lanes on the card)")
    quiet = {"internal": [], "partner": []}
    for _ in range(8):
        for tenant, got in quiet.items():
            t0 = time.perf_counter()
            run_b["svc"].query(tenant=tenant)
            got.append((time.perf_counter() - t0) * 1e3)
    say("service", run="b, after ingest", queries=8,
        trusted_ms=",".join(f"{v:.3f}" for v in quiet["internal"]),
        dp_ms=",".join(f"{v:.3f}" for v in quiet["partner"]), card=card,
        note="StreamingService.query at the last cursor, no ingest running")

    # (c) audit: every answer of (b) against a single-threaded replay on
    # the card, and that replay against the plain version's.
    replay = QuantileFleet.create(spec, seed=gm.SERVICE_SEED)
    fresh_words = prog.layout.pack_planes(replay.state.planes())
    quantile, seed = replay.state.quantile, replay.cursor.seed
    snaps = {0: Snapshot.capture(replay)}
    for k, c in enumerate(chunks):
        replay = replay.ingest(c)
        snaps[(k + 1) * SVC_CHUNK_T] = Snapshot.capture(replay)
    verified = {"raw": 0, "dp": 0}
    for cursor, got in sorted(answers.items()):
        if cursor not in snaps:
            fail(f"service (c): an answer at cursor {cursor}, not a chunk "
                 "boundary")
        for kind, ans in got.items():
            want = snaps[cursor].estimate() if kind == "raw" \
                else snaps[cursor].estimate_dp(eps)
            if not same_answer(ans, want):
                fail(f"service (c): the {kind} answer at cursor {cursor} "
                     "differs from the replay")
            verified[kind] += 1
    if sum(verified.values()) < 2:
        fail(f"service (c): only {verified} answers verified")
    words = fresh_words
    for k, c in enumerate(chunks):
        words = fk.frugal_program_dense_reference(
            prog, torch.from_numpy(c).to(dev), words, quantile, seed,
            t_offset=k * SVC_CHUNK_T)
    if not same_bits(torch, prog.layout.pack_planes(replay.state.planes()),
                     words):
        fail("service (c): the replay's planes differ from the plain "
             "version's replay")
    main_runs = [(k, r) for k, v in runs.items() for r in v] + [
        ("b", run_b)]
    for label, run in main_runs:
        if not same_state(torch, run["svc"].fleet, replay):
            fail(f"service (c): a run {label}'s final fleet differs from "
                 "the replay")
    say("service", check="c", answers_verified=sum(verified.values()),
        trusted=verified["raw"], dp=verified["dp"],
        cursors=len(answers), result="every answer served in (b) "
        "bit-identical to a single-threaded replay on the card; its last "
        "planes to the plain version's replay; every run ends on them")

    # (d) a seeded query stall under load, retried at once.
    stalls, loaded_ms = [], []

    def stall_reader(svc, tel, stop):
        while not stop.is_set():
            try:
                t0 = time.perf_counter()
                svc.query()
                loaded_ms.append((time.perf_counter() - t0) * 1e3)
            except QueryStalled:
                running = svc.ingest_running
                snap = svc.snapshot()
                stalls.append((snap.items_ingested, snap.estimate(),
                               running))
                return

    plan = FaultPlan.seeded_query_stall(SVC_STALL_SEED, SVC_STALL_QUERIES)
    with chaos.armed(plan):
        run_d = service_run(torch, spec, chunks, gm, 1, stall_reader)
    stalled = run_d["tel"].counters().get("queries_stalled", 0)
    if plan.fired() != 1 or stalled != 1 or len(stalls) != 1:
        fail(f"service (d): {plan.fired()} stalls fired, {stalled} counted,"
             f" {len(stalls)} retried")
    cursor, retried, running = stalls[0]
    if not running:
        fail("service (d): the stall fired after ingest had ended")
    if not same_answer(retried, snaps[cursor].estimate()):
        fail(f"service (d): the retried read at cursor {cursor} differs "
             "from the replay")
    if not same_state(torch, run_d["svc"].fleet,
                      runs["a"][0]["svc"].fleet):
        fail("service (d): the fleet's final state differs from run (a)'s")
    say("service", check="d", stall_plan_seed=SVC_STALL_SEED,
        stalled_at_query=plan.faults[0].at, retried_at_cursor=cursor,
        ingest_running=running, queries_stalled=stalled,
        trusted_ms_before=",".join(f"{v:.3f}" for v in loaded_ms),
        dense_kernel_launches=run_d["launches"],
        result="ingest unperturbed (final state = run a's); the retried "
               "read = the replay at its cursor")

    # (e) the JAX package's service and telemetry at small size.
    data = np.load(GOLDEN)
    small = [gm.service_chunk(k) for k in range(gm.SERVICE_CHUNKS)]
    crcs = [gm.chunk_crc32(c) for c in small]
    if crcs != data["service/chunk_crc32"].tolist():
        fail("service (e): numpy here draws other chunks from the golden "
             f"seeds (CRC32 {crcs} != {data['service/chunk_crc32']})")
    gsvc = StreamingService(
        FleetSpec(num_groups=gm.SERVICE_G, quantiles=(0.5,),
                  chunk_t=gm.SERVICE_CHUNK_T, program=prog),
        seed=gm.SERVICE_SEED,
        tenants=[TenantPolicy("partner", epsilon=eps)])
    for k in range(gm.SERVICE_CHUNKS + 1):
        if not same_answer(gsvc.query(), data["service/raw"][k]) or \
                not same_answer(gsvc.query(tenant="partner"),
                                data["service/dp"][k]):
            fail(f"service (e): the answers at boundary {k} differ from "
                 "the JAX service's")
        if k < gm.SERVICE_CHUNKS:
            gsvc.ingest(small[k])
    tel = Telemetry(seed=gm.TELEMETRY_SEED)
    if not same_answer(gm.feed_telemetry(tel), data["telemetry/latency"]):
        fail("service (e): the telemetry quantiles differ from the JAX "
             "package's")
    tel.flush()
    for f in ("m", "step", "sign"):
        if not same_answer(getattr(tel._fleet.state, f).cpu().numpy(),
                           data[f"telemetry/{f}"]):
            fail(f"service (e): the telemetry lanes' {f} differs")
    if list(tel._fleet.cursor) != data["telemetry/cursor"].tolist():
        fail(f"service (e): telemetry cursor {tel._fleet.cursor}")
    say("service", check="e", groups=gm.SERVICE_G,
        boundaries=gm.SERVICE_CHUNKS + 1, telemetry_observations=len(
            gm.telemetry_observations()),
        result="trusted and DP answers at every boundary and the "
               "telemetry histogram bit-identical to the JAX package's")

    # (f) SLOFleet.snapshot() at phase 6's size, with events pending.
    metrics = [m for m, _ in DEFAULT_METRICS]
    rng = np.random.default_rng(9)
    names = [f"route-{i}" for i in range(SLO_ROUTES)]
    batches = [((rng.zipf(ZIPF_A, SLO_EVENTS) - 1) % SLO_ROUTES,
                rng.integers(0, len(metrics), SLO_EVENTS),
                rng.lognormal(3.0, 1.0, SLO_EVENTS))
               for _ in range(2 + SLO_SNAP_FLUSHES)]

    def observe(fleet, batch):
        for ri, mi, vi in zip(*(x.tolist() for x in batch)):
            fleet.observe(names[ri], metrics[mi], vi)

    slo = SLOFleet(seed=0, capacity=64)
    slo.ensure_routes(names)
    fk.scatter_launch_count = 0
    observe(slo, batches[0])
    slo.flush()
    observe(slo, batches[1])                    # pending at the snapshot
    snap, snap_ms = timed(torch, slo.snapshot)
    capture_ms = [timed(torch, slo.snapshot)[1]  # nothing pending
                  for _ in range(5)]
    copied = sum(p.nbytes for p in snap.m_planes) + snap.t_next.nbytes
    est = snap.estimate()
    if not same_answer(est.reshape(-1), slo._m.cpu().numpy()):
        fail("service (f): the snapshot differs from the fleet's estimates")
    counts = np.bincount(np.concatenate([r for r, _, _ in batches[:2]]),
                         minlength=SLO_ROUTES)
    for ri in np.argsort(-counts, kind="stable")[:SLO_SNAP_HOT]:
        for mi, metric in enumerate(metrics):
            got = np.float32(slo.estimate(names[ri], metric))
            if got.view(np.int32) != est[ri, mi].view(np.int32):
                fail(f"service (f): estimate({names[ri]}, {metric}) != the "
                     "snapshot's")
    before = est.copy()
    for batch in batches[2:]:
        observe(slo, batch)
        slo.flush()
    if not same_answer(snap.estimate(), before):
        fail("service (f): donated flushes changed a taken snapshot")
    if same_answer(slo._m.cpu().numpy(), before.reshape(-1)):
        fail("service (f): the flushes after the snapshot moved no lane")
    slo_launches = fk.scatter_launch_count
    say("service", check="f", routes=SLO_ROUTES,
        lanes=slo._cap_routes * len(metrics), pending_events=SLO_EVENTS,
        snapshot_ms=f"{snap_ms:.3f}",
        capture_ms=",".join(f"{v:.3f}" for v in capture_ms),
        bytes_copied=copied, flushes_after=SLO_SNAP_FLUSHES,
        run_kernel_launches=slo_launches, card=card,
        result="snapshot = SLOFleet.estimate right after; unchanged by 3 "
               "donated flushes")

    # (g) the token corpus staged on the card.
    corpus = SyntheticCorpus(DataConfig())
    stream = corpus.iterate(prefetch=1)
    try:
        for step in range(CORPUS_BATCHES):
            got, want = next(stream), corpus.batch(step)
            for key in ("tokens", "targets"):
                x = got[key]
                if x.device.type != dev.type or x.dtype != torch.int32 or \
                        not np.array_equal(x.cpu().numpy(), want[key]):
                    fail(f"service (g): batch {step} {key} differs from "
                         "the numpy batch")
    finally:
        stream.close()
    say("service", check="g", batches=CORPUS_BATCHES,
        result="SyntheticCorpus(DataConfig()).iterate(prefetch=1) on the "
               "card bit-identical to the numpy batches")

    # The dense kernel at the service's chunk shape, against its plain
    # version and its bound.
    items = torch.from_numpy(chunks[0]).to(dev)
    words = tuple(w.contiguous() for w in fresh_words)
    res = {}

    def kernel():
        res["kernel"] = fk.frugal_program_dense(prog, items, words, quantile,
                                                seed)

    def plain():
        res["plain"] = fk.frugal_program_dense_reference(
            prog, items, words, quantile, seed)

    kernel_ms = event_ms(torch, kernel, 11)[1:]
    _, clock_hz = card_sm_clocks_per_s(torch)
    device_ms, host_us = queued_ms(torch, kernel, SPLIT_QUEUED, clock_hz)
    plain_ms = event_ms(torch, plain, 3)[1:]
    err = max_abs_err(prog.layout.unpack_words(res["kernel"]),
                      prog.layout.unpack_words(res["plain"]))
    if not same_bits(torch, res["kernel"], res["plain"]):
        fail(f"service chunk: the kernel differs from the plain version "
             f"(max abs err {err})")
    pred = dense_bound(torch, prog, SVC_G, SVC_CHUNK_T, 1)
    nbytes = int(pred["bytes_total"])
    bytes_ms = pred["bandwidth_s"] * 1e3
    ops_ms, ops_binding = pred["operations_s"] * 1e3, \
        pred["operations_bound_by"]
    ms = statistics.median(kernel_ms)
    bound = max(bytes_ms, ops_ms)
    say("service", kernel="B1", chunk=f"[{SVC_CHUNK_T},{SVC_G}]",
        program="2u-decay",
        kernel_ms=",".join(f"{v:.4f}" for v in kernel_ms),
        device_ms_queued=",".join(f"{v:.4f}" for v in device_ms),
        host_us_per_call=",".join(f"{v:.2f}" for v in host_us),
        plain_ms=",".join(f"{v:.2f}" for v in plain_ms), bytes=nbytes,
        bytes_ms=f"{bytes_ms:.4f}", operations_ms=f"{ops_ms:.4f}",
        operations_bound_by=ops_binding,
        bound_share=f"{bound / ms:.4f}",
        device_bound_share=f"{bound / statistics.median(device_ms):.4f}",
        card=card)
    launches = sum(run["launches"] for _, run in main_runs)
    say("service", dense_kernel_launches=launches, per_run=",".join(
        f"{label}={run['launches']}" for label, run in main_runs),
        stall_run=run_d["launches"], run_kernel_launches=slo_launches,
        note="the main path's runs (a, a0, a0, a, b): one per chunk and "
             "one per telemetry flush")
    say("service", phase_s=f"{time.perf_counter() - phase_t0:.1f}",
        making_chunks_s=f"{sum(make_ms) / 1e3:.1f}")
    if min(run["launches"] for _, run in main_runs) < SVC_CHUNKS \
            or slo_launches == 0:
        fail("service: the main path did not go through the kernels")
    return kernel_entry(
        f"frugal_program_dense[service chunk: [{SVC_CHUNK_T}, {SVC_G}] "
        "2u-decay]", KERNEL_SOURCE, TPU_KERNEL, launches, err, ms,
        statistics.median(plain_ms), bytes_ms, ops_ms)


# -------------------------------------------------------------- phase 10
EVAL_REPS = 3          # timed ingests of each fleet on the stream

def eval_fleet(torch, gm, name, items, dev_items, algo, q, key, data,
               sorted_streams, card):
    """One (workload, algo, q) fleet of phase 10; returns (B1 launches of
    its main run, its producer, the fraction of streams within 0.1, and
    (tag, fleet, a function that runs the plain version of the fleet on
    the card) for the comparison after every timed part)."""
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet
    from repro_torch.core.reference import relative_mass_error
    from repro_torch.kernels import frugal_update as fk

    t_len, g = items.shape
    spec = FleetSpec(num_groups=g, quantiles=(q,), algo=algo,
                     chunk_t=gm.EVAL_CHUNK_T)
    # The main run, as the benchmark runs it: numpy items in, estimates
    # out (host clock, so the copy to the card is in it).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = 0
    staged = dict(fk.producer_launch_count)
    t0 = time.perf_counter()
    fleet = QuantileFleet.create(spec, key=key).ingest(items)
    est = fleet.estimate(q)
    main_s = time.perf_counter() - t0
    launches = fk.launch_count
    producers = {k: v - staged[k] for k, v in fk.producer_launch_count.items()}
    peak = torch.cuda.max_memory_allocated()
    want_launches = -(-t_len // gm.EVAL_CHUNK_T)
    producer = "tma" if g % 4 == 0 else "cp.async"
    tag = f"{name} {algo} q{q}"
    if launches != want_launches or producers[producer] != launches:
        fail(f"eval {tag}: {launches} launches ({producers}), expected "
             f"{want_launches} by {producer}")
    golden = data[gm.eval_key(name, algo, q)]
    if not same_answer(est, golden):
        fail(f"eval {tag}: the estimates differ from the JAX package's")

    # On the stream: the ingest of items already on the card, and B1's
    # launches alone over the same chunks (CUDA events).
    def ingest():
        return QuantileFleet.create(spec, key=key).ingest(dev_items)

    ingest_ms = event_ms(torch, ingest, EVAL_REPS + 1)[1:]
    prog = spec.program
    quantile = torch.full((g,), q, device=dev_items.device)
    words0 = tuple(w.contiguous() for w in prog.layout.pack_planes(
        QuantileFleet.create(spec, key=key).state.planes()))
    res = {}

    # B1 at the tuner's block size, as the fleet launches it.
    block_g = tuned_block_g(torch, prog, g, gm.EVAL_CHUNK_T, 1)

    def kernel():
        w = words0
        for r0 in range(0, t_len, gm.EVAL_CHUNK_T):
            w = fk.frugal_program_dense(
                prog, dev_items[r0:r0 + gm.EVAL_CHUNK_T], w, quantile,
                fleet.cursor.seed, t_offset=r0, block_g=block_g)
        res["w"] = w

    kernel_ms = event_ms(torch, kernel, EVAL_REPS + 1)[1:]
    if not same_bits(torch, prog.layout.unpack_words(res["w"]),
                     fleet.state.planes()):
        fail(f"eval {tag}: B1's launches alone differ from the fleet's")
    real = int(np.isfinite(items).sum())
    pred = dense_bound(torch, prog, g, t_len, 1, real_items=real)
    bytes_ms = pred["bandwidth_s"] * 1e3
    ops_ms, ops_binding = pred["operations_s"] * 1e3, \
        pred["operations_bound_by"]
    bound = max(bytes_ms, ops_ms)
    errs = [relative_mass_error(float(e), s, q)
            for e, s in zip(est, sorted_streams)]
    frac = float(np.mean([abs(e) <= 0.1 for e in errs]))
    ms, kms = statistics.median(ingest_ms), statistics.median(kernel_ms)
    say("eval", workload=name, algo=algo, q=q, groups=g, ticks=t_len,
        real_items=real, b1_launches=launches, producer=producer,
        frac_within_0_1=f"{frac:.4f}",
        estimates="bit-identical to the JAX package's")
    say("eval", workload=name, algo=algo, q=q,
        ingest_ms=",".join(f"{v:.4f}" for v in ingest_ms),
        b1_ms=",".join(f"{v:.4f}" for v in kernel_ms), b1_block_g=block_g,
        items_per_s=f"{real / ms * 1e3:.4e}", main_run_s=f"{main_s:.4f}",
        bound_ms=f"{bound:.6f}", bound_by="bytes" if bytes_ms >= ops_ms
        else f"operations ({ops_binding})",
        b1_bound_share=f"{bound / kms:.5f}",
        max_memory_allocated_bytes=peak, card=card)

    def plain():
        return QuantileFleet.create(dataclasses.replace(spec, backend="jnp"),
                                    key=key).ingest(dev_items)

    return launches, producer, frac, (tag, fleet, plain)


def phase_eval(torch, gm, card):
    """Phase 10; returns B1's launches in the phase's main runs and
    {workload: its item block on the card} (for phase 12)."""
    import numpy as np
    from repro_torch.api import FrugalEstimator
    from repro_torch.core import baselines
    from repro_torch.core.reference import relative_mass_error
    from repro_torch.data import streams
    from repro_torch.kernels import frugal_update as fk

    phase_t0 = time.perf_counter()
    data = np.load(GOLDEN)
    key = data["eval/key_words"]
    launches, fracs, seen, size, checks = 0, {}, {}, None, []
    blocks = {}
    for name in gm.EVAL_DATASETS:
        t0 = time.perf_counter()
        ss = gm.eval_streams(streams, name)
        items = streams.pad_ragged(ss)
        make_s = time.perf_counter() - t0
        crc = gm.chunk_crc32(items)
        if crc != int(data[f"eval/{name}/items_crc32"]) or \
                list(items.shape) != data[f"eval/{name}/shape"].tolist():
            fail(f"eval: numpy {np.__version__} here draws other {name} "
                 f"streams than the golden file's (shape {items.shape}, "
                 f"CRC32 {crc})")
        say("eval", workload=name, streams=len(ss), padded=list(items.shape),
            crc32=crc, crc32_golden="match", making_streams_s=f"{make_s:.2f}")
        if name == "e3_size":
            size = ss
        sorted_ss = [sorted(s.tolist()) for s in ss]
        dev_items = blocks[name] = torch.from_numpy(items).cuda()
        for algo in gm.EVAL_ALGOS:
            for q in gm.EVAL_QS:
                n, producer, frac, check = eval_fleet(
                    torch, gm, name, items, dev_items, algo, q, key, data,
                    sorted_ss, card)
                if q == gm.EVAL_QS[0]:
                    checks.append(check)
                launches += n
                seen[producer] = seen.get(producer, 0) + n
                fracs[(name, algo, q)] = frac

    # FrugalEstimator at G = 1 (one group's lanes: q50 and q90) over E3
    # size stream 0, by extend / insert / query.
    estimates = {}
    for algo in gm.EVAL_ALGOS:
        fk.launch_count = 0
        staged = dict(fk.producer_launch_count)
        t0 = time.perf_counter()
        got = gm.estimator_feed(
            FrugalEstimator(quantiles=gm.EVAL_QS, algo=algo, seed=0), size[0])
        est_s = time.perf_counter() - t0
        n = fk.launch_count
        prod = {k: v - staged[k] for k, v in fk.producer_launch_count.items()}
        if not same_answer(got, data[f"eval/estimator/{algo}"]):
            fail(f"eval: FrugalEstimator {algo} differs from the JAX "
                 "package's")
        estimates[algo] = got
        if n == 0 or prod["cp.async"] != n:
            fail(f"eval: FrugalEstimator {algo} made {n} launches ({prod}), "
                 "expected cp.async launches")
        launches += n
        seen["cp.async"] = seen.get("cp.async", 0) + n
        say("eval", estimator=algo, groups=1, quantiles="0.5,0.9",
            stream_items=len(size[0]), b1_launches=n, producer="cp.async",
            answers=",".join(f"{v:.4f}" for v in got.ravel()),
            seconds=f"{est_s:.4f}", result="bit-identical to the JAX "
            "package's")

    # The fleets at the first quantile and the estimators again with the
    # plain version on the card (backend "jnp"): the same bits. The other
    # quantile's fleets run the same launches at the same shapes; their
    # estimates are held to the JAX package's above. (All 18 plain runs
    # took about 180 s, the longest part of the script.)
    plain_s = {}
    for tag, fleet, plain in checks:
        t0 = time.perf_counter()
        if not same_bits(torch, plain().state.planes(),
                         fleet.state.planes()):
            fail(f"eval {tag}: the kernel's planes differ from the plain "
                 "version's on the card")
        plain_s[tag] = time.perf_counter() - t0
    for algo in gm.EVAL_ALGOS:
        t0 = time.perf_counter()
        plain = gm.estimator_feed(FrugalEstimator(
            quantiles=gm.EVAL_QS, algo=algo, seed=0, backend="jnp",
            device="cuda"), size[0])
        if not same_answer(plain, estimates[algo]):
            fail(f"eval: FrugalEstimator {algo} differs from the plain "
                 "version on the card")
        plain_s[f"estimator {algo}"] = time.perf_counter() - t0
    say("eval", plain_version=f"{len(plain_s)} runs on the card",
        seconds=f"{sum(plain_s.values()):.2f}",
        per_run_s=",".join(f"{k.replace(' ', '_')}:{v:.2f}"
                           for k, v in plain_s.items()),
        result="B1's planes and answers bit-identical to each")

    # The baselines on the host, as benchmarks/common.py builds them.
    q = gm.EVAL_BASELINE_Q
    first = size[:gm.EVAL_BASELINE_STREAMS]
    sorted_first = [sorted(s.tolist()) for s in first]
    for i, algo in enumerate(gm.EVAL_BASELINES):
        t0 = time.perf_counter()
        est, words = [], []
        for s in first:
            b = gm.make_baseline(baselines, algo, s, q)
            b.extend(s)
            est.append(b.query(q))
            words.append(b.memory_words())
        secs = time.perf_counter() - t0
        if est != data["eval/baselines/estimates"][i].tolist() or \
                words != data["eval/baselines/memory_words"][i].tolist():
            fail(f"eval: baseline {algo} differs from the JAX package's")
        errs = [relative_mass_error(float(e), s, q)
                for e, s in zip(est, sorted_first)]
        say("eval", baseline=algo, streams=len(first), q=q,
            frac_within_0_1=f"{np.mean([abs(e) <= 0.1 for e in errs]):.4f}",
            memory_words_mean=f"{np.mean(words):.2f}",
            memory_words_max=max(words), seconds=f"{secs:.2f}",
            result="equal to the JAX package's")
    for algo in gm.EVAL_ALGOS:
        say("eval", frugal=algo, memory_words=1 if algo == "1u" else 2,
            **{f"frac_within_0_1_{n}_q{int(qq * 100)}": f"{f:.4f}"
               for (n, a, qq), f in fracs.items() if a == algo})
    if set(seen) != {"tma", "cp.async"}:
        fail(f"eval: producers seen {seen}, expected both")
    say("eval", b1_launches=launches,
        producers=",".join(f"{k}={v}" for k, v in sorted(seen.items())),
        phase_s=f"{time.perf_counter() - phase_t0:.1f}", card=card)
    return launches, blocks


# -------------------------------------------------------------- phase 11
E15_REPS = 3           # timed host-fed ingests per placement, after one
E15_SPLIT = 301        # the split ingest's cut (E15's call split)
E15_BAD_LANE = 12345   # the lane whose m word one replica loses
CARD = "cuda:0"        # the device per-device topologies repeat


def e15_placements():
    """E15's placements: None is the single placement."""
    from repro_torch.api import TopologySpec

    card8 = (CARD,) * 8
    return {"single": None,
            "1d_x8": TopologySpec(lanes=8, devices=card8),
            "2x4": TopologySpec(data=2, lanes=4, devices=card8),
            "2x4_loop": TopologySpec(data=2, lanes=4)}


def replica_crc32s(gm, fleet):
    return gm.plane_crc32s(fleet.state.replica_planes())


def check_crc32s(what, got, want):
    import numpy as np

    if not np.array_equal(got, want):
        fail(f"placement: {what}: CRC32s {got.tolist()} differ from the "
             f"JAX package's {want.tolist()}")


def with_bad_lane(fleet, replica, lane):
    """``fleet`` (a 2-D fleet) with replica ``replica``'s m word of lane
    ``lane`` made NaN, in a copy of that shard's m tensor."""
    rep = fleet.state.replicas[replica]
    w = rep.shard_groups
    s, i = divmod(lane, w)
    sh = rep.shards[s]
    m = sh.m.clone()
    m[i] = float("nan")
    shards = rep.shards[:s] + (dataclasses.replace(sh, m=m),) \
        + rep.shards[s + 1:]
    reps = list(fleet.state.replicas)
    reps[replica] = dataclasses.replace(rep, shards=shards)
    return dataclasses.replace(fleet, state=dataclasses.replace(
        fleet.state, replicas=tuple(reps)))


def e15_run(torch, gm, items, card):
    """Phase 11 (a): E15 at full size; returns the B1 launches expected
    of its timed ingests."""
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet, TopologySpec
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.parallel import merge_replica_planes
    from repro_torch.train import elastic

    data = np.load(GOLDEN)
    g, t_len = gm.E15_G, items.shape[0]
    chunks = -(-t_len // gm.E15_CHUNK_T)

    def spec(topo, groups=g):
        return FleetSpec(num_groups=groups, quantiles=(0.5,),
                         chunk_t=gm.E15_CHUNK_T, topology=topo)

    # The block's pageable host-to-device copy alone (host clock), the
    # first part of every host-fed ingest.
    h2d_ms = [timed(torch, lambda: torch.from_numpy(items).to(CARD))[1]
              for _ in range(2)]
    say("place", e15_block_h2d_ms=",".join(f"{v:.4f}" for v in h2d_ms),
        bytes=items.nbytes, card=card, note="host clock, pageable numpy")
    if torch.cuda.device_count() < 8:
        try:
            TopologySpec(lanes=8).resolve()
        except ValueError:
            pass
        else:
            fail("placement: TopologySpec(lanes=8) resolved with "
                 f"{torch.cuda.device_count()} card(s) and no devices")
    # B1 launches per ingest of the whole block, from the chunk routing: a
    # 2 x 4 call rounds its chunks up to a multiple of 2 with NaN chunks.
    rounded = -(-chunks // 2) * 2
    want = {"single": chunks, "1d_x8": 8 * chunks, "2x4": 4 * rounded,
            "2x4_loop": rounded}
    fleets = {}
    for name, topo in e15_placements().items():
        fresh = QuantileFleet.create(spec(topo), seed=gm.E15_SEED)
        mode = type(fresh.state).__name__ if topo is None or \
            topo.data == 1 else fresh.state.mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = fk.launch_count
        staged = dict(fk.producer_launch_count)
        fleet, first_ms = timed(torch, lambda: fresh.ingest(items))
        launches = fk.launch_count - before
        producers = producers_since(fk, staged)
        if launches != want[name]:
            fail(f"placement {name}: {launches} B1 launches per ingest, "
                 f"expected {want[name]}")
        ms = [timed(torch, lambda: fresh.ingest(items))[1]
              for _ in range(E15_REPS)]
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        _, names, busy = device_trace(torch, lambda: fresh.ingest(items))
        window_ms = (time.perf_counter() - t0) * 1e3
        b1_ms = None if names is None else sum(
            v for n, (_, v) in names.items() if "frugal_dense" in n)
        med = statistics.median(ms)
        say("place", e15=name, mode=mode, b1_launches=launches,
            producers=producers, first_ingest_ms=f"{first_ms:.4f}",
            ingest_ms=",".join(f"{v:.4f}" for v in ms),
            items_per_s=f"{items.size / med * 1e3:.4e}",
            b1_device_ms="null" if b1_ms is None else f"{b1_ms:.4f}",
            traced_window_ms=f"{window_ms:.4f}",
            device_busy_share="null" if busy is None
            else f"{busy / window_ms:.4f}",
            max_memory_allocated_bytes=peak, card=card,
            note="host clock, numpy items in")
        if name == "2x4":
            say_trace(11, names, busy, window_ms, 1, card)
        fleets[name] = fleet

    single = fleets["single"]
    est = single.estimate()
    if gm.chunk_crc32(est) != int(data["place/e15/single/estimate_crc32"]):
        fail("placement: the single fleet's estimates differ from the JAX "
             "package's")
    one_d = fleets["1d_x8"]
    if not same_bits(torch, one_d._lane_sketch().planes(),
                     single.state.planes()) or \
            not np.array_equal(one_d.estimate().view(np.int32),
                               est.view(np.int32)):
        fail("placement: the 1-D x 8 fleet differs from the single fleet")
    dev, loop = fleets["2x4"], fleets["2x4_loop"]
    if dev.state.mode != "devices" or loop.state.mode != "loop":
        fail(f"placement: modes {dev.state.mode}, {loop.state.mode}")
    for a, b in zip(dev.state.replica_planes(), loop.state.replica_planes()):
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            fail("placement: 2 x 4 per device differs from loop mode")
    check_crc32s("2 x 4 replicas", replica_crc32s(gm, dev),
                 data["place/e15/full/replica_crc32"])
    if gm.chunk_crc32(dev.estimate()) != \
            int(data["place/e15/full/estimate_crc32"]):
        fail("placement: the 2 x 4 merged estimates differ from the JAX "
             "package's")
    fresh = QuantileFleet.create(spec(e15_placements()["2x4"]),
                                 seed=gm.E15_SEED)
    split = fresh.ingest(items[:E15_SPLIT]).ingest(items[E15_SPLIT:])
    check_crc32s("2 x 4 split at row 301", replica_crc32s(gm, split),
                 data["place/e15/full/replica_crc32"])
    say("place", e15="checks", single_estimates="JAX package's",
        one_d="bit-identical to single",
        two_by_four="per device = loop mode = JAX package's CRC32s",
        split_at_301="equal to one ingest",
        merged_estimates="JAX package's")
    del fleets, single, one_d, dev, loop, split

    # The elastic sequence.
    card8 = (CARD,) * 8
    t24 = TopologySpec(data=2, lanes=4, devices=card8)
    t42 = TopologySpec(data=4, lanes=2, devices=card8)
    half = t_len // 2
    fl = fresh.ingest(items[:half])
    check_crc32s("elastic: rows 0-255 under 2 x 4", replica_crc32s(gm, fl),
                 data["place/e15/elastic/half"])
    est = fl.estimate()
    fl, grow_ms = timed(torch, lambda: fl.reshard(t42))
    if not np.array_equal(fl.estimate().view(np.int32), est.view(np.int32)):
        fail("placement: reshard 2 x 4 -> 4 x 2 moved the estimate")
    fl = fl.ingest(items[half:])
    check_crc32s("elastic: rows 256-511 under 4 x 2", replica_crc32s(gm, fl),
                 data["place/e15/elastic/ingested"])
    prog = fl.spec.program
    folded = merge_replica_planes(prog, fl.state.replica_planes())
    fl, sync_ms = timed(torch, fl.sync)
    for p, want_p in zip(fl.state.replica_planes(), folded):
        if not all(np.array_equal(p[r].view(np.int32), want_p.view(np.int32))
                   for r in range(p.shape[0])):
            fail("placement: the card's sync at R = 4 differs from the "
                 "numpy fold")
    check_crc32s("elastic: sync", replica_crc32s(gm, fl),
                 data["place/e15/elastic/synced"])
    est = fl.estimate()
    if gm.chunk_crc32(est) != int(data["place/e15/elastic/estimate_crc32"]):
        fail("placement: the synced estimates differ from the JAX "
             "package's")
    fl, shrink_ms = timed(torch, lambda: fl.reshard(t24))
    if not np.array_equal(fl.estimate().view(np.int32), est.view(np.int32)):
        fail("placement: reshard 4 x 2 -> 2 x 4 moved the estimate")
    before = fl.state.replica_planes()
    fl = fl.grow_groups(gm.E15_GROW)
    after = fl.state.replica_planes()
    if not all(np.array_equal(a[:, :g].view(np.int32), b.view(np.int32))
               for a, b in zip(after, before)):
        fail("placement: grow_groups moved existing lanes")
    check_crc32s("elastic: grown", gm.plane_crc32s(after),
                 data["place/e15/elastic/grown"])
    canon = fl._lane_sketch().planes()
    check_crc32s("elastic: canonical lanes", gm.plane_crc32s(
        tuple(p.cpu().numpy()[None] for p in canon)),
        data["place/e15/elastic/canonical"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_place_")
    try:
        _, save_ms = timed(torch, lambda: fl.checkpoint(tmp, step=1))
        restore_ms = {}
        for name, topo in (("single", TopologySpec()),
                           ("1d_x8", TopologySpec(lanes=8, devices=card8)),
                           ("4x2", t42)):
            back, restore_ms[name] = timed(
                torch, lambda: elastic.fleet_reshard_restore(
                    tmp, fl.spec, topo))
            if not same_bits(torch, back._lane_sketch().planes(), canon):
                fail(f"placement: the checkpoint restored onto {name} "
                     "differs from the canonical planes")
        ckpt_bytes = dir_bytes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("place", elastic="2x4 -> 4x2 -> sync -> 2x4 -> grow -> checkpoint",
        reshard_2x4_to_4x2_ms=f"{grow_ms:.4f}", sync_r4_ms=f"{sync_ms:.4f}",
        reshard_4x2_to_2x4_ms=f"{shrink_ms:.4f}",
        checkpoint_save_ms=f"{save_ms:.4f}",
        restore_ms=",".join(f"{k}:{v:.4f}" for k, v in restore_ms.items()),
        checkpoint_bytes=ckpt_bytes, card=card,
        result="every step equal to the JAX package's CRC32s; sync = numpy "
        "fold; restores identical")

    # A quarantine over the merged lanes: a sync point.
    fl = dataclasses.replace(fl, spec=dataclasses.replace(
        fl.spec, health="quarantine"))
    bad = with_bad_lane(fl, 1, E15_BAD_LANE)
    healed, rep = bad.check_health()
    if rep.healthy or rep.corrupt_lanes != 1 or rep.quarantined != 1:
        fail(f"placement: the scan found {rep}")
    if not healed.check_health()[1].healthy:
        fail("placement: a second scan after the heal is not healthy")
    fresh_lane = (0.0, 1.0, 1.0)
    for p, c, fill in zip(healed.state.replica_planes(), canon, fresh_lane):
        c = c.cpu().numpy().copy()
        c[E15_BAD_LANE] = fill
        if not all(np.array_equal(p[r].view(np.int32), c.view(np.int32))
                   for r in range(p.shape[0])):
            fail("placement: after the quarantine a replica differs from "
                 "the canonical lanes with the healed lane fresh")
    say("place", quarantine="one replica's m word NaN",
        corrupt_lanes=rep.corrupt_lanes, quarantined=rep.quarantined,
        second_scan="healthy",
        result="every replica = canonical lanes, the healed lane fresh")
    return sum(want.values()) * (2 + E15_REPS)   # first, timed, traced


def phase_placement(torch, gm, card, dense_period_ms):
    """Phase 11; returns B1's launches in the phase."""
    import numpy as np
    from repro_torch.api import FleetSpec, QuantileFleet, TopologySpec
    from repro_torch.core import program as program_mod
    from repro_torch.core import streaming
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.parallel import merge_replica_planes

    phase_t0 = time.perf_counter()
    data = np.load(GOLDEN)
    fk.launch_count = 0
    staged = dict(fk.producer_launch_count)

    # (a) E15 at its full size.
    t0 = time.perf_counter()
    items = gm.e15_items()
    make_s = time.perf_counter() - t0
    crc = gm.chunk_crc32(items)
    if crc != int(data["place/e15/items_crc32"]):
        fail(f"placement: numpy {np.__version__} here draws another E15 "
             f"block than the golden file's (CRC32 {crc})")
    say("place", e15_items=list(items.shape), crc32=crc,
        crc32_golden="match", making_items_s=f"{make_s:.2f}")
    e15_launches = e15_run(torch, gm, items, card)
    del items

    # (b) The dense cell under a data axis (loop mode on one card).
    dev = torch.device("cuda")
    marks = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def dense_chunks(on_chunk=None):
        """Phase 5's chunks: the same generator, draws and order."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        scale = torch.exp(torch.empty(G_FULL, device=dev).uniform_(
            3.0, 8.0, generator=gen))
        torch.randperm(G_FULL, generator=gen, device=dev)  # phase 5's sample
        for _ in range(N_CHUNKS):
            if on_chunk is not None:
                on_chunk()
            x = torch.empty((CHUNK_T, G_FULL), device=dev).log_normal_(
                0.0, 1.0, generator=gen)
            yield x.mul_(scale)

    spec = FleetSpec(num_groups=G_FULL, quantiles=QS, program="2u",
                     chunk_t=CHUNK_T, topology=TopologySpec(data=2))
    fleet = QuantileFleet.create(spec, seed=0)
    if fleet.state.mode != "loop":
        fail(f"placement: the dense cell runs in mode {fleet.state.mode}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = fk.launch_count
    t0 = time.perf_counter()
    fleet = fleet.ingest_stream(dense_chunks(mark))
    mark()
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dense_launches = fk.launch_count - before
    peak = torch.cuda.max_memory_allocated()
    periods = [a.elapsed_time(b) for a, b in zip(marks[1:-1], marks[2:])]
    if dense_launches != 2 * N_CHUNKS:
        fail(f"placement: the dense cell launched B1 {dense_launches} "
             f"times, expected {2 * N_CHUNKS} (a chunk and an all-NaN "
             "round-up chunk per call)")
    prog = spec.program
    singles = [QuantileFleet.create(spec.with_topology(TopologySpec()),
                                    seed=0).state for _ in range(2)]
    for c, x in enumerate(dense_chunks()):
        singles[c % 2] = streaming.ingest_slabs(
            singles[c % 2], [x], [c * CHUNK_T], 0, 0,
            lanes_per_group=len(QS))
    for r, (sk, single) in enumerate(zip(fleet.state.replica_sketches(),
                                         singles)):
        if not same_bits(torch, sk.planes(), single.planes()):
            fail(f"placement: dense replica {r} differs from a single fleet "
                 "over its chunks")
    del singles
    host = fleet.state.replica_planes()
    folded = merge_replica_planes(prog, host)
    est = fleet.estimate()
    if not np.array_equal(est.reshape(-1).view(np.int32),
                          folded[0].view(np.int32)):
        fail("placement: the dense merged estimate differs from the numpy "
             "fold")
    synced, sync_ms = timed(torch, fleet.sync)
    for p, want_p in zip(synced.state.replica_planes(), folded):
        if not all(np.array_equal(p[r].view(np.int32), want_p.view(np.int32))
                   for r in range(2)):
            fail("placement: the card's dense sync differs from the numpy "
                 "fold")
    del synced, host, folded
    say("place", dense_cell=f"{G_FULL}x{len(QS)}", topology="data=2 (loop)",
        chunks=N_CHUNKS, b1_launches=dense_launches,
        chunk_period_ms=",".join(f"{v:.4f}" for v in periods),
        median_chunk_period_ms=f"{statistics.median(periods):.4f}",
        phase5_median_chunk_period_ms=f"{dense_period_ms:.4f}",
        ingest_s=f"{dense_s:.4f}", sync_r2_ms=f"{sync_ms:.4f}",
        max_memory_allocated_bytes=peak, card=card,
        result="each replica = a single fleet over its chunks; merged "
        "estimate and sync = numpy fold")
    del fleet

    # (c) Six programs under 3 x 2, both modes.
    six = gm.six_items()
    if gm.chunk_crc32(six) != int(data["place/six/items_crc32"]):
        fail("placement: numpy here draws other six-program items than "
             "the golden file's")
    six_launches = 0
    per_replica = -(-(-(-gm.SIX_T // gm.SIX_CHUNK_T)) // gm.SIX_DATA)
    for p in program_mod.test_instances():
        for mode, devices in (("devices", (CARD,) * 6), ("loop", None)):
            topo = TopologySpec(data=gm.SIX_DATA, lanes=gm.SIX_LANES,
                                devices=devices)
            before = fk.launch_count
            fl = QuantileFleet.create(FleetSpec(
                num_groups=gm.SIX_G, quantiles=gm.SIX_QS,
                chunk_t=gm.SIX_CHUNK_T, program=p, topology=topo),
                seed=gm.SIX_SEED).ingest(six)
            n = fk.launch_count - before
            want_n = per_replica * gm.SIX_DATA * (
                gm.SIX_LANES if mode == "devices" else 1)
            if fl.state.mode != mode or n != want_n:
                fail(f"placement: {p.family} ran in mode {fl.state.mode} "
                     f"with {n} B1 launches, expected {mode} and {want_n}")
            six_launches += n
            key = f"place/six/{p.family}"
            fields = p.layout.plane_fields
            reps = fl.state.replica_planes()
            merged = fl.state.merged_planes()
            folded = merge_replica_planes(p, reps)
            synced = fl.sync().state.replica_planes()
            for f, a, m, fo, sy in zip(fields, reps, merged, folded, synced):
                want_m = data[f"{key}/merged/{f}"].view(np.int32)
                if not np.array_equal(a.view(np.int32),
                                      data[f"{key}/replicas/{f}"]
                                      .view(np.int32)) or \
                        not np.array_equal(m.view(np.int32), want_m) or \
                        not np.array_equal(fo.view(np.int32), want_m) or \
                        not all(np.array_equal(sy[r].view(np.int32), want_m)
                                for r in range(gm.SIX_DATA)):
                    fail(f"placement: {p.family} {mode} plane {f} differs "
                         "from the golden file (replicas, merged, or the "
                         "card's sync at R = 3)")
    say("place", six_programs=",".join(
        x.family for x in program_mod.test_instances()),
        groups=gm.SIX_G, quantiles=len(gm.SIX_QS), ticks=gm.SIX_T,
        topology=f"{gm.SIX_DATA}x{gm.SIX_LANES}", modes="devices,loop",
        b1_launches=six_launches,
        result="replica and merged planes = golden; card sync at R = 3 = "
        "numpy fold")

    launches = fk.launch_count
    want = e15_launches + dense_launches + six_launches
    say("place", b1_launches=launches, producers=producers_since(fk, staged),
        phase_s=f"{time.perf_counter() - phase_t0:.1f}", card=card)
    if launches < want:
        fail(f"placement: {launches} B1 launches in the phase, expected at "
             f"least {want}")
    return launches


# -------------------------------------------------------------- phase 12
# E16 in full mode (benchmarks/bench_roofline.py:59-61, 163-183): G = 2^22
# groups, T = 4096 ticks, 1u / 2u / 2u-window at Q = 1 (1, 2 and 4 state
# words) and 2u at Q = 3, items the integers 0..999, seed 0.
E16_G, E16_T, E16_SEED = 2 ** 22, 4096, 0
E16_ROWS = (("1u", 1), ("2u", 1), ("2u-window", 1), ("2u", 3))
E16_GATE = 0.35          # E16's GATE_FRACTION_MIN, shown as information
E16_REPS = 3             # timed launches per row, after the counted one
E16_B2_ROWS = 512        # the block_t walk of (c)
E16_SLICE, E16_SLICE_AT = 2 ** 16, 3 * 2 ** 20 + 4099   # the plain slice
TUNE_REPS = 3            # timed B1 runs per block size in (e), after one


@contextlib.contextmanager
def launch_shapes(into):
    """Count every B1 launch the entry points (kernels.ops) make on the
    card into the Counter ``into``, keyed by (kernel family, T, G, Q,
    block_g)."""
    from repro_torch.kernels import ops

    real = ops.frugal_program_dense

    def counted(program, items, *args, **kw):
        if items.device.type == "cuda" and items.shape[0]:
            into[(program.kernel_family, *items.shape,
                  kw.get("lanes_per_group", 1), kw["block_g"])] += 1
        return real(program, items, *args, **kw)

    ops.frugal_program_dense = counted
    try:
        yield into
    finally:
        ops.frugal_program_dense = real


def check_plan(fk, km, fam, t, g, q, block_g):
    """The model's launch plan against the CUDA library's
    (dense_launch_info); returns the model's."""
    plan = km.dense_plan(t, g, q, block_g)
    info = fk.dense_launch_info(fk.FAMILY_IDS[fam], t, g, q, block_g)
    got = {k: plan[k] for k in ("lpt", "rows", "cols", "smem_bytes",
                                "blocks")}
    want = dict(zip(got, (info["lanes_per_thread"], info["tile_rows"],
                          info["tile_cols"], info["smem_bytes"],
                          info["grid_blocks"])))
    if got != want:
        fail(f"roofline: the model's plan {got} != dense_launch_info "
             f"{want} at {fam} [{t}, {g}] Q = {q}, block_g {block_g}")
    return plan


def e16_row(torch, ops, hw, clock_hz, items, fam, q):
    """One E16 row through frugal_update_auto at the tuned blocks: the
    counted launch, the timed ones, and (c)'s bits. Returns its kernels
    line entry."""
    from repro_torch.core import frugal, program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.roofline import autotune_blocks, predict_kernel

    dev = items.device
    prog = program_mod.family_base(fam)
    lanes = E16_G * q
    planes = tuple(torch.full((lanes,), prog.layout.pad_fill(f), device=dev)
                   for f in prog.layout.plane_fields)
    quantile = torch.linspace(0.3, 0.9, q, device=dev).repeat(E16_G)
    bg, bt = autotune_blocks(prog, E16_G, E16_T, q, hw=hw)

    def auto(**kw):
        return ops.frugal_update_auto(items, planes, quantile, seed=E16_SEED,
                                      program=prog, lanes_per_group=q, **kw)

    torch.cuda.synchronize()
    fk.launch_count = 0
    tuned = auto()
    torch.cuda.synchronize()
    launches = fk.launch_count
    if launches != 1:
        fail(f"roofline: E16 {fam} Q = {q} made {launches} launches, "
             "expected one")
    ms = event_ms(torch, auto, E16_REPS)
    pred = predict_kernel(E16_G, E16_T, q, prog.layout, block_g=bg,
                          block_t=bt, hw=hw, sm_clock_hz=clock_hz)
    measured = E16_T * E16_G / (statistics.median(ms) / 1e3)
    frac = measured / pred["items_per_s_predicted"]
    say("roofline", check="b", family=fam, q=q, groups=E16_G, ticks=E16_T,
        tuned_block_g=bg, tuned_block_t=bt, launches=launches,
        bytes=int(pred["bytes_total"]),
        bandwidth_s=f"{pred['bandwidth_s']:.6e}",
        operations_s=f"{pred['operations_s']:.6e}",
        operations_bound_by=pred["operations_bound_by"],
        bound_by=pred["bound_by"], predicted_s=f"{pred['predicted_s']:.6e}",
        items_per_s_bound=f"{pred['items_per_s_bound']:.4e}",
        items_per_s_predicted=f"{pred['items_per_s_predicted']:.4e}",
        smem_bytes=pred["smem_bytes"], blocks=pred["grid"][0],
        kernel_ms=",".join(f"{v:.4f}" for v in ms),
        measured_items_per_s=f"{measured:.4e}",
        fraction_of_roofline=f"{frac:.4f}", e16_gate=E16_GATE,
        gate="met" if frac >= E16_GATE else "missed (information only)",
        card_sm_clock_hz=f"{clock_hz:.4e}")

    # (c) the same planes at 256 threads, as block_t-row launches, in the
    # plain version over the whole block, and in the plain version over a
    # column slice at its lane offset.
    if not same_bits(torch, auto(block_g=256), tuned):
        fail(f"roofline: E16 {fam} Q = {q}: block_g {bg} and 256 differ")
    with ops.block_override(block_t=E16_B2_ROWS):
        walk = auto()
    if not same_bits(torch, walk, tuned):
        fail(f"roofline: E16 {fam} Q = {q}: {E16_B2_ROWS}-row launches "
             "differ from one launch")
    res = {}

    def plain():
        res["plain"], _ = frugal.program_process_seeded(
            prog, planes, items, E16_SEED, quantile, lanes_per_group=q)

    plain_ms = event_ms(torch, plain, 1)[0]
    err = max_abs_err(tuned, res["plain"])
    if not same_bits(torch, tuned, res["plain"]):
        fail(f"roofline: E16 {fam} Q = {q}: the kernel differs from the "
             f"plain version (max abs err {err})")
    c0, c1 = E16_SLICE_AT * q, (E16_SLICE_AT + E16_SLICE) * q
    sl = items[:, E16_SLICE_AT:E16_SLICE_AT + E16_SLICE].contiguous()
    part, _ = frugal.program_process_seeded(
        prog, tuple(p[c0:c1] for p in planes), sl, E16_SEED,
        quantile[c0:c1], g_offset=c0, lanes_per_group=q)
    if not same_bits(torch, part, tuple(p[c0:c1] for p in tuned)):
        fail(f"roofline: E16 {fam} Q = {q}: the plain version's column "
             "slice differs")
    say("roofline", check="c", family=fam, q=q,
        result=f"block_g {bg} = 256 = {E16_B2_ROWS}-row launches = the "
               f"plain version ({plain_ms:.1f} ms) = its slice of "
               f"{E16_SLICE} columns at g_offset {c0}, bit for bit")
    return kernel_entry(
        f"frugal_program_dense[E16 {fam} q{q}: [{E16_T}, {E16_G}], "
        f"block_g {bg}]", KERNEL_SOURCE, TPU_KERNEL, launches, err,
        statistics.median(ms), plain_ms, pred["bandwidth_s"] * 1e3,
        pred["operations_s"] * 1e3)


def phase_roofline(torch, gm, card, loops, shapes, eval_blocks):
    """Phase 12; returns (the E16 rows' kernels line entries, B1's
    launches in their counted runs)."""
    from repro_torch.configs import platform
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.kernels import ops
    from repro_torch.roofline import (autotune_blocks, detect_hw,
                                      kernel_bytes_total, predict_kernel)
    from repro_torch.roofline import kernel_model as km

    phase_t0 = time.perf_counter()
    # (a) detection
    kind = torch.cuda.get_device_name(0)
    plat, dkind, hw = (platform.detect_platform(),
                       platform.detect_device_kind(), detect_hw())
    if plat != "gpu" or dkind != kind or hw.name != "gpu-h100":
        fail(f"roofline: detected platform {plat!r}, kind {dkind!r}, "
             f"HwSpec {hw.name!r} on {kind!r}")
    card_hw(torch)
    _, clock_hz = card_sm_clocks_per_s(torch)
    say("roofline", check="a", platform=plat, device_kind=dkind, hw=hw.name,
        sms=hw.cores, hbm_bytes_per_s=f"{hw.hbm_bw:.4e}",
        max_sm_clock_hz=f"{clock_hz:.4e}",
        compiled_kernels=platform.supports_compiled_kernels(),
        note="registry figures are published constants")
    for fam, sass in sorted(loops.items()):
        slots = km.issue_slots(km.LANE_TICK_OPS[fam])
        say("roofline", family=fam, model_issue_slots_per_lane_tick=slots,
            sass_per_lane_tick_q3=f"{sass:.2f}")
        if slots > sass:
            fail(f"roofline: {fam}'s issue-slot table ({slots}) exceeds "
                 f"this build's {sass:.2f} SASS per lane-tick: no floor")

    # (d) the model against the card at every shape phases 5, 9, 10 and 11
    # launched, and at E16's.
    fams = {f: program_mod.family_base(f) for f in fk.FAMILY_IDS}
    main_shapes = {5: ("2u", CHUNK_T, G_FULL, len(QS), 256),
                   9: ("2u-decay", SVC_CHUNK_T, SVC_G, 1, 256)}
    for phase, key in main_shapes.items():
        if key not in shapes[phase]:
            fail(f"roofline: phase {phase} launched {dict(shapes[phase])}, "
                 f"not {key}")
    bound = {}
    for phase, counter in sorted(shapes.items()):
        for (fam, t, g, q, bg), n in sorted(counter.items()):
            tuned = autotune_blocks(fams[fam], g, t, q, hw=hw)[0]
            for b in sorted({bg, tuned}):
                check_plan(fk, km, fam, t, g, q, b)
            plan = km.dense_plan(t, g, q, bg)
            pred = predict_kernel(g, t, q, fams[fam].layout, block_g=bg,
                                  block_t=t, hw=hw, sm_clock_hz=clock_hz)
            bound[(fam, t, g, q)] = pred["bound_s"] * 1e3
            say("roofline", check="d", of_phase=phase, family=fam, ticks=t,
                groups=g, q=q, launches=n, block_g=bg, tuned_block_g=tuned,
                lpt=plan["lpt"], rows=plan["rows"], cols=plan["cols"],
                smem_bytes=plan["smem_bytes"], blocks=plan["blocks"],
                bound_ms_per_launch=f"{bound[(fam, t, g, q)]:.6f}",
                bound_by=pred["bound_by"], plan="= dense_launch_info")
            if phase in main_shapes and (fam, t, g, q, bg) == \
                    main_shapes[phase] and tuned != 256:
                fail(f"roofline: the tuner picks {tuned} at phase {phase}'s "
                     "shape, not 256")
    for fam, q in E16_ROWS:
        tuned = autotune_blocks(fams[fam], E16_G, E16_T, q, hw=hw)[0]
        plan = check_plan(fk, km, fam, E16_T, E16_G, q, tuned)
        say("roofline", check="d", of_phase=12, family=fam, ticks=E16_T,
            groups=E16_G, q=q, tuned_block_g=tuned, lpt=plan["lpt"],
            rows=plan["rows"], cols=plan["cols"],
            smem_bytes=plan["smem_bytes"], blocks=plan["blocks"],
            plan="= dense_launch_info")
    # Phase 11's bounds: E15 per host-fed ingest at each placement (its
    # launches per ingest x the bound of one), the dense cell under
    # data=2 per chunk period (two [512, 2^22] launches at Q = 3).
    chunks = gm.E15_T // gm.E15_CHUNK_T
    for name, (n, g) in {"single": (chunks, gm.E15_G),
                         "1d_x8": (chunks * 8, gm.E15_G // 8),
                         "2x4": (chunks * 4, gm.E15_G // 4),
                         "2x4_loop": (chunks, gm.E15_G)}.items():
        key = ("2u", gm.E15_CHUNK_T, g, 1)
        if key not in bound:
            fail(f"roofline: phase 11 launched no {key}")
        say("roofline", of_phase=11, e15_placement=name, launches_per_ingest=n,
            columns_per_launch=g,
            bound_ms_per_ingest=f"{n * bound[key]:.6f}")
    say("roofline", of_phase=11, dense_data2="per chunk period, 2 launches",
        bound_ms=f"{2 * bound[('2u', CHUNK_T, G_FULL, len(QS))]:.6f}")

    # (f) E16's model-consistency check: the analytic bytes at Q = 1 are
    # at or above the operand floor.
    for fam in ("1u", "2u", "2u-window"):
        layout = fams[fam].layout
        analytic = kernel_bytes_total(E16_G, E16_T, 1, layout, block_t=E16_T)
        floor = E16_T * E16_G * 4 + 2 * E16_G * layout.num_words * 4
        if analytic < floor:
            fail(f"roofline: {fam}: analytic bytes {analytic} below the "
                 f"operand floor {floor}")
        say("roofline", check="f", family=fam, analytic_bytes=int(analytic),
            operand_floor_bytes=floor, model_consistent=True)

    # (c, second half) the six programs at E3's shape: tuned = 256.
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    e3 = eval_blocks["e3_size"]
    for prog in program_mod.test_instances():
        planes = random_planes(torch, prog, e3.shape[1], gen, dev)
        kw = dict(seed=7, program=prog, t_offset=2 ** 31 - 5000)
        tuned = autotune_blocks(prog, e3.shape[1], e3.shape[0], 1, hw=hw)[0]
        got = ops.frugal_update_auto(e3, planes, 0.7, **kw)
        if not same_bits(torch, got, ops.frugal_update_auto(
                e3, planes, 0.7, block_g=256, **kw)):
            fail(f"roofline: {prog.family} at E3's shape: block_g {tuned} "
                 "and 256 differ")
        say("roofline", check="c", family=prog.family,
            shape=list(e3.shape), tuned_block_g=tuned,
            result="bit-identical to block_g 256")

    # (e) B1 alone at the evaluation shapes, at the tuned block size and at
    # 256, as the fleets launch it (EVAL_CHUNK_T-row launches).
    for name, block in eval_blocks.items():
        t_len, g = block.shape
        for algo in ("1u", "2u"):
            prog = fams[algo]
            words = tuple(w.contiguous() for w in prog.layout.pack_planes(
                random_planes(torch, prog, g, gen, dev)))
            quantile = torch.full((g,), 0.5, device=dev)
            tuned = autotune_blocks(prog, g, gm.EVAL_CHUNK_T, 1, hw=hw)[0]
            res, ms = {}, {}
            for bg in (tuned, 256):
                def run(bg=bg):
                    w = words
                    for r0 in range(0, t_len, gm.EVAL_CHUNK_T):
                        w = fk.frugal_program_dense(
                            prog, block[r0:r0 + gm.EVAL_CHUNK_T], w,
                            quantile, 3, t_offset=r0, block_g=bg)
                    res[bg] = w
                ms[bg] = event_ms(torch, run, TUNE_REPS + 1)[1:]
            if not same_bits(torch, res[tuned], res[256]):
                fail(f"roofline: {name} {algo}: block_g {tuned} and 256 "
                     "differ")
            faster = min(ms, key=lambda b: statistics.median(ms[b]))
            say("roofline", check="e", workload=name, algo=algo,
                shape=[t_len, g], tuned_block_g=tuned,
                tuned_ms=",".join(f"{v:.4f}" for v in ms[tuned]),
                b256_ms=",".join(f"{v:.4f}" for v in ms[256]),
                faster_block_g=faster, card=card)

    # (b) E16: the [4096, 2^22] block made on the card.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen.manual_seed(E16_SEED)
    t0 = time.perf_counter()
    items = torch.randint(0, 1000, (E16_T, E16_G), dtype=torch.float32,
                          generator=gen, device=dev)
    torch.cuda.synchronize()
    say("roofline", check="b", e16_items=[E16_T, E16_G],
        bytes=items.numel() * 4, making_s=f"{time.perf_counter() - t0:.3f}",
        allocated_before_bytes=held,
        note="integers 0..999 drawn on the card (E16 draws them in numpy)")
    entries = [e16_row(torch, ops, hw, clock_hz, items, fam, q)
               for fam, q in E16_ROWS]
    del items
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    say("roofline", max_memory_allocated_bytes=peak,
        phase_s=f"{time.perf_counter() - phase_t0:.1f}", card=card)
    return entries, sum(e["launches"] for e in entries)


# --------------------------------------------------------------- phase 13
SERVE_SEED = 0           # numpy seed of the traffic, torch seed of weights
SERVE_SLOTS, SERVE_MAX_LEN = 4, 512
SERVE_ROUTES = 10 ** 6
# Requests of each full-width engine run of phases 13 and 16: 8 keeps
# the whole script well inside its time limit on a slow host.
SERVE_REQUESTS = 8
SERVE_TRACE_STEPS = 8
# Decode path against forward at full width, bf16 activations through 32
# layers: |difference| at most this times max |logit|.
SERVE_FORWARD_TOL = 3e-2
SERVE_GOLDEN_LOGIT_TOL = 1e-4
SERVE_FULL = {"layers": 32, "d_model": 4096, "num_heads": 32,
              "num_kv_heads": 4, "d_ff": 11008, "vocab_size": 64000}
# Free device memory a full-width engine needs beyond its float32 weights:
# per-call bf16 weight casts (one MoE layer's experts: 1.1 GB at deepseek),
# the caches and the allocator's slack.
MEM_HEADROOM = 4 * 2 ** 30


def golden_engine(torch, gm, model, data, prefix, what):
    """The port's engine on the card around ``model``, under the golden
    maker's fake clock, fed ``gm.serve_requests``: the JAX engine's tokens
    (``data[prefix + "serve/..."]``), first step logits within
    SERVE_GOLDEN_LOGIT_TOL, summary and SLO state bit for bit; ``what``
    names the check in a failure. Returns the logits' max abs error."""
    import numpy as np
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve import engine as engine_mod

    real_time = engine_mod.time
    engine_mod.time = gm.FakeClock()
    try:
        eng = ServeEngine(model, batch_slots=gm.SERVE_SLOTS,
                          max_len=gm.SERVE_MAX_LEN)
        if eng.device.type != "cuda" or eng.slo.device.type != "cuda":
            fail(f"{what}: the engine runs on {eng.device}")
        got = gm.serve_engine_results(eng, Request)
    finally:
        engine_mod.time = real_time
    for k in ("serve/outputs", "serve/output_lengths"):
        if not np.array_equal(got[k], data[prefix + k]):
            fail(f"{what}: {k} {got[k].tolist()} != the JAX engine's "
                 f"{data[prefix + k].tolist()}")
    err = float(np.abs(got["serve/first_step_logits"]
                       - data[prefix + "serve/first_step_logits"]).max())
    if not err <= SERVE_GOLDEN_LOGIT_TOL:
        fail(f"{what}: first step logits differ by {err}")
    for k in ("serve/summary", "serve/slo/m", "serve/slo/step",
              "serve/slo/sign", "serve/slo/ticks"):
        if not np.array_equal(got[k].view(np.int32),
                              data[prefix + k].view(np.int32)):
            fail(f"{what}: {k} differs from the JAX engine's")
    return err


def serve_golden(torch, gm):
    """(a) The golden file's reduced yi-6b (the JAX package's weights,
    stored) through params_from_numpy and the port's engine on the card,
    under the golden maker's fake clock (``golden_engine``)."""
    import numpy as np
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import params_from_numpy

    data = np.load(GOLDEN)
    cfg = gm.serve_config(reduce_for_smoke(get_config(gm.SERVE_ARCH)))
    model = params_from_numpy(cfg, gm.unflatten_params(data),
                              device="cuda")
    err = golden_engine(torch, gm, model, data, "", "serving (a)")
    say("serve", check="a", arch=f"{gm.SERVE_ARCH} reduced "
        f"(d_model {cfg.d_model}, {cfg.num_layers} layers, float32)",
        requests=len(data["serve/prompt_lengths"]),
        tokens=int(data["serve/output_lengths"].sum()),
        tokens_equal=True, first_step_logits_max_abs_err=f"{err:.3e}",
        summary_and_slo_state="bit-identical to the JAX engine's")


def serve_traffic(rng, vocab, names, n):
    """``n`` requests: prompts of 8-32 tokens, 16-32 new tokens, routes
    Zipf(1.2) over ``names``."""
    from repro_torch.serve import Request

    out = []
    for rid in range(n):
        n = int(rng.integers(8, 33))
        out.append(Request(rid=rid, prompt=rng.integers(0, vocab, n).tolist(),
                           max_new_tokens=int(rng.integers(16, 33)),
                           route=names[int((rng.zipf(ZIPF_A) - 1)
                                           % len(names))]))
    return out


def instrument_engine(torch, eng):
    """Record, on ``eng``, the SLO observations and flush boundaries
    (``observed``, ``flush_at``), CUDA events around each step decode call
    (``decode_events``) and around each flush (``flush_events``) with the
    flush's host ms (``flush_host_ms``), the host ms of each prefill call
    (``prefill_host_ms``: its dispatch, no sync) and the engine's own
    per-token dispatch ms (``dispatch_ms``)."""
    eng.observed, eng.flush_at, eng.decode_events = [], [], []
    eng.flush_events, eng.flush_host_ms, eng.dispatch_ms = [], [], []
    eng.prefill_host_ms = []
    observe, flush = eng.slo.observe, eng.slo.flush
    decode, admit = eng._decode, eng._admit
    state = {"admitting": False}

    def observe_recorded(route, metric, value):
        eng.observed.append((route, metric, value))
        if metric == "tok_q50_ms":
            eng.dispatch_ms.append(value)
        observe(route, metric, value)

    def flush_timed():
        if eng.slo._pending:
            eng.flush_at.append(len(eng.observed))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        flush()
        b.record()
        eng.flush_host_ms.append((time.perf_counter() - t0) * 1e3)
        eng.flush_events.append((a, b))

    def admit_marked():
        state["admitting"] = True
        try:
            admit()
        finally:
            state["admitting"] = False

    def decode_timed(*args):
        if state["admitting"]:
            t0 = time.perf_counter()
            out = decode(*args)
            eng.prefill_host_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = decode(*args)
        b.record()
        eng.decode_events.append((a, b))
        return out

    eng.slo.observe, eng.slo.flush = observe_recorded, flush_timed
    eng._decode, eng._admit = decode_timed, admit_marked
    return eng


def serve_replay_on_cpu(torch, eng, names):
    """A CPU SLOFleet of the engine's seed and capacity, fed the engine's
    recorded observations with its flush boundaries: every plane and
    clock bit-identical to the card's fleet."""
    from repro_torch.serve import SLOFleet

    plain = SLOFleet(seed=0, capacity=64, device="cpu")
    plain.ensure_routes(names)
    start = 0
    for end in eng.flush_at:
        for route, metric, value in eng.observed[start:end]:
            plain.observe(route, metric, value)
        plain.flush()
        start = end
    if start != len(eng.observed):
        fail("serving (b): observations after the last flush")
    if plain._cap_routes != eng.slo._cap_routes:
        fail("serving (b): the replay's capacity differs")
    for name in ("_m", "_step", "_sign", "_ticks"):
        if not torch.equal(getattr(eng.slo, name).cpu(),
                           getattr(plain, name)):
            fail(f"serving (b): SLO {name} differs from the CPU replay")
    return plain


def serve_forward_check(torch, model, req, tol=SERVE_FORWARD_TOL):
    """The decode path (a fresh batch-1 cache fed the request's tokens one
    by one) against forward(..., last_only=True) over the same tokens, at
    the last position; held to ``tol`` x max |logit| unless it is None."""
    seq = req.prompt + req.output[:-1]
    toks = torch.tensor([seq], dtype=torch.int32, device="cuda")
    cache = model.init_cache(1, SERVE_MAX_LEN)
    for p in range(len(seq)):
        dec, cache = model.decode_step(toks[:, p:p + 1], cache, p)
    with torch.no_grad():
        fwd, _ = model(toks, last_only=True)
    scale = float(fwd.abs().max())
    err = float((dec - fwd).abs().max())
    if tol is not None and not err <= tol * scale:
        fail(f"serving: {model.cfg.name}'s decode path's logits differ from "
             f"forward's by {err} (max |logit| {scale})")
    same_top = int(dec[0, 0].argmax()) == int(fwd[0, 0].argmax())
    return len(seq), err, scale, same_top


def serve_trace(torch, model, names, rng, card, tag="serve"):
    """A second engine of the same shape (10^6 routes registered): its
    admission step (SERVE_SLOTS prompts of 16 tokens prefilled, one decode
    call each, then one step's decode) traced, then SERVE_TRACE_STEPS
    decode-only steps traced. Result lines start with ``tag``."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(model, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    eng.slo.ensure_routes(names)
    prompt = 16
    for rid in range(SERVE_SLOTS):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, model.cfg.vocab_size, prompt).tolist(),
            max_new_tokens=SERVE_TRACE_STEPS + 4, route=names[rid]))
    torch.cuda.synchronize()

    def admission():
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    calls = SERVE_SLOTS * prompt + 1
    adm_ms, adm_names, adm_busy = device_trace(torch, admission)
    say_window(tag, "admission step", adm_names, adm_busy, adm_ms, calls,
               "call", card, top=4)
    eng.step()
    torch.cuda.synchronize()

    def window():
        t0 = time.perf_counter()
        for _ in range(SERVE_TRACE_STEPS):
            if eng.step() != SERVE_SLOTS:
                fail("serving (trace): a slot finished inside the window")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    window_ms, names_ms, busy_ms = device_trace(torch, window)
    if names_ms is None:
        say_window(tag, "decode steps", None, None, window_ms,
                   SERVE_TRACE_STEPS, "step", card)
        return None
    b3_ms = sum(ms for n, (_, ms) in names_ms.items()
                if "frugal_scatter" in n) / SERVE_TRACE_STEPS
    say_window(tag, "decode steps", names_ms, busy_ms, window_ms,
               SERVE_TRACE_STEPS, "step", card, top=8,
               b3_ms_per_flush=f"{b3_ms:.5f}")
    return b3_ms


@contextlib.contextmanager
def config_override(model, **changes):
    """``model`` (and each layer) run under its config with ``changes``
    (a MoE capacity factor with no drops, float32 activations): the same
    weights, nothing copied."""
    old = model.cfg
    cfg = dataclasses.replace(old, **changes)
    mods = [m for m in model.modules() if hasattr(m, "cfg")]
    for m in mods:
        m.cfg = cfg
    try:
        yield model
    finally:
        for m in mods:
            m.cfg = old


def per_use_weight_bytes(model, batch: int) -> int:
    """The weight bytes one decode step reads: every layer's parameters
    once per use (a shared block once at each of its positions), the
    final norm, the LM head, and the ``batch`` embedding rows it gathers
    (the table is not read whole unless it is the tied head)."""
    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())

    table = model.embed["table"]
    head = nbytes(model.embed) if model.cfg.tie_embeddings \
        else nbytes(model.lm_head) + batch * table[0].numel() \
        * table.element_size()
    return sum(nbytes(layer) for layer in model.layers) \
        + nbytes(model.final_norm) + head


def serve_full(torch, arch, expect, n_requests, card, tag, check,
               trace=True):
    """``arch`` at full width (``expect``: its layer count and config
    widths), float32 parameters from a seeded generator on the card,
    ServeEngine(SERVE_SLOTS, SERVE_MAX_LEN) with SERVE_ROUTES routes
    registered, fed ``n_requests`` requests; the checks and numbers of
    phase 13 (b), a traced second engine if ``trace``. The decode path is
    held against forward in the config's activations (within
    SERVE_FORWARD_TOL), or for a MoE config at capacity factor
    MOE_FORWARD_CF in float32 activations (SERVE_FORWARD_TOL), or for a
    recurrent config in float32 activations over a fresh row fed a
    SSM_FORWARD_PROMPT-token prompt (SSM_FORWARD_TOL), with the bf16
    difference reported beside the last two. The byte bound reads each
    layer's weights once per use (``per_use_weight_bytes``) and the
    cache once. Earlier phases' memory is released first
    and the card's free memory checked against the weights. Returns the
    run kernel's launches on the run (one per flush)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.models import build_model
    from repro_torch.roofline import hw_for
    from repro_torch.serve import SLOFleet, ServeEngine

    t_start = time.perf_counter()
    gc.collect()            # earlier engines sit in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    free, total = torch.cuda.mem_get_info()
    need = 4 * cfg.n_params()
    if free < need + MEM_HEADROOM:
        fail(f"{tag} ({check}): {free} bytes free of {total}, {arch}'s "
             f"float32 weights need {need} and {MEM_HEADROOM} to run")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    widths = {k: v for k, v in expect.items() if k != "layers"}
    if len(model.layers) != expect["layers"] \
            or any(getattr(cfg, k) != v for k, v in widths.items()) \
            or next(model.parameters()).dtype != torch.float32:
        fail(f"{tag} ({check}): the model is not {arch} at full width in "
             "float32")
    eng = ServeEngine(model, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    names = [f"route-{i}" for i in range(SERVE_ROUTES)]
    t0 = time.perf_counter()
    eng.slo.ensure_routes(names)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    lanes = eng.slo._cap_routes * eng.slo.n_metrics
    if lanes <= SLOFleet.DENSE_LANES_MAX:
        fail(f"{tag} ({check}): {lanes} lanes take the dense flush branch")
    cache_bytes = sum(c.numel() * c.element_size()
                      for layer in eng.caches for c in layer.values())
    say(tag, check=check, arch=arch, layers=len(model.layers), **widths,
        params=n_params, param_bytes=param_bytes, param_dtype="float32",
        activations=cfg.dtype, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
        cache_keys=",".join(sorted(eng.caches[-1])),
        kv_cache_bytes=cache_bytes, free_before_bytes=free,
        build_s=f"{build_s:.3f}", routes=SERVE_ROUTES, slo_lanes=lanes,
        register_routes_s=f"{register_s:.3f}")

    rng = np.random.default_rng(SERVE_SEED)
    reqs = serve_traffic(rng, cfg.vocab_size, names, n_requests)
    instrument_engine(torch, eng)
    step_host_ms, admitted = [], []
    gc_ms = collections.Counter()
    gc_t0 = {}

    def gc_timer(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        else:
            gc_ms[info["generation"]] += (time.perf_counter()
                                          - gc_t0.pop("t")) * 1e3

    gc.callbacks.append(gc_timer)
    fk.scatter_launch_count = 0
    t_run = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    while eng.queue or any(r is not None for r in eng.slot_req):
        queued = len(eng.queue)
        t0 = time.perf_counter()
        eng.step()
        step_host_ms.append((time.perf_counter() - t0) * 1e3)
        admitted.append(len(eng.queue) != queued)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = fk.scatter_launch_count
    gc.callbacks.remove(gc_timer)
    peak = torch.cuda.max_memory_allocated()

    done = sorted(eng.done, key=lambda r: r.rid)
    if [r.rid for r in done] != list(range(n_requests)):
        fail(f"{tag} ({check}): served {[r.rid for r in done]}")
    for r in done:
        if len(r.output) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            fail(f"{tag} ({check}): request {r.rid} got {len(r.output)} "
                 f"tokens of {r.max_new_tokens}")
    flushes = len(eng.flush_at)
    if launches == 0 or launches != flushes \
            or flushes != len(step_host_ms):
        fail(f"{tag} ({check}): {launches} run kernel launches for "
             f"{flushes} flushes with events in {len(step_host_ms)} steps")

    decode_ms = [a.elapsed_time(b) for a, b in eng.decode_events]
    flush_ms = [a.elapsed_time(b) for a, b in eng.flush_events]
    pure = [ms for ms, adm in zip(step_host_ms, admitted) if not adm]
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in done]
    tokens = sum(len(r.output) for r in done)
    hw = hw_for("gpu-h100")
    weight_bytes = per_use_weight_bytes(model, SERVE_SLOTS)
    bound_ms = (weight_bytes + cache_bytes) / hw.hbm_bw * 1e3
    step_ms = statistics.median(decode_ms)
    say(tag, check=check, served=len(done), tokens=tokens,
        prompt_tokens=sum(len(r.prompt) for r in done), steps=len(
            step_host_ms), steps_with_admission=sum(admitted),
        run_s=f"{run_s:.3f}", decode_tokens_per_s=f"{tokens / run_s:.2f}",
        ttft_ms_p50=f"{pct(ttft, 50):.2f}", ttft_ms_p99=f"{pct(ttft, 99):.2f}",
        card=card)
    say(tag, check=check, step_decode_ms_device_median=f"{step_ms:.4f}",
        step_decode_ms_device_p10_p90=f"{pct(decode_ms, 10):.4f},"
        f"{pct(decode_ms, 90):.4f}",
        engine_dt_ms_median=f"{statistics.median(eng.dispatch_ms):.4f}",
        step_host_ms_median_no_admission=f"{statistics.median(pure):.4f}"
        if pure else "null",
        prefill_call_host_ms_p10_p50_p90=",".join(
            f"{pct(eng.prefill_host_ms, q):.4f}" for q in (10, 50, 90)),
        prefill_calls=len(eng.prefill_host_ms),
        gc_ms_by_generation=json.dumps(dict(sorted(gc_ms.items()))),
        note="device: CUDA events around the step's decode call; engine "
             "dt_ms: the engine's host clock (dispatch, no sync); host: "
             "perf_counter around eng.step() (decode, logits copy, flush)")
    say(tag, check=check, step_bytes=weight_bytes + cache_bytes,
        step_weight_bytes=weight_bytes, step_bound_ms=f"{bound_ms:.4f}",
        step_bound_share=f"{bound_ms / step_ms:.4f}",
        bound_note=f"float32 weights once per use, embedding rows "
                   f"gathered + cache read once over the gpu-h100 "
                   f"HwSpec's {hw.hbm_bw / 1e12:.2f} TB/s",
        max_memory_allocated_bytes=peak, card=card)
    serve_replay_on_cpu(torch, eng, names)
    say(tag, check=check, b3_launches=launches, flushes=flushes,
        flush_device_ms_median=f"{statistics.median(flush_ms):.4f}",
        flush_host_ms_median=f"{statistics.median(eng.flush_host_ms):.4f}",
        slo_state="all planes and clocks bit-identical to a CPU SLOFleet "
                  "replaying the engine's observations and flushes",
        note="flush device ms: CUDA events around SLOFleet.flush (event "
             "copies and one B3 launch)")
    moe = bool(cfg.moe_experts)
    recurrent = cfg.family in ("ssm", "hybrid")
    tol = SSM_FORWARD_TOL if recurrent else SERVE_FORWARD_TOL
    if moe or recurrent:
        # In bf16 the two paths round differently (and flip near-tied
        # router choices, a whole expert's output for a token): the bf16
        # difference is reported, the float32 one held to the bound. A
        # recurrent model's fresh row is fed a prompt of its own.
        req = done[0]
        over = dict(capacity_factor=MOE_FORWARD_CF) if moe else {}
        if recurrent:
            req = dataclasses.replace(req, prompt=rng.integers(
                0, cfg.vocab_size, SSM_FORWARD_PROMPT).tolist(), output=[0])
        with config_override(model, **over):
            _, bf16_err, bf16_scale, bf16_top = serve_forward_check(
                torch, model, req, tol=None)
        with config_override(model, dtype="float32", **over):
            n_seq, err, scale, same_top = serve_forward_check(
                torch, model, req, tol=tol)
        say(tag, check=check, forward_vs_decode_bf16_max_abs_err=f"{bf16_err:.4e}",
            bf16_max_abs_logit=f"{bf16_scale:.4f}",
            bf16_share_of_max_logit=f"{bf16_err / bf16_scale:.4f}",
            bf16_same_argmax=bf16_top, note="information, not checked")
    else:
        n_seq, err, scale, same_top = serve_forward_check(
            torch, model, done[0], tol=tol)
    say(tag, check=check, forward_vs_decode_tokens=n_seq,
        activations="float32" if moe or recurrent else cfg.dtype,
        max_abs_err=f"{err:.4e}", max_abs_logit=f"{scale:.4f}",
        share_of_max_logit=f"{err / scale:.4e}",
        tolerance=f"{tol} x max|logit|",
        forward_capacity_factor=MOE_FORWARD_CF if moe else "null",
        same_argmax=same_top)
    b3_trace_ms = serve_trace(torch, model, names, rng, card, tag) \
        if trace else None
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    say(tag, check=check, part_s=f"{time.perf_counter() - t_start:.1f}",
        b3_ms_per_flush_traced="null" if b3_trace_ms is None
        else f"{b3_trace_ms:.5f}", card=card)
    return launches


def phase_serving(torch, gm, card):
    """Phase 13: (a) the golden engine; (b) yi-6b at full width with
    random weights from a seeded generator, fed SERVE_REQUESTS requests
    over 10^6 registered routes. Returns the run kernel's launches on the
    main path (one per flush)."""
    phase_t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        fail("serving: TF32 matmuls are on; the float32 golden check "
             "needs them off")
    serve_golden(torch, gm)
    launches = serve_full(torch, "yi-6b", SERVE_FULL, SERVE_REQUESTS, card,
                          "serve", "b")
    say("serve", phase_s=f"{time.perf_counter() - phase_t0:.1f}", card=card)
    return launches


# --------------------------------------------------------------- phase 14
TRAIN_ARCH = "qwen2-vl-2b"
TRAIN_SEED = 0           # torch seed of the weights, key and corpus seed
TRAIN_BATCH, TRAIN_SEQ = 8, 64
TRAIN_LR = (1e-3, 10, 30)            # launch/train.py's warmup_cosine
TRAIN_STEPS = 30
TRAIN_TRACE_STEPS = 2
# The golden entry on the card: the step-1 loss and gradients at the CPU
# tests' tolerances, the later losses (and the restored checkpoint's) at
# TRAIN_LATER_LOSS_REL, chosen before the first card run.
TRAIN_LOSS_REL, TRAIN_GRAD_TOL, TRAIN_LATER_LOSS_REL = 1e-5, 1e-4, 1e-4
# float32 matmuls outside the tensor cores (TF32 stays off): NVIDIA's
# H100 SXM data sheet, dense.
H100_F32_FLOPS = 67e12
LAUNCH_ARGS = ["--arch", "yi-6b", "--steps", "60", "--batch", "4", "--seq",
               "32", "--ckpt-every", "10"]
LAUNCH_TIMEOUT_S = 300


def train_golden(torch, gm, card):
    """(a) The golden file's narrowed float32 yi-6b: the JAX TrainState
    carried across onto the card, 8 port steps on the golden batches, the
    step-1 loss and gradients and the later losses against the JAX
    package's; the quantile clip and both monitor fleets fed the golden
    block norms and stats, bit for bit; the committed JAX TrainState
    checkpoint (step 4) restored on the card and continued to step 8."""
    import numpy as np
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.frugal import Frugal2UState
    from repro_torch.models.convert import (flat_from_tree,
                                            train_state_from_numpy)
    from repro_torch.monitor import registry as mon
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.optim.clipping import (QuantileClipState,
                                            quantile_clip_scales)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    data = np.load(GOLDEN)
    cfg = gm.serve_config(reduce_for_smoke(get_config(gm.SERVE_ARCH)))
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*gm.TRAIN_LR))
    init = train_state_from_numpy(cfg, gm.train_state_tree(data),
                                  device="cuda")
    if init.params.device.type != "cuda":
        fail(f"training (a): the carried state is on {init.params.device}")
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in gm.train_batches(data)]
    want = data["train/loss"]
    loss, _ = init.params.loss(batches[0])
    loss.backward()
    loss1 = float(loss.detach())
    if not abs(loss1 - want[0]) <= TRAIN_LOSS_REL * abs(want[0]):
        fail(f"training (a): step-1 loss {loss1} != the JAX package's "
             f"{want[0]}")
    jg = flat_from_tree(cfg, gm.unflatten_params(data, "train/grads1"))
    grad_err = 0.0
    for name, p in init.params.named_parameters():
        scale = float(np.abs(jg[name]).max())
        err = float(np.abs(p.grad.cpu().numpy() - jg[name]).max())
        grad_err = max(grad_err, err / scale)
        if not err <= TRAIN_GRAD_TOL * scale:
            fail(f"training (a): step-1 gradient of {name} differs by {err}"
                 f" (max |g| {scale})")
    init.params.zero_grad(set_to_none=True)
    step = make_train_step(init.params, opt)
    st, losses = init, []
    for b in batches:
        st, met = step(st, b)
        losses.append(float(met["loss"]))
    rel = np.abs(np.asarray(losses) - want) / np.abs(want)
    if not rel.max() <= TRAIN_LATER_LOSS_REL:
        fail(f"training (a): losses {losses} differ from the JAX package's "
             f"{want.tolist()} by {rel.max()} relative")
    if st.step != gm.TRAIN_STEPS or st.qclip.warmup != gm.TRAIN_STEPS:
        fail("training (a): step or warmup count is off")

    qclip = QuantileClipState(
        Frugal2UState(*(torch.from_numpy(data[f"train/init/qclip/{f}"])
                        .cuda() for f in ("m", "step", "sign"))), 0)
    fleets = mon.init_train_monitors(init.params)
    for i in range(gm.TRAIN_STEPS):
        _, qclip = quantile_clip_scales(
            torch.from_numpy(data["train/block_norms"][i]).cuda(), qclip,
            data["train/clip_key"][i])
        for f in ("m", "step", "sign"):
            if not same_bits(torch, getattr(qclip.sketch, f).cpu(),
                             torch.from_numpy(data[f"train/clip_{f}"][i])):
                fail(f"training (a): clip sketch {f} differs at step {i}")
        stats = {"stack": [{k: torch.from_numpy(
            data[f"train/stats_{k}"][i]).cuda() for k in ("absmax", "rms")}]}
        fleets = mon.update_train_monitors(fleets, stats)
        for name in gm.TRAIN_MONITORS:
            fl = getattr(fleets, name)
            if fl.device.type != "cuda":
                fail(f"training (a): monitor {name} runs on {fl.device}")
            for f in ("m", "step", "sign"):
                if not same_bits(torch, getattr(fl.state, f).cpu(),
                                 torch.from_numpy(
                                     data[f"train/{name}/{f}"][i])):
                    fail(f"training (a): monitor {name} {f} differs at "
                         f"step {i}")
            if [int(x) for x in fl.cursor] != \
                    data[f"train/{name}/cursor"][i].tolist():
                fail(f"training (a): monitor {name} cursor differs")

    with tempfile.TemporaryDirectory() as tmp:
        src = shutil.copytree(Path(gm.CKPT_ROOT) / "train",
                              Path(tmp) / "train")
        like = train_state_from_numpy(cfg, gm.train_state_tree(data),
                                      device="cuda")
        resumed, at = ckpt.restore_train_state(str(src), like)
        cont = make_train_step(resumed.params, opt)
        later = []
        for b in batches[at:]:
            resumed, met = cont(resumed, b)
            later.append(float(met["loss"]))
    rel_r = np.abs(np.asarray(later) - want[at:]) / np.abs(want[at:])
    if at != gm.TRAIN_CKPT_STEP or not rel_r.max() <= TRAIN_LATER_LOSS_REL:
        fail(f"training (a): the restored checkpoint (step {at}) continued "
             f"to {later}, the JAX package's {want[at:].tolist()}")
    say("train", check="a", arch=f"{gm.SERVE_ARCH} narrowed (d_model "
        f"{cfg.d_model}, {cfg.num_layers} layers, float32)",
        steps=gm.TRAIN_STEPS, step1_loss_rel_err=f"{abs(loss1 - want[0]) / abs(want[0]):.3e}",
        step1_grad_err_over_max_g=f"{grad_err:.3e}",
        loss_max_rel_err=f"{rel.max():.3e}",
        restored_step=at, continued_loss_max_rel_err=f"{rel_r.max():.3e}",
        clip_and_monitors="bit-identical to the JAX package's on its norms "
                          "and stats", phase_s=f"{time.perf_counter() - t0:.1f}",
        card=card)


def train_activity_kind(name: str) -> str:
    """A traced device activity's kind, from its kernel name."""
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "cublas")):
        return "matmul"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "softmax" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def train_bound(model, cfg, tokens, tokens_of=None):
    """(bytes, operations, bound ms, which term, bytes ms, operations ms)
    of one AdamW training step: the step's inputs and outputs moved once
    (float32 params and both moments read and written, 24 B a
    parameter), and 6 x tokens x the matmul parameters a token uses (no
    embedding or position gather, no norms; a MoE layer's experts at
    top-k of E): bf16 at the gpu-h100 HwSpec's peak, the float32 LM head
    (TF32 off; the embedding when tied) at H100_F32_FLOPS. A matmul
    parameter sees ``tokens_of(name)`` tokens where that is given (an
    encoder's frames), else ``tokens``."""
    from repro_torch.roofline import hw_for

    hw = hw_for("gpu-h100")
    head_name = "embed" if cfg.tie_embeddings else "lm_head"
    n = ops_bf16 = ops_f32 = 0
    for name, p in model.named_parameters():
        n += p.numel()
        if name.startswith(head_name):
            ops_f32 += 6 * p.numel() * tokens
        elif not (name.startswith(("embed", "pos", "dec_pos"))
                  or "norm" in name):
            used = p.numel() * cfg.moe_topk // cfg.moe_experts \
                if ".moe.w_" in name else p.numel()
            ops_bf16 += 6 * used * (tokens_of(name) if tokens_of else tokens)
    bytes_ms = 24 * n / hw.hbm_bw * 1e3
    ops_ms = (ops_bf16 / hw.peak_flops + ops_f32 / H100_F32_FLOPS) * 1e3
    return 24 * n, ops_bf16 + ops_f32, max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms


def train_at_width(torch, card, tag, part, arch, cfg, steps, lr, model_ok, *,
                   need=0, batches=None, tokens_of=None, trace_steps=0,
                   checks=None, **fields):
    """Train ``cfg`` on the card as launch/train.py does, after the earlier
    phases' memory is released and ``need`` bytes (and MEM_HEADROOM) are
    found free: float32 parameters from a generator seeded with
    TRAIN_SEED, AdamW under warmup_cosine(*lr), the quantile clip and the
    monitors on, SyntheticCorpus batches of TRAIN_BATCH x TRAIN_SEQ (each
    passed through ``batches`` where given: launch.train.with_frames),
    Trainer.run for ``steps`` steps with CUDA events around each step
    call. Fails unless ``model_ok(model)`` holds (``arch`` at full width
    in float32), the run took ``steps`` steps with finite losses and grad
    norms, the loss fell (the mean of the last five below that of the
    first five), the clip's warmup counted every step, and every
    activation monitor's estimate is positive, one group a (decoder)
    layer. ``checks(run)`` checks the finished run further (a namespace:
    model, cfg, state, hist) and returns fields for the last line. Prints
    ``fields``, ms per step
    (the host clock after step 5, and events), tokens/s, peak memory,
    train_bound and its share, and the losses; then traces
    ``trace_steps`` more steps. Result lines start with ``tag`` and
    check ``part``."""
    import numpy as np
    from repro_torch.core import rng as crng
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import build_model
    from repro_torch.monitor.registry import monitor_summary
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    gc.collect()            # earlier phases' engines sit in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    if free < need + MEM_HEADROOM:
        fail(f"{tag} ({part}): {free} bytes free of {total}, training needs "
             f"about {need} and {MEM_HEADROOM} to run")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TRAIN_SEED)
    model = build_model(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    if not model_ok(model) \
            or next(model.parameters()).dtype != torch.float32:
        fail(f"{tag} ({part}): the model ({n_params} parameters) is not "
             f"{arch} in float32")
    batches = batches or (lambda it: it)
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*lr))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        batch_size=TRAIN_BATCH,
                                        seed=TRAIN_SEED))
    example = next(batches(corpus.iterate(prefetch=0, device="cuda")))
    state = create_train_state(model, opt, crng.prng_key(TRAIN_SEED),
                               example_batch=example)
    step_fn = make_train_step(model, opt)
    events = []

    def timed_step(st, batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step_fn(st, batch)
        b.record()
        events.append((a, b))
        return out

    it = batches(corpus.iterate(device="cuda"))
    trainer = Trainer(model, opt, timed_step, it, log_every=10,
                      log_fn=lambda line: None)
    t_run = time.perf_counter()
    state = trainer.run(state, steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.metrics_history
    losses = [m["loss"] for m in hist]
    if len(hist) != steps or state.step != steps:
        fail(f"{tag} ({part}): {len(hist)} steps, state at {state.step}")
    if not all(np.isfinite(losses)) or not all(
            np.isfinite(m["grad_norm"]) for m in hist):
        fail(f"{tag} ({part}): non-finite loss or grad norm: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5:
        fail(f"{tag} ({part}): the loss did not fall ({first5} -> {last5})")
    summ = {k: v for k, v in monitor_summary(state.monitors).items()
            if k.startswith("act_")}
    mon_min = min(float(v.min()) for v in summ.values())
    groups = cfg.dec_layers if cfg.is_encdec else cfg.num_layers
    if state.qclip.warmup != steps or not mon_min > 0 \
            or state.monitors.n_act_groups != groups \
            or any(v.shape != (groups,) for v in summ.values()):
        fail(f"{tag} ({part}): clip warmup {state.qclip.warmup}, "
             f"activation monitors {summ}")
    run = types.SimpleNamespace(model=model, cfg=cfg, state=state, hist=hist)
    extra = checks(run) if checks else {}
    host_ms = [m["step_time_s"] * 1e3 for m in hist]
    dev_ms = [a.elapsed_time(b) for a, b in events]
    steady = host_ms[5:]
    step_ms = statistics.median(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    nbytes, nops, bound_ms, bound_by, bytes_ms, ops_ms = train_bound(
        model, cfg, tokens, tokens_of)
    say(tag, check=part, arch=arch, **fields, params=n_params,
        param_dtype="float32", activations=cfg.dtype, optimizer="adamw",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=steps, run_s=f"{run_s:.3f}",
        free_before_bytes=free, card=card)
    say(tag, check=part, **{
        f"step_ms_host_median_steps_6_{steps}": f"{step_ms:.3f}",
        "step_ms_host_p10_p90": f"{pct(steady, 10):.3f},"
                                f"{pct(steady, 90):.3f}",
        "step_ms_host_first": f"{host_ms[0]:.3f}",
        f"step_ms_device_median_steps_6_{steps}":
            f"{statistics.median(dev_ms[5:]):.3f}"},
        tokens_per_s=f"{tokens / step_ms * 1e3:.1f}",
        max_memory_allocated_bytes=peak, held_before_bytes=held,
        peak_of_training_bytes=peak - held,
        note="host: the trainer's clock around the step, which ends in the "
             "metrics' host copy; device: CUDA events around the step call; "
             "memory: the peak less what was allocated before the model")
    say(tag, check=part, step_bytes=nbytes, step_operations=nops,
        bytes_bound_ms=f"{bytes_ms:.3f}", operations_bound_ms=f"{ops_ms:.3f}",
        step_bound_ms=f"{bound_ms:.3f}", bound_by=bound_by,
        step_bound_share=f"{bound_ms / step_ms:.4f}",
        bound_note="train_bound: 24 B a parameter (params and moments in and "
                   "out) over 3.35 TB/s; 6 x tokens x matmul parameters, "
                   "bf16 at 989 TFLOP/s, the float32 LM head at 67")
    say(tag, check=part, first_loss=f"{losses[0]:.4f}",
        last_loss=f"{losses[-1]:.4f}", mean_first5=f"{first5:.4f}",
        mean_last5=f"{last5:.4f}", qclip_warmup=state.qclip.warmup,
        clip_groups=int(state.qclip.sketch.m.shape[0]),
        grad_norm_first_last=f"{hist[0]['grad_norm']:.4f},"
                             f"{hist[-1]['grad_norm']:.4f}",
        act_groups=state.monitors.n_act_groups,
        monitors_min_estimate=f"{mon_min:.5f}", **extra,
        stragglers=sum(m["straggler"] for m in hist),
        step_time_q99_ms=f"{trainer.step_monitor.q99_ms:.3f}")

    def window():
        nonlocal state
        for _ in range(trace_steps):
            state, met = step_fn(state, next(it))
            float(met["loss"])

    if trace_steps:
        window_ms, names, busy_ms = device_trace(
            torch, lambda: timed(torch, window)[1])
        say_window(tag, "train steps", names, busy_ms, window_ms,
                   trace_steps, "step", card, top=10)
        if names is not None:
            kinds = collections.Counter()
            for name, (_, ms) in names.items():
                kinds[train_activity_kind(name)] += ms / trace_steps
            say(tag, check="trace", ms_per_step_by_kind=json.dumps(
                {k: round(v, 4) for k, v in kinds.most_common()}),
                note="matmul: gemm kernels; copy: casts and copies; "
                     "elementwise: the rest of the pointwise kernels "
                     "(AdamW, the clip, activations); reduce: reductions")
    del run, state, model, trainer, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    say(tag, check=part, part_s=f"{time.perf_counter() - t0:.1f}")


def train_full(torch, card):
    """(b) qwen2-vl-2b at full width through train_at_width for
    TRAIN_STEPS steps (the clip's estimates moved off their start), then
    a traced window of TRAIN_TRACE_STEPS more steps."""
    import numpy as np
    from repro_torch.configs import get_config

    def model_ok(model):
        cfg = model.cfg
        return (len(model.layers), cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size, cfg.pos_type,
                cfg.tie_embeddings) == \
            (28, 1536, 12, 2, 8960, 151936, "mrope", True)

    def checks(run):
        m_clip = run.state.qclip.sketch.m.cpu().numpy()
        if not np.any(np.abs(m_clip - 1.0) > 1e-3):
            fail(f"training (b): the clip did not engage (m "
                 f"{m_clip.tolist()})")
        return {"qclip_m": ",".join(f"{x:.4f}" for x in m_clip),
                "clip_blocks": "embed,final_norm,prefix,stack"}

    cfg = get_config(TRAIN_ARCH)
    train_at_width(torch, card, "train", "b", f"{TRAIN_ARCH} full width",
                   cfg, TRAIN_STEPS, TRAIN_LR, model_ok, checks=checks,
                   trace_steps=TRAIN_TRACE_STEPS, layers=cfg.num_layers,
                   d_model=cfg.d_model,
                   heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
                   d_ff=cfg.d_ff, vocab=cfg.vocab_size)


def train_launcher(card):
    """(c) launch/train.py on the card (its default device): the reduced
    yi-6b killed at step 30 (exit 42, latest committed step 30), then
    restarted: "resumed from step 30", finished at 60."""
    from repro_torch.train import checkpoint as ckpt

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        args = [sys.executable, "-m", "repro_torch.launch.train",
                *LAUNCH_ARGS, "--ckpt-dir", tmp]
        r1 = subprocess.run(args + ["--die-at-step", "30"], env=env,
                            capture_output=True, text=True,
                            timeout=LAUNCH_TIMEOUT_S)
        if r1.returncode != 42 or ckpt.latest_step(tmp) != 30:
            fail(f"training (c): the killed run exited {r1.returncode} with "
                 f"latest step {ckpt.latest_step(tmp)}: {r1.stderr[-800:]}")
        r2 = subprocess.run(args, env=env, capture_output=True, text=True,
                            timeout=LAUNCH_TIMEOUT_S)
        if r2.returncode != 0:
            fail(f"training (c): the restart exited {r2.returncode}: "
                 f"{r2.stderr[-800:]}")
        out = json.loads(r2.stdout.strip().splitlines()[-1])
        if "resumed from step 30" not in r2.stdout + r2.stderr \
                or out["final_step"] != 60 or ckpt.latest_step(tmp) != 60 \
                or not out["device"].startswith("cuda"):
            fail(f"training (c): the restart did not resume at 30 and "
                 f"finish 60 on the card: {out}")
    say("train", check="c", killed_exit=r1.returncode, latest_step_after_kill=30,
        resumed_from=30, final_step=out["final_step"],
        device=out["device"], restart_first_loss=f"{out['first_loss']:.4f}",
        restart_last_loss=f"{out['last_loss']:.4f}",
        wall_s=f"{time.perf_counter() - t0:.1f}", card=card)


def phase_training(torch, gm, card):
    """Phase 14: (a) the golden training entry, (b) qwen2-vl-2b at full
    width for TRAIN_STEPS steps, (c) the launcher's kill and restart. The
    path launches none of the port's kernels."""
    from repro_torch.kernels import frugal_update as fk

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        fail("training: TF32 matmuls are on; the float32 golden check "
             "needs them off")
    launches = (fk.launch_count, fk.scatter_launch_count)
    train_golden(torch, gm, card)
    train_full(torch, card)
    train_launcher(card)
    if (fk.launch_count, fk.scatter_launch_count) != launches:
        fail("training: the path launched a frugal kernel")
    say("train", phase_s=f"{time.perf_counter() - t0:.1f}", card=card)


# --------------------------------------------------------------- phase 15
MOE_SERVE = (("deepseek-v2-lite-16b", "b", 16), ("olmoe-1b-7b", "c", 4))
MOE_FULL = {
    "deepseek-v2-lite-16b": {
        "layers": 27, "d_model": 2048, "num_heads": 16, "kv_lora_rank": 512,
        "qk_nope_dim": 128, "qk_rope_dim": 64, "v_head_dim": 128,
        "moe_experts": 64, "moe_topk": 6, "moe_shared_experts": 2,
        "moe_d_ff": 1408, "moe_first_dense": 1, "first_dense_d_ff": 10944,
        "vocab_size": 102400},
    "olmoe-1b-7b": {
        "layers": 16, "d_model": 2048, "num_heads": 16, "num_kv_heads": 16,
        "head_dim": 128, "moe_experts": 64, "moe_topk": 8, "moe_d_ff": 1024,
        "vocab_size": 50304}}
# The decode path against forward at a capacity factor where no token
# drops, as tests/test_arch_smoke.py holds the JAX package: one-token
# decode never drops, a batched forward at 1.25 does.
MOE_FORWARD_CF = 16.0
MOE_GOLDEN_LOSS_REL = 1e-4          # phase 14's bound on later losses
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = "olmoe-1b-7b", 4, 20
MOE_TRAIN_LR = (1e-3, 10, MOE_TRAIN_STEPS)   # launch/train.py's schedule


def moe_golden(torch, gm, card):
    """(a) The golden file's narrowed olmoe and deepseek (the JAX
    package's TrainStates) on the card: a forward's expert loads and drop
    fractions bit for bit (the routing), the engine under the fake clock
    (tokens, first step logits within SERVE_GOLDEN_LOGIT_TOL, summary and
    SLO state bit for bit), then gm.MOE_TRAIN_STEPS train steps (losses
    within MOE_GOLDEN_LOSS_REL, the expert-load fleet bit for bit)."""
    import numpy as np
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import make_train_step

    data = np.load(GOLDEN)
    for arch in gm.MOE_ARCHS:
        t0 = time.perf_counter()
        key = f"moe/{arch}"
        cfg = gm.moe_config(reduce_for_smoke(get_config(arch)))
        st = train_state_from_numpy(cfg, gm.train_state_tree(
            data, f"{key}/init"), device="cuda")
        if st.params.device.type != "cuda" \
                or st.monitors.n_moe_groups != 2 * cfg.moe_experts:
            fail(f"moe (a): {arch} carried to {st.params.device} with "
                 f"{st.monitors.n_moe_groups} expert-load lanes")
        batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                   for b in gm.moe_train_batches(data, arch)]
        with torch.no_grad():
            _, stats = st.params(batches[0]["tokens"])
        for name in ("expert_load", "drop_fraction"):
            if not same_bits(torch, stats["stack"][0][name].cpu(),
                             torch.from_numpy(data[f"{key}/route/{name}"])):
                fail(f"moe (a): {arch}'s {name} differs from the JAX "
                     "package's: the routing differs")
        err = golden_engine(torch, gm, st.params, data, f"{key}/",
                            f"moe (a): {arch}")
        step = make_train_step(st.params, Optimizer(
            kind="adamw", lr_fn=warmup_cosine(*gm.TRAIN_LR)))
        want = data[f"{key}/train/loss"]
        rel = []
        for i, b in enumerate(batches):
            st, met = step(st, b)
            rel.append(abs(float(met["loss"]) - want[i]) / abs(want[i]))
            fleet = st.monitors.expert_load_q99
            if fleet.device.type != "cuda":
                fail(f"moe (a): the expert-load fleet runs on {fleet.device}")
            for f in ("m", "step", "sign"):
                if not same_bits(torch, getattr(fleet.state, f).cpu(),
                                 torch.from_numpy(
                                     data[f"{key}/train/{f}"][i])):
                    fail(f"moe (a): {arch}'s expert-load fleet {f} differs "
                         f"at step {i}")
            if [int(x) for x in fleet.cursor] != \
                    data[f"{key}/train/cursor"][i].tolist():
                fail(f"moe (a): {arch}'s expert-load cursor differs")
        if not max(rel) <= MOE_GOLDEN_LOSS_REL:
            fail(f"moe (a): {arch}'s losses differ from the JAX package's by "
                 f"{max(rel)} relative")
        say("moe", check="a", arch=f"{arch} narrowed (d_model {cfg.d_model},"
            f" {cfg.num_layers} layers, {cfg.moe_experts} experts top "
            f"{cfg.moe_topk}, float32)", routing="bit-identical",
            tokens=int(data[f"{key}/serve/output_lengths"].sum()),
            tokens_equal=True, first_step_logits_max_abs_err=f"{err:.3e}",
            summary_and_slo_state="bit-identical to the JAX engine's",
            train_steps=len(batches), loss_max_rel_err=f"{max(rel):.3e}",
            expert_load_fleet=f"{fleet.num_groups} lanes bit-identical "
                              "after every step",
            part_s=f"{time.perf_counter() - t0:.1f}", card=card)


def moe_train(torch, card):
    """(d) olmoe at full width with its depth cut to MOE_TRAIN_LAYERS
    layers (all 16 with AdamW would need 110.7 GB) through train_at_width
    for MOE_TRAIN_STEPS steps: besides its checks, the aux loss positive,
    the expert-load fleet's MOE_TRAIN_LAYERS x 64 lanes bit-identical to
    a CPU fleet replaying the loads each step fed it (recorded on the
    host), its q99s in [0, 1], load_imbalance. An expert that no token
    chose in any step (a dead expert of a random router) keeps q99 0."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.monitor import load_imbalance, monitor_summary
    from repro_torch.monitor import registry
    from repro_torch.train import steps as steps_mod

    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                              num_layers=MOE_TRAIN_LAYERS)
    lanes = MOE_TRAIN_LAYERS * cfg.moe_experts
    widths = {k: v for k, v in MOE_FULL[MOE_TRAIN_ARCH].items()
              if k != "layers"}
    fed, update = [], steps_mod.update_train_monitors

    def update_recorded(mon, stats):
        fed.append(registry._flatten_stats(stats)[2].cpu())
        return update(mon, stats)

    def checks(run):
        mon = run.state.monitors
        if mon.n_moe_groups != lanes \
                or mon.expert_load_q99.num_groups != lanes:
            fail(f"moe (d): {mon.n_moe_groups} expert-load groups, "
                 f"expected {lanes}")
        aux = [m["aux_loss"] for m in run.hist]
        if not all(a > 0 for a in aux):
            fail(f"moe (d): aux losses {aux}")
        plain = registry.make_fleet(lanes, 0.99, registry.SEED_MOE,
                                    device="cpu")
        for loads in fed:
            plain = plain.tick_lanes(loads)
        if len(fed) != MOE_TRAIN_STEPS or not all(
                same_bits(torch, getattr(mon.expert_load_q99.state, f).cpu(),
                          getattr(plain.state, f))
                for f in ("m", "step", "sign")):
            fail(f"moe (d): the expert-load fleet differs from a CPU fleet "
                 f"fed the {len(fed)} recorded steps' loads")
        q99 = monitor_summary(mon)["expert_load_q99"]
        imbalance = float(load_imbalance(q99, cfg.moe_experts))
        q99 = q99.cpu().numpy()
        if q99.shape != (lanes,) or not (np.all((q99 >= 0) & (q99 <= 1))
                                         and q99.max() > 0) \
                or not (np.isfinite(imbalance) and imbalance >= 1.0):
            fail(f"moe (d): expert-load q99s {q99.tolist()}, imbalance "
                 f"{imbalance}")
        return {"aux_loss_first_last": f"{aux[0]:.5f},{aux[-1]:.5f}",
                "expert_load_lanes": lanes,
                "expert_load_fleet": "bit-identical to a CPU fleet "
                                     "replaying the recorded loads",
                "expert_load_q99_min_max": f"{q99.min():.5f},{q99.max():.5f}",
                "lanes_q99_zero": int((q99 == 0).sum()),
                "lanes_never_loaded": int((torch.stack(fed) == 0).all(0)
                                          .sum()),
                "load_imbalance": f"{imbalance:.4f}"}

    steps_mod.update_train_monitors = update_recorded
    try:
        train_at_width(
            torch, card, "moe", "d", f"{MOE_TRAIN_ARCH} full width, depth cut",
            cfg, MOE_TRAIN_STEPS, MOE_TRAIN_LR,
            lambda m: len(m.layers) == MOE_TRAIN_LAYERS and all(
                getattr(cfg, k) == v for k, v in widths.items()),
            checks=checks, layers=MOE_TRAIN_LAYERS,
            reduced=f"num_layers 16 -> {MOE_TRAIN_LAYERS} (AdamW state of "
                    "all 16: 110.7 GB)")
    finally:
        steps_mod.update_train_monitors = update


def phase_moe(torch, gm, card):
    """Phase 15: (a) the golden MoE and MLA entries; (b) deepseek-v2-lite
    and (c) olmoe at full width through the engine; (d) olmoe's depth cut
    trained. Returns the run kernel's launches on (b) and (c)."""
    from repro_torch.kernels import frugal_update as fk

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        fail("moe: TF32 matmuls are on; the float32 golden check needs "
             "them off")
    moe_golden(torch, gm, card)
    launches = 0
    for arch, check, n in MOE_SERVE:
        launches += serve_full(torch, arch, MOE_FULL[arch], n, card, "moe",
                               check, trace=check == "b")
    counts = (fk.launch_count, fk.scatter_launch_count)
    moe_train(torch, card)
    if (fk.launch_count, fk.scatter_launch_count) != counts:
        fail("moe (d): the training path launched a frugal kernel")
    say("moe", phase_s=f"{time.perf_counter() - t0:.1f}", card=card)
    return launches

# --------------------------------------------------------------- phase 16
SSM_SERVE = (("zamba2-2.7b", "b", SERVE_REQUESTS),
             ("rwkv6-1.6b", "c", SERVE_REQUESTS))
SSM_FULL = {
    "zamba2-2.7b": {
        "layers": 54, "d_model": 2560, "num_heads": 32, "num_kv_heads": 32,
        "head_dim": 80, "d_ff": 10240, "ssm_state": 64, "ssm_headdim": 64,
        "ssm_expand": 2, "ssm_chunk": 128, "conv_kernel": 4,
        "shared_attention": True, "vocab_size": 32000},
    "rwkv6-1.6b": {
        "layers": 24, "d_model": 2048, "rwkv_head_size": 64, "d_ff": 7168,
        "rwkv_factorized": False, "vocab_size": 65536}}
# The fresh row's decode against forward in float32: a prompt past one
# chunk (128), so that forward carries state across chunks and pads the
# last (8 of 128 used), held to this times max |logit|.
SSM_FORWARD_PROMPT = 136
SSM_FORWARD_TOL = 1e-4
# On the card, against the JAX package's CPU run: the later losses at
# phase 14's bound; the activation fleets' m and step planes within this
# times |m| a lane (where the 2U tick set m to the statistic itself),
# their sign planes and cursors bit for bit. Chosen before the first run.
SSM_GOLDEN_STATS_REL = 1e-4
SSM_TRAIN_ARCH, SSM_TRAIN_STEPS = "rwkv6-1.6b", 20
SSM_TRAIN_LR = (1e-3, 10, SSM_TRAIN_STEPS)   # launch/train.py's schedule


def ssm_golden(torch, gm, card):
    """(a) The golden file's narrowed zamba2, rwkv6 and rwkv6 in its H1
    factorized form (the JAX package's TrainStates with every parameter
    redrawn, ssm/* keys) on the card: forward logits over the first
    batch within SERVE_GOLDEN_LOGIT_TOL, the engine under the fake clock
    (tokens, first step logits within SERVE_GOLDEN_LOGIT_TOL, summary and
    SLO state bit for bit), then gm.SSM_TRAIN_STEPS train steps (losses
    within MOE_GOLDEN_LOSS_REL; both activation fleets' sign planes and
    cursors bit for bit, m and step within SSM_GOLDEN_STATS_REL x |m|)."""
    import numpy as np
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import make_train_step

    data = np.load(GOLDEN)
    for name, (arch, factorized) in gm.SSM_MODELS.items():
        t0 = time.perf_counter()
        key = f"ssm/{name}"
        cfg = gm.ssm_config(reduce_for_smoke(get_config(arch)), factorized)
        st = train_state_from_numpy(cfg, gm.train_state_tree(
            data, gm.ssm_init_prefix(name)), device="cuda")
        shared = st.params.shared_block
        if st.params.device.type != "cuda" or (shared is not None) != \
                cfg.shared_attention or (shared is not None and sum(
                    layer is shared for layer in st.params.layers) != 2):
            fail(f"ssm (a): {name} carried to {st.params.device}, shared "
                 "block not one module at its 2 positions")
        batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                   for b in gm.ssm_train_batches(data, name)]
        with torch.no_grad():
            logits, _ = st.params(batches[0]["tokens"])
        fwd_err = float(np.abs(logits.cpu().numpy()
                               - data[f"{key}/forward/logits"]).max())
        if not fwd_err <= SERVE_GOLDEN_LOGIT_TOL:
            fail(f"ssm (a): {name}'s forward logits differ by {fwd_err}")
        err = golden_engine(torch, gm, st.params, data, f"{key}/",
                            f"ssm (a): {name}")
        step = make_train_step(st.params, Optimizer(
            kind="adamw", lr_fn=warmup_cosine(*gm.TRAIN_LR)))
        want = data[f"{key}/train/loss"]
        rel, plane_rel = [], 0.0
        for i, b in enumerate(batches):
            st, met = step(st, b)
            rel.append(abs(float(met["loss"]) - want[i]) / abs(want[i]))
            for mon in gm.TRAIN_MONITORS:
                fleet = getattr(st.monitors, mon)
                pre = f"{key}/train/{mon}"
                scale = np.abs(data[f"{pre}/m"][i])
                for f in ("m", "step"):
                    d = np.abs(getattr(fleet.state, f).cpu().numpy()
                               - data[f"{pre}/{f}"][i])
                    plane_rel = max(plane_rel, float(
                        (d / np.maximum(scale, 1e-30)).max()))
                    if not (d <= SSM_GOLDEN_STATS_REL * scale).all():
                        fail(f"ssm (a): {name}'s {mon} {f} plane differs at "
                             f"step {i} by {d.max()}")
                if not same_bits(torch, fleet.state.sign.cpu(),
                                 torch.from_numpy(data[f"{pre}/sign"][i])) \
                        or [int(x) for x in fleet.cursor] != \
                        data[f"{pre}/cursor"][i].tolist():
                    fail(f"ssm (a): {name}'s {mon} sign or cursor differs "
                         f"at step {i}")
        if not max(rel) <= MOE_GOLDEN_LOSS_REL:
            fail(f"ssm (a): {name}'s losses differ from the JAX package's by "
                 f"{max(rel)} relative")
        say("ssm", check="a", arch=f"{name} narrowed (d_model {cfg.d_model}, "
            f"{cfg.num_layers} layers, float32, every leaf redrawn)",
            forward_logits_max_abs_err=f"{fwd_err:.3e}",
            tokens=int(data[f"{key}/serve/output_lengths"].sum()),
            tokens_equal=True, first_step_logits_max_abs_err=f"{err:.3e}",
            summary_and_slo_state="bit-identical to the JAX engine's",
            train_steps=len(batches), loss_max_rel_err=f"{max(rel):.3e}",
            act_fleets_m_step_max_rel=f"{plane_rel:.3e}",
            act_fleets_sign_cursor="bit-identical",
            part_s=f"{time.perf_counter() - t0:.1f}", card=card)


def ssm_train(torch, card):
    """(d) rwkv6-1.6b at full width through train_at_width for
    SSM_TRAIN_STEPS steps, once the memory it needs is free: parameters,
    gradients and moments, and 24 layers' chunked-WKV decay tensors kept
    for the backward (train_bound does not count the chunked WKV's float32
    einsums)."""
    from repro_torch.configs import get_config

    cfg = get_config(SSM_TRAIN_ARCH)
    # [1, B, H, c, c, n] float32 decay, its exp and the einsum's product
    # kept per layer (c = TRAIN_SEQ, one chunk)
    n = cfg.rwkv_head_size
    decay = 4 * TRAIN_BATCH * (cfg.d_model // n) * TRAIN_SEQ ** 2 * n
    full = SSM_FULL[SSM_TRAIN_ARCH]
    train_at_width(
        torch, card, "ssm", "d", f"{SSM_TRAIN_ARCH} full width", cfg,
        SSM_TRAIN_STEPS, SSM_TRAIN_LR,
        lambda m: len(m.layers) == full["layers"] and all(
            getattr(cfg, k) == v for k, v in full.items() if k != "layers"),
        need=16 * cfg.n_params() + 3 * cfg.num_layers * decay,
        layers=full["layers"], chunk=min(cfg.ssm_chunk, TRAIN_SEQ))


def phase_ssm(torch, gm, card):
    """Phase 16: (a) the golden recurrent entries; (b) zamba2-2.7b and (c)
    rwkv6-1.6b at full width through the engine; (d) rwkv6-1.6b trained
    at full width. Returns the run kernel's launches on (b) and (c)."""
    from repro_torch.kernels import frugal_update as fk

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        fail("ssm: TF32 matmuls are on; the float32 golden check needs "
             "them off")
    ssm_golden(torch, gm, card)
    launches = 0
    for arch, check, n in SSM_SERVE:
        launches += serve_full(torch, arch, SSM_FULL[arch], n, card, "ssm",
                               check)
    counts = (fk.launch_count, fk.scatter_launch_count)
    ssm_train(torch, card)
    if (fk.launch_count, fk.scatter_launch_count) != counts:
        fail("ssm (d): the training path launched a frugal kernel")
    say("ssm", phase_s=f"{time.perf_counter() - t0:.1f}", card=card)
    return launches


# --------------------------------------------------------------- phase 17
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_FULL = {"enc_layers": 32, "dec_layers": 32, "d_model": 1280,
               "num_heads": 20, "num_kv_heads": 20, "head_dim": 64,
               "d_ff": 5120, "vocab_size": 51866, "enc_seq_len": 1500}
# The JAX package's tree at full width (jax.eval_shape of its init):
# enc_stack 629,309,440, dec_stack 839,106,560, embed 66,388,480, dec_pos
# 41,943,040, enc_norm and dec_norm 2,560 each.
ENCDEC_PARAMS = 1_576_752_640
ENCDEC_SEED = 0          # numpy seed of the prompts; torch seed of weights
ENCDEC_BATCHES, ENCDEC_SLOTS = 2, 4      # 8 requests in two batches of 4
ENCDEC_PROMPT, ENCDEC_NEW = 4, 60
# whisper-large-v3's published text context (max_target_positions of the
# openai/whisper-large-v3 config): the self-attention cache's rows.
ENCDEC_MAX_LEN = 448
# A fresh row's float32 decode against forward over this many tokens,
# every position held to ENCDEC_FORWARD_TOL x max |logit|.
ENCDEC_FORWARD_TOKENS = 136
ENCDEC_FORWARD_TOL = 1e-4
ENCDEC_TRACE_CALLS = 8
ENCDEC_TRAIN_STEPS = 20
ENCDEC_TRAIN_LR = (1e-3, 10, ENCDEC_TRAIN_STEPS)   # launch/train.py's


def encdec_golden(torch, gm, card):
    """(a) The golden file's reduced whisper at attention chunks of 16
    (the JAX package's parameters with every leaf redrawn, encdec/* keys)
    on the card: memory, forward logits and the 12 serve_step calls'
    logits within SERVE_GOLDEN_LOGIT_TOL x max |value|, the greedy tokens
    equal, the loss; three train steps from create_train_state (losses and
    grad norms within MOE_GOLDEN_LOSS_REL, the clip's and both activation
    fleets' sign planes and the fleets' cursors bit for bit, m and step
    within SSM_GOLDEN_STATS_REL x |m|)."""
    import numpy as np
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import rng as crng
    from repro_torch.models import params_from_numpy
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import (create_train_state, make_serve_step,
                                   make_train_step)

    t0 = time.perf_counter()
    data = np.load(GOLDEN)
    cfg = gm.encdec_config(reduce_for_smoke(get_config(gm.ENCDEC_ARCH)))
    model = params_from_numpy(cfg, gm.unflatten_params(data, "encdec/params"),
                              device="cuda")
    batch = {k: torch.from_numpy(data[f"encdec/{k}"]).cuda()
             for k in ("frames", "tokens", "targets")}
    errs = {}

    def check(what, got, want):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.float().cpu().numpy() - want).max())
        scale = float(np.abs(want).max())
        errs[what] = max(errs.get(what, 0.0), err / scale)
        if not err <= SERVE_GOLDEN_LOGIT_TOL * scale:
            fail(f"encdec (a): {what} differs from the JAX package's by "
                 f"{err} (max |value| {scale})")

    with torch.no_grad():
        memory = model.encode(batch["frames"])
        logits, _ = model(batch["frames"], batch["tokens"])
        loss, _ = model.loss(batch)
    check("memory", memory, data["encdec/memory"])
    check("forward logits", logits, data["encdec/forward/logits"])
    loss_rel = abs(float(loss) - float(data["encdec/forward/loss"])) \
        / abs(float(data["encdec/forward/loss"]))
    serve = make_serve_step(model, encdec_memory=True)
    caches = model.init_cache(gm.ENCDEC_BATCH, gm.ENCDEC_MAX_LEN)
    tok = torch.from_numpy(data["encdec/serve/start"]).cuda()
    for pos in range(gm.ENCDEC_DECODE_STEPS):
        lg, caches = serve(tok, caches, pos, memory)
        check("serve_step logits", lg[:, 0], data["encdec/serve/logits"][pos])
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        if tok[:, 0].cpu().numpy().tolist() != \
                data["encdec/serve/tokens"][pos].tolist():
            fail(f"encdec (a): greedy tokens differ at call {pos}")
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*gm.TRAIN_LR))
    st = create_train_state(model, opt, crng.prng_key(0),
                            example_batch=batch)
    step = make_train_step(model, opt)
    rel, plane_rel = [], 0.0
    for i in range(gm.ENCDEC_TRAIN_STEPS):
        st, met = step(st, batch)
        for k in ("loss", "grad_norm"):
            want = float(data[f"encdec/train/{k}"][i])
            rel.append(abs(float(met[k]) - want) / abs(want))
        planes = [("qclip_", st.qclip.sketch)] + [
            (f"{mon}/", getattr(st.monitors, mon).state)
            for mon in gm.TRAIN_MONITORS]
        for name, sk in planes:
            pre = f"encdec/train/{name}"
            if not same_bits(torch, sk.sign.cpu(),
                             torch.from_numpy(data[f"{pre}sign"][i])):
                fail(f"encdec (a): {name} sign plane differs at step {i}")
            scale = np.maximum(np.abs(data[f"{pre}m"][i]), 1e-30)
            for f in ("m", "step"):
                d = np.abs(getattr(sk, f).cpu().numpy() - data[f"{pre}{f}"][i])
                plane_rel = max(plane_rel, float((d / scale).max()))
        for mon in gm.TRAIN_MONITORS:
            if [int(x) for x in getattr(st.monitors, mon).cursor] != \
                    data[f"encdec/train/{mon}/cursor"][i].tolist():
                fail(f"encdec (a): {mon} cursor differs at step {i}")
    if not max(rel) <= MOE_GOLDEN_LOSS_REL or loss_rel > MOE_GOLDEN_LOSS_REL \
            or not plane_rel <= SSM_GOLDEN_STATS_REL:
        fail(f"encdec (a): losses / grad norms within {max(rel)}, forward "
             f"loss {loss_rel}, fleet planes {plane_rel} relative")
    say("encdec", check="a", arch=f"{gm.ENCDEC_ARCH} reduced "
        f"({cfg.enc_layers} + {cfg.dec_layers} layers, d_model "
        f"{cfg.d_model}, attn_chunk {cfg.attn_chunk}, {cfg.enc_seq_len} "
        "frames, float32, every leaf redrawn)",
        **{f"{k.replace(' ', '_')}_max_rel_err": f"{v:.3e}"
           for k, v in errs.items()},
        forward_loss_rel_err=f"{loss_rel:.3e}",
        serve_calls=gm.ENCDEC_DECODE_STEPS, greedy_tokens_equal=True,
        train_steps=gm.ENCDEC_TRAIN_STEPS,
        loss_and_grad_norm_max_rel_err=f"{max(rel):.3e}",
        clip_and_fleets_m_step_max_rel=f"{plane_rel:.3e}",
        signs_and_cursors="bit-identical", clip_groups=int(
            st.qclip.sketch.m.shape[0]),
        part_s=f"{time.perf_counter() - t0:.1f}", card=card)


def encdec_decode_bound(model, cfg, batch: int, rows: float):
    """(bytes, bf16 operations, float32 operations, bound ms, which term)
    of one decode call at ``batch`` rows whose self-attention reads
    ``rows`` cache rows: the decoder's float32 weights and norm once, the
    tied head's whole table, ``batch`` position rows, the bf16 memory read
    once by each layer's cross K/V projection, the bf16 cache rows read,
    the logits written; the cross K/V recomputed from memory at every
    call, the other matmuls at ``batch`` tokens and attention's products
    (bf16 at the gpu-h100 HwSpec's peak; the float32 head and attention
    at H100_F32_FLOPS)."""
    from repro_torch.roofline import hw_for

    hw = hw_for("gpu-h100")
    d, s_enc, n_l = cfg.d_model, cfg.enc_seq_len, cfg.dec_layers
    kv = cfg.num_kv_heads * cfg.head_dim
    nbytes = sum(p.numel() * 4 for p in model.dec_stack.parameters()) \
        + sum(p.numel() * 4 for p in model.dec_norm.parameters()) \
        + model.embed["table"].numel() * 4 + batch * d * 4 \
        + n_l * batch * s_enc * d * 2 \
        + n_l * 2 * batch * rows * kv * 2 + batch * cfg.vocab_size * 4
    cross_kv = n_l * 2 * 2 * batch * s_enc * d * kv
    mats = sum(p.numel() for n, p in model.dec_stack.named_parameters()
               if "norm" not in n
               and not n.endswith(("cross.wk", "cross.wv")))
    ops_bf16 = cross_kv + 2 * batch * mats
    hq, hd = cfg.num_heads, cfg.head_dim
    ops_f32 = n_l * 2 * 2 * batch * hq * hd * (s_enc + rows) \
        + 2 * batch * cfg.vocab_size * d
    bytes_ms = nbytes / hw.hbm_bw * 1e3
    ops_ms = (ops_bf16 / hw.peak_flops + ops_f32 / H100_F32_FLOPS) * 1e3
    return nbytes, ops_bf16, ops_f32, max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms


def encdec_serve(torch, card):
    """(b) whisper-large-v3 at full width, float32 parameters from a
    seeded generator, bf16 activations: ENCDEC_BATCHES batches of
    ENCDEC_SLOTS requests, each batch's frames [4, 1500, 1280] from a
    seeded generator encoded once, each request's ENCDEC_PROMPT-token
    prompt fed one token a call, then ENCDEC_NEW greedy tokens, all through
    make_serve_step(model, encdec_memory=True) with a cache of
    ENCDEC_MAX_LEN rows; ms per encode and per decode call (CUDA events),
    tokens/s, peak memory, the call's bound and share, traced windows;
    then a fresh row's float32 decode against forward over
    ENCDEC_FORWARD_TOKENS tokens (every position), the bf16 gap
    reported."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    t_start = time.perf_counter()
    gc.collect()            # earlier engines sit in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ENCDEC_ARCH)
    free, total = torch.cuda.mem_get_info()
    if free < 4 * ENCDEC_PARAMS + MEM_HEADROOM:
        fail(f"encdec (b): {free} bytes free of {total}, the float32 "
             f"weights need {4 * ENCDEC_PARAMS} and {MEM_HEADROOM} to run")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ENCDEC_SEED)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != ENCDEC_PARAMS or (len(model.enc_stack),
                                     len(model.dec_stack)) != (
            ENCDEC_FULL["enc_layers"], ENCDEC_FULL["dec_layers"]) \
            or any(getattr(cfg, k) != v for k, v in ENCDEC_FULL.items()) \
            or next(model.parameters()).dtype != torch.float32:
        fail(f"encdec (b): the model ({n_params} parameters) is not "
             f"{ENCDEC_ARCH} at full width in float32")
    serve = make_serve_step(model, encdec_memory=True)
    rng = np.random.default_rng(ENCDEC_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (ENCDEC_BATCHES, ENCDEC_SLOTS,
                                               ENCDEC_PROMPT))
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(ENCDEC_SEED + 1)
    say("encdec", check="b", arch=ENCDEC_ARCH, **ENCDEC_FULL,
        params=n_params, param_bytes=4 * n_params, param_dtype="float32",
        activations=cfg.dtype, attn_chunk=cfg.attn_chunk,
        requests=ENCDEC_BATCHES * ENCDEC_SLOTS, batch=ENCDEC_SLOTS,
        prompt=ENCDEC_PROMPT, new_tokens=ENCDEC_NEW,
        cache_rows=ENCDEC_MAX_LEN, free_before_bytes=free,
        build_s=f"{build_s:.3f}", card=card)

    def event():
        return torch.cuda.Event(enable_timing=True)

    enc_ev, call_ev, decode_s, outputs = [], [], [], []
    calls = ENCDEC_PROMPT + ENCDEC_NEW - 1
    t_run = time.perf_counter()
    for bi in range(ENCDEC_BATCHES):
        frames = torch.randn((ENCDEC_SLOTS, cfg.enc_seq_len, cfg.d_model),
                             generator=fgen, device="cuda")
        a, b = event(), event()
        a.record()
        with torch.no_grad():
            memory = model.encode(frames)
        b.record()
        enc_ev.append((a, b))
        caches = model.init_cache(ENCDEC_SLOTS, ENCDEC_MAX_LEN)
        prompt = torch.from_numpy(prompts[bi]).to(torch.int32).cuda()
        torch.cuda.synchronize()
        t_dec = time.perf_counter()
        new, nxt = [], None
        for pos in range(calls):
            tok = prompt[:, pos:pos + 1] if pos < ENCDEC_PROMPT else nxt
            a, b = event(), event()
            a.record()
            logits, caches = serve(tok, caches, pos, memory)
            b.record()
            call_ev.append((a, b))
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            if pos >= ENCDEC_PROMPT - 1:
                new.append(nxt)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t_dec)
        outputs.append(torch.cat(new, 1).cpu().numpy())
    run_s = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated()
    out = np.concatenate(outputs)
    if out.shape != (ENCDEC_BATCHES * ENCDEC_SLOTS, ENCDEC_NEW) \
            or not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail(f"encdec (b): outputs of shape {out.shape}, tokens in "
             f"[{out.min()}, {out.max()}]")
    enc_ms = [a.elapsed_time(b) for a, b in enc_ev]
    call_ms = [a.elapsed_time(b) for a, b in call_ev]
    call_med = statistics.median(call_ms)
    tokens = int(out.size)
    rows = sum(min(p + 1, ENCDEC_MAX_LEN) for p in range(calls)) / calls
    nbytes, ops_bf16, ops_f32, bound_ms, bound_by, bytes_ms, ops_ms = \
        encdec_decode_bound(model, cfg, ENCDEC_SLOTS, rows)
    say("encdec", check="b", served=ENCDEC_BATCHES * ENCDEC_SLOTS,
        tokens=tokens, distinct_tokens=int(len(np.unique(out))),
        decode_calls=len(call_ms), run_s=f"{run_s:.3f}",
        encode_ms=",".join(f"{ms:.3f}" for ms in enc_ms),
        decode_call_ms_device_median=f"{call_med:.4f}",
        decode_call_ms_device_p10_p90=f"{pct(call_ms, 10):.4f},"
        f"{pct(call_ms, 90):.4f}",
        decode_s_host=",".join(f"{s:.3f}" for s in decode_s),
        decode_tokens_per_s=f"{tokens / sum(decode_s):.2f}",
        max_memory_allocated_bytes=peak,
        note="device: CUDA events around encode and each serve_step call; "
             "host: perf_counter over each batch's decode calls, synced",
        card=card)
    say("encdec", check="b", call_bytes=int(nbytes),
        call_ops_bf16=int(ops_bf16), call_ops_f32=int(ops_f32),
        cache_rows_counted=f"{rows:.1f}", bytes_bound_ms=f"{bytes_ms:.4f}",
        operations_bound_ms=f"{ops_ms:.4f}", call_bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, call_bound_share=f"{bound_ms / call_med:.4f}",
        bound_note="float32 decoder weights and the tied head's table "
                   "once, the bf16 memory once a layer, the cache rows the "
                   "calls attend on average; the cross K/V recomputed "
                   "from memory at every call (bf16 at 989 TFLOP/s, "
                   "float32 attention and head at 67)")

    # A traced encode and ENCDEC_TRACE_CALLS decode calls after the run.
    def encode():
        with torch.no_grad():
            model.encode(frames)

    def decode_window():
        nonlocal caches, nxt
        for i in range(ENCDEC_TRACE_CALLS):
            logits, caches = serve(nxt, caches, calls + i, memory)
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    for of, fn, n in (("encode", encode, 1),
                      ("decode", decode_window, ENCDEC_TRACE_CALLS)):
        window_ms, names, busy = device_trace(
            torch, lambda: timed(torch, fn)[1])
        say_window("encdec", of, names, busy, window_ms, n, "call", card)
    del memory, caches

    # A fresh row: float32 decode against forward, every position.
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, ENCDEC_FORWARD_TOKENS))).to(torch.int32).cuda()
    row = frames[:1]
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        with config_override(model, dtype=dtype):
            with torch.no_grad():
                mem = model.encode(row)
                fwd, _ = model(row, toks)
            cache = model.init_cache(1, ENCDEC_MAX_LEN)
            dec = []
            for p in range(ENCDEC_FORWARD_TOKENS):
                lg, cache = serve(toks[:, p:p + 1], cache, p, mem)
                dec.append(lg)
            dec = torch.cat(dec, 1)
        scale = float(fwd.abs().max())
        err = float((dec - fwd).abs().max())
        same = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        gaps[dtype] = (err, scale, same)
        del mem, fwd, cache, dec
    err, scale, same = gaps["float32"]
    if not err <= ENCDEC_FORWARD_TOL * scale:
        fail(f"encdec (b): float32 decode differs from forward by {err} "
             f"(max |logit| {scale})")
    b_err, b_scale, b_same = gaps["bfloat16"]
    say("encdec", check="b", forward_vs_decode_tokens=ENCDEC_FORWARD_TOKENS,
        positions_checked="all", activations="float32",
        max_abs_err=f"{err:.4e}", max_abs_logit=f"{scale:.4f}",
        share_of_max_logit=f"{err / scale:.4e}",
        tolerance=f"{ENCDEC_FORWARD_TOL} x max|logit|",
        same_argmax_share=f"{same:.4f}",
        bf16_max_abs_err=f"{b_err:.4e}",
        bf16_share_of_max_logit=f"{b_err / b_scale:.4f}",
        bf16_same_argmax_share=f"{b_same:.4f}",
        bf16_note="information, not checked")
    del model, serve
    gc.collect()
    torch.cuda.empty_cache()
    say("encdec", check="b", part_s=f"{time.perf_counter() - t_start:.1f}",
        card=card)


def encdec_train(torch, card):
    """(c) whisper-large-v3 at full width trained as launch/train.py
    trains it, through train_at_width for ENCDEC_TRAIN_STEPS steps: the
    batches with frames [TRAIN_BATCH, 16, 1280] from
    launch.train.with_frames, the quantile clip over the tree's 6 groups,
    the monitors over its 32 decoder layers; train_bound counts the
    encoder's and the cross K/V projections' tokens as the frames."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import ENC_FRAMES, with_frames

    cfg = get_config(ENCDEC_ARCH)
    full = (ENCDEC_FULL["enc_layers"], ENCDEC_FULL["dec_layers"])

    def model_ok(model):
        return sum(p.numel() for p in model.parameters()) == ENCDEC_PARAMS \
            and (len(model.enc_stack), len(model.dec_stack)) == full

    def checks(run):
        if run.state.qclip.sketch.m.shape != (6,):
            fail(f"encdec (c): the clip has {run.state.qclip.sketch.m.shape}"
                 " groups, not 6")
        return {}

    def tokens_of(name):
        frames = name.startswith("enc_stack") \
            or name.endswith(("cross.wk", "cross.wv"))
        return TRAIN_BATCH * (ENC_FRAMES if frames else TRAIN_SEQ)

    train_at_width(
        torch, card, "encdec", "c", f"{ENCDEC_ARCH} full width", cfg,
        ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_LR, model_ok,
        need=16 * ENCDEC_PARAMS,
        batches=lambda it: with_frames(it, TRAIN_BATCH, cfg.d_model, "cuda"),
        tokens_of=tokens_of, checks=checks, frames=ENC_FRAMES,
        layers=f"{full[0]}+{full[1]}")


def phase_encdec(torch, gm, card):
    """Phase 17: (a) the golden encoder-decoder entry; (b) whisper-large-v3
    at full width encodes and decodes 8 requests; (c) trains 20 steps.
    Neither (b) nor (c) launches a frugal kernel: both counts are set to 0
    before each and read after."""
    from repro_torch.kernels import frugal_update as fk

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        fail("encdec: TF32 matmuls are on; the float32 golden check needs "
             "them off")
    encdec_golden(torch, gm, card)
    for part, fn in (("b", encdec_serve), ("c", encdec_train)):
        fk.launch_count = fk.scatter_launch_count = 0
        fn(torch, card)
        if (fk.launch_count, fk.scatter_launch_count) != (0, 0):
            fail(f"encdec ({part}): launched {fk.launch_count} dense and "
                 f"{fk.scatter_launch_count} run kernels")
    say("encdec", phase_s=f"{time.perf_counter() - t0:.1f}",
        frugal_kernel_launches=0, card=card)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file() \
            or not GOLDEN_MAKER.is_file():
        fail(f"{ROOT} is not a checkout of the repository (src/repro_torch "
             "and tests/data are missing)")
    sys.path.insert(0, str(ROOT / "src"))
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    say("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    gm = golden_module()
    loops = phase_build()
    phase_families(torch)
    phase_scatter(torch, gm)
    phase_golden(torch, gm)
    # B1's launch shapes on the main paths of phases 5, 9, 10 and 11.
    shapes = collections.defaultdict(collections.Counter)
    with launch_shapes(shapes[5]):
        launches, dense_period_ms = phase_main_path(torch, card)
    sparse_launches = phase_sparse_path(torch)
    entries = phase_timing(torch, loops, launches, card)
    entries += phase_scatter_timing(torch, gm, sparse_launches)
    phase_resilience(torch, gm, card)
    with launch_shapes(shapes[9]):
        entries.append(phase_service(torch, gm, card))
    with launch_shapes(shapes[10]):
        n, eval_blocks = phase_eval(torch, gm, card)
    entries[0]["launches"] += n
    with launch_shapes(shapes[11]):
        entries[0]["launches"] += phase_placement(torch, gm, card,
                                                  dense_period_ms)
    e16_entries, n = phase_roofline(torch, gm, card, loops, shapes,
                                    eval_blocks)
    entries[0]["launches"] += n
    entries += e16_entries
    flush_entry = next(e for e in entries
                       if e["name"].startswith("frugal_program_scatter[SLO"))
    flush_entry["launches"] += phase_serving(torch, gm, card)
    phase_training(torch, gm, card)
    flush_entry["launches"] += phase_moe(torch, gm, card)
    flush_entry["launches"] += phase_ssm(torch, gm, card)
    phase_encdec(torch, gm, card)
    torch.cuda.synchronize()
    if any(m in sys.modules for m in ("jax", "repro")):
        fail("JAX or the JAX package was imported")
    print("kernels: frugal_program_dense[1u,2u,2u-decay,1u-window,2u-window]"
          ", frugal_program_scatter (run kernel)[same five]")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
