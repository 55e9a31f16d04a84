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
     back); the phase's dense and run kernel launches and producers.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import importlib.util
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
GOLDEN_MAKER = ROOT / "tests" / "make_torch_port_golden.py"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/frugal_update.cu"
SCATTER_SOURCE = "src/repro_torch/kernels/csrc/frugal_scatter.cu"
TPU_KERNEL = "src/repro/kernels/frugal_update.py:393"
TPU_KERNEL_B2 = "src/repro/kernels/frugal_update.py:341"
TPU_KERNEL_B3 = "src/repro/kernels/frugal_update.py:271"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory

# The issue slots Frugal-2U needs per lane-tick, counted on its expression
# tree (frugal_tick.cuh: ft_lane_hash, ft_bits_to_uniform, ft_tick_2u; the
# same nodes as core/rng.py and core/frugal.py) at one SASS instruction
# each, with the fusions sm_90 offers: a multiply-add (IMAD) takes a
# multiply with the add after it, a three-input logic op (LOP3) and a
# compare with the `and` after it (FSETP.AND) one slot each, the mantissa
# fill's shift-and-or one LEA.HI (the or adds into zero bits), and a
# select whose one arm is the register's old value is a predicated
# instruction, no slot of its own. Nothing of the loop's bookkeeping (tick
# counter, item address, branch), the item and table loads or register
# moves is counted. The count (44) is below the 45 arithmetic instructions
# per lane-tick of the compiled tick loop (nvcc 12.8, sm_90a; PERF.md), so
# it is a floor the kernel can be held to. Each row is {class: (slots,
# thread-operations per clock per SM on sm_90)}; the rates are the CUDA
# C++ Programming Guide's throughput table for compute capability 9.0.
# Rounding and selects have no row there: they are priced only through
# the issue limit below, which can only lower the bound.
OPS_2U_LANE_TICK = {
    # lane round of the counter hash: tick entry + lane id * key (IMAD),
    # then fmix32 (3 shift-xor pairs, 2 multiplies); mantissa fill (LEA.HI).
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    # mantissa fill minus 1; 2U: step +-1 (x2), m +- ceil (x2), overshoot
    # difference and its step correction (x2 each, the correction
    # predicated on the overshoot).
    "fp32 add": (9, 128),
    # 2U: item vs m with u vs 1-q or q (2 each), sign > 0, sign < 0,
    # step > 0 (x2), overshoot (x2), clamp step > 1 with its sign (x2).
    "compare": (12, 64),
    "fp32 round (ceil)": (2, None),
    # 2U: +-1 (x2), ceil or 1 (x2); m: the overshoot's item or the
    # branch's m, taken for the branch that moved (x2), then new or old
    # (1); step: the clamp (x2), new or old (1); sign: +1 or -1 where a
    # branch moved (1).
    "select": (11, None),
}
# Decayed 2U (ft_tick_2u_decay) adds to the 2U tick: floor - (floor - step)
# * alpha (two subtractions, one multiply; the last subtraction predicated
# on the gate, so the select takes no slot) and its gate (item == item,
# step < floor).
OPS_2U_DECAY_LANE_TICK = dict(
    OPS_2U_LANE_TICK, **{"fp32 add": (11, 128), "fp32 multiply": (1, 128),
                         "compare": (14, 64)})
# The (seed, t) round of the hash is the same for every lane: once per
# tick, seed + t * key (IMAD) and fmix32.
OPS_TICK = {"int32 multiply-add": (3, 64), "int32 shift": (3, 64),
            "int32 logic": (3, 64)}
# A sparse event also advances its lane's clock by its mask.
OPS_CLOCK = {"int32 add": (1, 64)}
ISSUE_PER_SM_CLOCK = 128   # 4 schedulers x 32 lanes; = the FP32 FMA rate


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


def say_trace(phase, names, busy_ms, window_ms, per, card, top=6):
    """The trace's dense kernel share of ``window_ms`` and its ``top``
    device activities, each per ``per`` (chunks). Without a trace
    (``names`` None) the shares print as null: not measured."""
    if names is None:
        say("trace", of=phase, window_ms=f"{window_ms:.4f}",
            device_busy_ms="null", device_busy_share="null",
            dense_kernel_ms="null", dense_kernel_share="null", card=card,
            note="no device trace: not measured")
        return
    dense = sum(ms for n, (_, ms) in names.items() if "frugal_dense" in n)
    say("trace", of=phase, window_ms=f"{window_ms:.4f}",
        device_busy_ms=f"{busy_ms:.4f}",
        device_busy_share=f"{busy_ms / window_ms:.4f}",
        dense_kernel_ms=f"{dense:.4f}",
        dense_kernel_share=f"{dense / window_ms:.4f}", card=card,
        note="torch.profiler, CUDA activity only")
    for name, (calls, ms) in sorted(names.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        say("trace", of=phase, activity=name[:90], calls=calls,
            ms_per_chunk=f"{ms / per:.4f}",
            share=f"{ms / window_ms:.4f}")


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
    return launches


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


def operation_bound_ms(work, sm_clocks_per_s):
    """(ms, what binds): the least time the card needs for ``work``, pairs
    of (operation table, times it runs). Each class takes its operations
    over its own rate; every operation also takes one of the SM's issue
    slots."""
    counts = {}
    for table, n in work:
        for cls, (ops, rate) in table.items():
            counts[cls] = (counts.get(cls, (0, rate))[0] + ops * n, rate)
    clocks = {cls: ops / rate for cls, (ops, rate) in counts.items() if rate}
    clocks["issue"] = sum(ops for ops, _ in counts.values()) \
        / ISSUE_PER_SM_CLOCK
    binding = max(clocks, key=clocks.get)
    return clocks[binding] / sm_clocks_per_s * 1e3, binding


def card_sm_clocks_per_s(torch):
    """(SM clocks per second over the whole card, max SM clock in Hz)."""
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return props.multi_processor_count * clock_hz, clock_hz


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

    nbytes = (items.numel() + quantile.numel()) * 4 \
        + 2 * sum(w.numel() * w.element_size() for w in words)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    sm_clocks_per_s, clock_hz = card_sm_clocks_per_s(torch)
    lane_ticks = CHUNK_T * lanes
    ops_ms, ops_binding = operation_bound_ms(
        ((OPS_2U_LANE_TICK, lane_ticks), (OPS_TICK, CHUNK_T)),
        sm_clocks_per_s)
    sass_ms = (loops["2u"] * lane_ticks
               / (sm_clocks_per_s * ISSUE_PER_SM_CLOCK) * 1e3)
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
        operations_per_lane_tick=sum(
            ops for ops, _ in OPS_2U_LANE_TICK.values()),
        operations_ms=f"{ops_ms:.4f}", operations_bound_by=ops_binding,
        lane_ticks=lane_ticks, sms=round(sm_clocks_per_s / clock_hz),
        max_sm_clock_hz=f"{clock_hz:.4e}",
        lane_ticks_per_s=f"{lane_ticks / ms * 1e3:.4e}",
        bound_share=f"{bound / ms:.4f}")
    say("timing", sass_per_lane_tick=f"{loops['2u']:.2f}",
        sass_issue_ms=f"{sass_ms:.4f}",
        note="diagnostic: this build's loop, not the function's need")
    dense_split(torch, "dense", prog, items, words, quantile, q,
                OPS_2U_LANE_TICK, card)
    svc_prog = program_mod.make_program("2u-decay", half_life=1 << 16)
    svc_items = torch.empty((CHUNK_T, SVC_G), device=dev).normal_(
        50.0, 15.0, generator=gen)
    svc_words = tuple(w.contiguous() for w in svc_prog.layout.pack_planes(
        random_planes(torch, svc_prog, SVC_G, gen, dev)))
    dense_split(torch, "service", svc_prog, svc_items, svc_words,
                torch.full((SVC_G,), 0.5, device=dev), 1,
                OPS_2U_DECAY_LANE_TICK, card)
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


def dense_split(torch, label, prog, items, words, quantile, q, work,
                card):
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
    sm_clocks_per_s, clock_hz = card_sm_clocks_per_s(torch)
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
        nbytes = (t * g + lanes) * 4 + 2 * sum(
            w.numel() * w.element_size() for w in words)
        ops_ms, _ = operation_bound_ms(((work, t * lanes), (OPS_TICK, t)),
                                       sm_clocks_per_s)
        bound[t] = max(nbytes / HBM_BYTES_PER_S * 1e3, ops_ms)
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

    dev = torch.device("cuda")
    prog = program_mod.make_program("2u")
    sm_clocks_per_s, clock_hz = card_sm_clocks_per_s(torch)

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
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms, ops_binding = operation_bound_ms(
            ((OPS_2U_LANE_TICK, k), (OPS_TICK, k), (OPS_CLOCK, k)),
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
    sm_clocks_per_s, clock_hz = card_sm_clocks_per_s(torch)
    device_ms, host_us = queued_ms(torch, kernel, SPLIT_QUEUED, clock_hz)
    plain_ms = event_ms(torch, plain, 3)[1:]
    err = max_abs_err(prog.layout.unpack_words(res["kernel"]),
                      prog.layout.unpack_words(res["plain"]))
    if not same_bits(torch, res["kernel"], res["plain"]):
        fail(f"service chunk: the kernel differs from the plain version "
             f"(max abs err {err})")
    nbytes = (items.numel() + quantile.numel()) * 4 \
        + 2 * sum(w.numel() * w.element_size() for w in words)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lane_ticks = SVC_CHUNK_T * SVC_G
    ops_ms, ops_binding = operation_bound_ms(
        ((OPS_2U_DECAY_LANE_TICK, lane_ticks), (OPS_TICK, SVC_CHUNK_T)),
        sm_clocks_per_s)
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
    launches = phase_main_path(torch, card)
    sparse_launches = phase_sparse_path(torch)
    entries = phase_timing(torch, loops, launches, card)
    entries += phase_scatter_timing(torch, gm, sparse_launches)
    phase_resilience(torch, gm, card)
    entries.append(phase_service(torch, gm, card))
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
