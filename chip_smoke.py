#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and the CUDA
toolkit (``nvcc``, ``cuobjdump``), imports nothing of JAX, and exits
non-zero, printing no result, if any phase fails. Phases, one result line
each:

  1. device and build: the card's name and power limit, a clean build of
     the dense kernel, registers and spills per instantiation, and the
     SASS instructions in each instantiation's tick loop;
  2. kernel vs plain version: all six lane programs at 21,845 groups x 3
     quantiles, T = 1024 ticks across the int32 wrap with NaN ticks, block
     sizes 32 / 256 / 1024 and the 128-row launches, each bit-identical to
     the plain PyTorch version run on the card;
  3. golden: the kernel on the committed inputs of
     tests/data/torch_port_golden.npz equals the JAX package's outputs;
  4. the main path at full width: FleetSpec(2^22 groups, q50/q90/q99, 2u,
     chunk_t 512), QuantileFleet.create on the card, ingest_stream of 8
     chunks of [512, 2^22] lognormal items made on the card, estimate()
     after chunks 1, 4 and 8; the kernel's launch count over that run;
     the first and last 4096 groups' lanes equal to the plain version;
  5. the kernel's time on one full-width chunk against its bound and the
     plain version's time, as the {"kernels": [...]} line.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/frugal_update.cu"
TPU_KERNEL = "src/repro/kernels/frugal_update.py:393"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory

# The operations Frugal-2U needs per lane-tick, counted on its expression
# tree (frugal_tick.cuh: ft_lane_hash, ft_bits_to_uniform, ft_tick_2u; the
# same nodes as core/rng.py and core/frugal.py), not on the compiled loop.
# Shared subexpressions count once, a compare absorbs the `and` that
# follows it (FSETP.AND), and nothing of the loop's own bookkeeping (tick
# counter, item pointer, branch) or the item load is counted. Each row is
# {class: (operations, thread-operations per clock per SM on sm_90)}; the
# rates are the CUDA C++ Programming Guide's throughput table for compute
# capability 9.0. Rounding and selects have no row there: they are priced
# only through the issue limit below, which can only lower the bound.
OPS_2U_LANE_TICK = {
    # lane round of the counter hash: tick hash + lane key, then fmix32
    # (3 xor-shifts, 2 multiplies); mantissa fill: shift, or.
    "int32 add": (1, 64),
    "int32 multiply": (2, 64),
    "int32 shift": (4, 64),
    "int32 bitwise": (4, 64),
    # mantissa fill minus 1; 2U: step +-1 (x2), m +- ceil (x2), overshoot
    # difference and step correction (x2 each).
    "fp32 add": (9, 128),
    # 2U: item vs m with u vs 1-q or q (2 each), sign > 0, sign < 0,
    # step > 0 (x2), overshoot (x2), clamp step > 1 (x2).
    "compare": (12, 64),
    "fp32 round (ceil)": (2, None),
    # 2U: +-1 (x2), ceil or 1 (x2), overshoot (2 x2), clamp (x2), and the
    # three two-way choices of m, step and sign (6).
    "select": (16, None),
}
# The (seed, t) round of the hash is the same for every lane: once per
# tick, a multiply-add and fmix32.
OPS_TICK = {"int32 multiply": (1, 64), "int32 add": (1, 64),
            "int32 shift": (3, 64), "int32 bitwise": (3, 64)}
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


# --------------------------------------------------------------- phase 1
def ptxas_summary(log: str) -> dict:
    """{family id: (registers, spill store bytes)} from nvcc -Xptxas -v."""
    out, fam = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*frugal_dense_kernelILi"
                      r"(\d+)E", line)
        if m:
            fam = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fam is not None:
            out.setdefault(fam, [None, None])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fam is not None:
            out.setdefault(fam, [None, None])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def sass_loop_instructions(so_path: Path) -> dict:
    """{family id: instructions in the tick loop} from cuobjdump -sass.

    The tick loop is the longest backward branch of each instantiation;
    sm_90 instructions are 16 bytes, so its length is the address span /16.
    """
    from repro_torch.kernels.build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(so_path)],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump: {out.stderr.strip()}")
    loops, fam = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : \S*frugal_dense_kernelILi(\d+)E", line)
        if m:
            fam = int(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/.*\bBRA\b[^;]*?0x([0-9a-f]+)",
                      line)
        if m and fam is not None:
            at, target = int(m.group(1), 16), int(m.group(2), 16)
            if target < at:
                loops[fam] = max(loops.get(fam, 0), (at - target) // 16 + 1)
    return loops


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.frugal_update import FAMILY_IDS

    res = build.build_library(force=True)
    names = {v: k for k, v in FAMILY_IDS.items()}
    regs = ptxas_summary(res.log)
    loops = sass_loop_instructions(res.path)
    if sorted(regs) != sorted(names) or sorted(loops) != sorted(names):
        fail(f"build: instantiations {sorted(regs)} / loops {sorted(loops)}"
             f" != families {sorted(names)}\n{res.log}")
    say("build", seconds=f"{res.seconds:.2f}", library=res.path.name)
    for fid in sorted(names):
        say("build", family=names[fid], registers=regs[fid][0],
            spill_store_bytes=regs[fid][1], sass_loop_instructions=loops[fid])
    build.load_library()
    return {names[k]: v for k, v in loops.items()}


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


def phase_families(torch):
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    g, q, t = 21845, 3, 1024
    lanes = g * q
    t_off, g_off, seed = 2 ** 31 - 300, 12345, 777
    items = torch.empty((t, g), device=dev).log_normal_(
        3.0, 1.0, generator=gen)
    items[torch.rand((t, g), generator=gen, device=dev) < 0.03] = \
        float("nan")
    items[::97] = float("nan")                       # whole NaN rows
    quantile = torch.tensor([0.5, 0.9, 0.99], device=dev).repeat(g)
    for prog in program_mod.test_instances():
        planes = random_planes(torch, prog, lanes, gen, dev)
        words = tuple(w.contiguous() for w in prog.layout.pack_planes(planes))
        want = fk.frugal_program_dense_reference(
            prog, items, words, quantile, seed, t_offset=t_off,
            g_offset=g_off, lanes_per_group=q)
        kw = dict(program=prog, t_offset=t_off, g_offset=g_off,
                  lanes_per_group=q)
        runs = {f"auto/block_g={bg}": (
            lambda bg=bg: ops.frugal_update_auto(
                items, planes, quantile, seed=seed, block_g=bg, **kw))
            for bg in (32, 256, 1024)}
        runs["blocked/block_g=256,block_t=128"] = (
            lambda: ops.frugal_update_blocked(
                items, planes, quantile, seed, block_g=256, block_t=128,
                **kw))
        for label, run in runs.items():
            got_words = prog.layout.pack_planes(run())
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got_words, want)):
                diff = a.view(torch.int32) != b.view(torch.int32)
                if bool(diff.any()):
                    fail(f"{prog.family} {label}: word {i} differs from "
                         f"the plain version in {int(diff.sum())} lane(s)")
        say("families", program=prog.family, lanes=lanes, ticks=t,
            runs=len(runs), result="bit-identical")


# --------------------------------------------------------------- phase 3
def phase_golden(torch):
    import numpy as np
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import frugal_update as fk

    data = np.load(GOLDEN)
    g, q, t, t_off, g_off, seed = (int(v) for v in data["meta"])
    dev = torch.device("cuda")
    items = torch.from_numpy(data["items"]).to(dev)
    quantile = torch.from_numpy(data["quantile"]).to(dev)
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
    say("golden", programs=len(program_mod.test_instances()),
        lanes=g * q, ticks=t, result="bit-identical to the JAX package")


# --------------------------------------------------------------- phase 4
G_FULL, QS, CHUNK_T, N_CHUNKS, EDGE = 2 ** 22, (0.5, 0.9, 0.99), 512, 8, 4096


def phase_main_path(torch):
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launch_count = 0
    stream = chunks()
    ingest_s, est_ms, estimates = 0.0, [], None
    for n in (1, 3, 4):                 # estimate() after chunks 1, 4, 8
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
    launches = fk.launch_count
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
        kernel_launches=launches, edge_slices="bit-identical",
        estimates="finite")
    say("main", items_per_s=f"{items_total / ingest_s:.4e}",
        lane_ticks_per_s=f"{items_total * q / ingest_s:.4e}",
        ingest_s=f"{ingest_s:.4f}", note="includes making items on the card")
    say("main", chunk_period_ms=",".join(f"{v:.4f}" for v in periods),
        median_chunk_period_ms=f"{statistics.median(periods):.4f}")
    say("main", estimate_ms=",".join(f"{v:.2f}" for v in est_ms),
        max_memory_allocated_bytes=peak)
    say("main", median_rel_err=",".join(f"q{int(round(qq * 100))}={r:.4f}"
                                        for qq, r in zip(QS, rel)),
        sampled_groups=EDGE, note="informational")
    return launches


# --------------------------------------------------------------- phase 5
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


def operation_bound_ms(lane_ticks, ticks, sm_clocks_per_s):
    """(ms, what binds, operations per lane-tick): the least time the card
    needs for 2u's operations on ``lane_ticks`` lane-ticks over ``ticks``
    ticks. Each class takes its operations over its own rate; every
    operation also takes one of the SM's issue slots."""
    counts = {}
    for table, n in ((OPS_2U_LANE_TICK, lane_ticks), (OPS_TICK, ticks)):
        for cls, (ops, rate) in table.items():
            counts[cls] = (counts.get(cls, (0, rate))[0] + ops * n, rate)
    clocks = {cls: ops / rate for cls, (ops, rate) in counts.items() if rate}
    clocks["issue"] = sum(ops for ops, _ in counts.values()) \
        / ISSUE_PER_SM_CLOCK
    binding = max(clocks, key=clocks.get)
    per_lane_tick = sum(ops for ops, _ in OPS_2U_LANE_TICK.values())
    return clocks[binding] / sm_clocks_per_s * 1e3, binding, per_lane_tick


def phase_timing(torch, loops, launches):
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

    def plain():
        res["plain"] = fk.frugal_program_dense_reference(
            prog, items, words, quantile, 0, lanes_per_group=q)

    kernel_ms = event_ms(torch, kernel, 8)[1:]          # one warm-up
    plain_ms = event_ms(torch, plain, 1)
    got, want = res["kernel"], res["plain"]
    err = 0.0
    for a, b in zip(prog.layout.unpack_words(got),
                    prog.layout.unpack_words(want)):
        err = max(err, float((a - b).abs().max()))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if not same:
        fail(f"full-width chunk: kernel differs from the plain version "
             f"(max abs err {err})")

    nbytes = (items.numel() + quantile.numel()) * 4 \
        + 2 * sum(w.numel() * w.element_size() for w in words)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sm_clocks_per_s = props.multi_processor_count * clock_hz
    lane_ticks = CHUNK_T * lanes
    ops_ms, ops_binding, ops_per_lane_tick = operation_bound_ms(
        lane_ticks, CHUNK_T, sm_clocks_per_s)
    sass_ms = (loops["2u"] * lane_ticks
               / (sm_clocks_per_s * ISSUE_PER_SM_CLOCK) * 1e3)
    ms = statistics.median(kernel_ms)
    say("timing", kernel_ms=",".join(f"{v:.4f}" for v in kernel_ms),
        plain_ms=f"{plain_ms[0]:.2f}",
        make_chunk_ms=",".join(f"{v:.4f}" for v in gen_ms))
    say("timing", bytes=nbytes, bytes_ms=f"{bytes_ms:.4f}",
        operations_per_lane_tick=ops_per_lane_tick,
        operations_ms=f"{ops_ms:.4f}", operations_bound_by=ops_binding,
        lane_ticks=lane_ticks, sms=props.multi_processor_count,
        max_sm_clock_hz=f"{clock_hz:.4e}",
        lane_ticks_per_s=f"{lane_ticks / ms * 1e3:.4e}",
        bound_share=f"{max(bytes_ms, ops_ms) / ms:.4f}")
    say("timing", sass_loop_instructions=loops["2u"],
        sass_issue_ms=f"{sass_ms:.4f}",
        note="diagnostic: this build's loop, not the function's need")
    return {"name": "frugal_program_dense", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms[0], "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.is_file():
        fail(f"{ROOT} is not a checkout of the repository (src/repro_torch "
             "and tests/data are missing)")
    sys.path.insert(0, str(ROOT / "src"))
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    say("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    loops = phase_build()
    phase_families(torch)
    phase_golden(torch)
    launches = phase_main_path(torch)
    entry = phase_timing(torch, loops, launches)
    torch.cuda.synchronize()
    if any(m in sys.modules for m in ("jax", "repro")):
        fail("JAX or the JAX package was imported")
    print("kernels: frugal_program_dense[1u,2u,2u-decay,1u-window,2u-window]")
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
