#!/usr/bin/env python3
"""Timing of the dense kernel (B1) on one CUDA card, at the two shapes of
the port's main paths: [512, 2^22] items, Q = 3, ``2u`` (the dense fleet
of ``chip_smoke.py`` phase 5; also its first 64 rows, and one group
narrower, which stages items by cp.async instead of TMA) and [64, 2^20],
Q = 1, ``2u-decay`` (the streaming service's chunk, phase 9).

    python3 tools/bench_b1.py time ROOT         # one checkout, one JSON line
    python3 tools/bench_b1.py ab ROOT ROOT ...   # each in its own process,
                                                 # in the order given
    python3 tools/bench_b1.py sweep [OUT.jsonl]  # this checkout's launch
                                                 # shape: unroll x block x
                                                 # tile rows

``time`` imports ``repro_torch`` from ``ROOT/src`` and builds that
checkout's kernels, so two trees (say, a parent unpacked with ``git
archive`` and this one) compare in one call, in turns (parent, change,
change, parent). Times: one launch between CUDA events (median of 7 after
a warm-up), and the device time per launch of 10 launches queued back to
back behind a sleep (median of 5), which leaves out the host's enqueue,
and the host's time per call of those launches (the wrapper's enqueue).
Items are made on the card from fixed seeds, so every run sees the same
data. ``sweep`` builds the kernel library once per (tick unroll, tile
rows) pair, the header's build-time constants overridden by -D flags (all
builds started together), and times every block size with each, holding
each result bit-identical to the first. Needs the card and the CUDA
toolkit; prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import itertools
import json
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, program, T, G, Q). "dense_cp_async" is the dense shape one group
# narrower: a row stride of G * 4 bytes that is no multiple of 16 makes the
# kernel stage its items by cp.async instead of TMA.
SHAPES = (("dense", "2u", 512, 2 ** 22, 3), ("dense", "2u", 64, 2 ** 22, 3),
          ("dense_cp_async", "2u", 512, 2 ** 22 - 1, 3),
          ("service", "2u-decay", 64, 2 ** 20, 1))
SWEPT = (("dense", 512), ("service", 64))
QUEUED = 10
SWEEP_UNROLL = (4, 8, 16)
SWEEP_BLOCK = (64, 128, 256, 512)
SWEEP_ROWS = (8, 16, 32, 64)


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def operands(torch, program_mod, shape):
    """(program, items, words, quantile, Q) of a shape, made on the card."""
    label, family, t, g, q = shape
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prog = (program_mod.make_program(family, half_life=1 << 16)
            if family == "2u-decay" else program_mod.make_program(family))
    if label == "service":
        items = torch.empty((t, g), device=dev).normal_(50.0, 15.0,
                                                        generator=gen)
        quantile = torch.full((g * q,), 0.5, device=dev)
    else:
        items = torch.empty((t, g), device=dev).log_normal_(5.0, 1.0,
                                                           generator=gen)
        quantile = torch.tensor([0.5, 0.9, 0.99], device=dev).repeat(g)
    lanes = g * q
    planes = (torch.zeros(lanes, device=dev), torch.ones(lanes, device=dev),
              torch.ones(lanes, device=dev))
    words = tuple(w.contiguous() for w in prog.layout.pack_planes(planes))
    return prog, items, words, quantile, q


def event_ms(torch, fn, reps=8):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def queued_ms(torch, fn, clock_hz, n=QUEUED, reps=5):
    """(device ms per call, host us per call: the wrapper's enqueue),
    medians of ``reps`` rounds of ``n`` calls queued behind a sleep."""
    times, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.03 * clock_hz))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host.append((time.perf_counter() - t0) / n * 1e6)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times), statistics.median(host)


def max_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return float(out.stdout.strip().split()[0]) * 1e6


def time_root(root: Path) -> dict:
    """Both timings of B1 at every shape, from ``root``'s package."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import frugal_update as fk

    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    clock_hz = max_clock_hz()
    out = {"root": str(root), "card": card(), "build_s": round(build_s, 2)}
    for shape in SHAPES:
        prog, items, words, quantile, q = operands(torch, program_mod, shape)

        def run():
            return fk.frugal_program_dense(prog, items, words, quantile, 0,
                                           lanes_per_group=q)

        key = f"{shape[0]}_t{shape[2]}"
        out[f"{key}_event_ms"] = event_ms(torch, run)
        out[f"{key}_device_ms"], out[f"{key}_host_us"] = queued_ms(
            torch, run, clock_hz)
        del items
    return out


def sweep(out_path: Path) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import program as program_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import frugal_update as fk

    print(card(), flush=True)
    clock_hz = max_clock_hz()
    cases = [(shape, operands(torch, program_mod, shape))
             for shape in SHAPES if (shape[0], shape[2]) in SWEPT]
    configs = list(itertools.product(SWEEP_UNROLL, SWEEP_ROWS))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(configs)) as pool:
        libs = list(pool.map(lambda c: build._build(build.NVCC_FLAGS + (
            f"-DFT_DENSE_UNROLL={c[0]}", f"-DFT_DENSE_TILE_ROWS={c[1]}"),
            force=False).path, configs))
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first = {}
    rows_out = []
    for (unroll, rows), lib in zip(configs, libs):
        build._LIB = build._declare(ctypes.CDLL(str(lib)))
        for block_g in SWEEP_BLOCK:
            row = {"unroll": unroll, "block_g": block_g, "tile_rows": rows}
            for shape, (prog, items, words, quantile, q) in cases:

                def run():
                    return fk.frugal_program_dense(
                        prog, items, words, quantile, 0, lanes_per_group=q,
                        block_g=block_g)

                got = run()
                ref = first.setdefault(shape[0], got)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise SystemExit(f"sweep: {row} {shape[0]} differs from "
                                     "the first configuration")
                row[f"{shape[0]}_device_ms"] = queued_ms(
                    torch, run, clock_hz, n=5 if shape[0] == "dense" else 10,
                    reps=3)[0]
            print(json.dumps(row), flush=True)
            rows_out.append(row)
    build._LIB = None
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text("".join(json.dumps(r) + "\n" for r in rows_out))
    for label in ("dense", "service"):
        best = sorted(rows_out, key=lambda r: r[f"{label}_device_ms"])[:5]
        print(f"best {label}: " + "; ".join(
            f"u{r['unroll']}/b{r['block_g']}/r{r['tile_rows']}="
            f"{r[f'{label}_device_ms']:.4f}" for r in best), flush=True)


def main(argv) -> None:
    if len(argv) < 2 or argv[1] not in ("time", "ab", "sweep"):
        raise SystemExit(__doc__)
    if argv[1] == "time":
        print(json.dumps(time_root(Path(argv[2]).resolve())), flush=True)
    elif argv[1] == "ab":
        for root in argv[2:]:
            proc = subprocess.run([sys.executable, __file__, "time", root],
                                  capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"{root}: {proc.stderr[-3000:]}")
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    else:
        sweep(Path(argv[2]) if len(argv) > 2
              else ROOT / "build" / "b1_sweep.jsonl")


if __name__ == "__main__":
    main(sys.argv)
