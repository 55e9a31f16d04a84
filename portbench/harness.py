"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the mix's ``kind`` names the module of
``kinds/`` that drives the system with it and checks what it returned,
and each per-layer metric is read by ``metrics/<metric>.py``. Nothing here
names a cell.

A run: set-up (the fleet at full size, the cell's batches made on the card
from the seed, the warm-up batches through the same calls as the window),
then a closed loop for ``--seconds``: each batch is handed to the fleet
and waited for before the next. ``items_per_s`` is every item applied
over the window's host-clock length; ``apply_p95_ms`` the 95th percentile
of each batch's time from its hand-over to its completion, read by CUDA
events around the call on the device's clock (the stream is idle at the
hand-over, so the first event marks it); ``setup_s`` the host-clock
seconds from the start of the process to the window. After the window:
the peak device memory, then the check against the plain reference
(``reference.py``), each number beside its limit.

``--trace 1`` runs three windows of ``--seconds`` each, in this order,
and prints the per-layer metrics. (1) The window above, untraced: the
readers of the host's clock take it (``Window.call_s``). (2) A recorded
window, the same loop inside ``repro_torch.tracing.recording()`` and
under no profiler, which doubles the host's times: ``Window.spans``
(``spans.py``) holds its record and each span name's entries, total and
self time, and ``Window.counters`` the change over it of each program
counter that the kind names in ``COUNTERS`` (pairs of a module of
``repro_torch`` and an attribute), keyed ``"<module>.<attribute>"``.
(3) A window recorded with ``torch.profiler``: ``Window.trace``, the
kernel launch counters (``Window.launches``) and the window's length.
Both fields of (2) are None in a ``--trace 0`` run, which runs window
(1) alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import random
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from portbench import devtrace

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# Top-level modules that no run may hold once its window has closed: JAX
# and the JAX package this system was ported from (``repro``; the system
# under test is ``repro_torch``, a different top-level name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a kind's driver gets: the cell's configuration and mix, what
    is derived from the seed, and the device."""
    config: dict
    mix: dict
    fleet_seed: int                 # the system's int32 counter seed
    device: torch.device
    gen: torch.Generator            # the traffic's generator, on the device


@dataclasses.dataclass
class Window:
    """What the window measured, for the metric readers."""
    batches: int
    items: int
    window_s: float
    call_s: list                    # host seconds a call, untraced
    launches: dict
    work: dict
    program: object
    trace: Optional[devtrace.Trace] = None
    spans: Optional[object] = None      # spans.Spans of the recorded window
    counters: Optional[dict] = None     # program counters over it


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {folder} file {path}")
    with open(path) as f:
        return json.load(f)


def _load_module(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {folder} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fleet_seed(seed: int) -> int:
    """The system's int32 counter seed, derived from any whole number."""
    return random.Random(seed).randrange(-2 ** 31, 2 ** 31)


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _counters():
    from repro_torch.kernels import frugal_update as fk

    return {"dense": fk.launch_count, "scatter": fk.scatter_launch_count}


def _program_counters(pairs) -> dict:
    """The kind's program counters, ``(module, attribute)`` pairs under
    ``repro_torch``, as they stand."""
    import importlib

    return {f"{m}.{a}": getattr(importlib.import_module(f"repro_torch.{m}"),
                                a) for m, a in pairs}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(driver, seconds: float, device, traced: bool):
    """The closed loop: hand a batch, wait for it, until ``seconds`` of
    host clock have passed. Returns (window seconds, per-batch apply ms,
    per-call host seconds)."""
    span = torch.profiler.record_function if traced else \
        (lambda name: nullcontext())
    cuda = device.type == "cuda"
    if cuda:
        marks = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
    apply_ms, call_s = [], []
    with span(devtrace.WINDOW):
        start = time.perf_counter()
        while True:
            with span("pb.call"):
                if cuda:
                    marks[0].record()
                t0 = time.perf_counter()
                driver.submit()
                t1 = time.perf_counter()
                if cuda:
                    marks[1].record()
            with span("pb.sync"):
                if cuda:
                    marks[1].synchronize()
                    apply_ms.append(marks[0].elapsed_time(marks[1]))
                else:
                    apply_ms.append((time.perf_counter() - t0) * 1e3)
            call_s.append(t1 - t0)
            now = time.perf_counter()
            if now - start >= seconds:
                break
    return now - start, apply_ms, call_s


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, *, config=None, mix=None,
             control: bool = False) -> dict:
    """One run of a cell; returns the result line as a dict. ``config``
    and ``mix`` stand in for the cell's files (tests use small ones);
    ``control`` puts the reference, in a lower precision, in the place of
    the system's outputs before the check."""
    device = torch.device(device)
    cell = next((w for w in manifest["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {cell_name!r} in "
                         "BENCHMARK.json")
    config = config or _load_json("configs", cell["config"])
    mix = mix or _load_json("traffic", cell["traffic"])
    kind = _load_module("kinds", mix["kind"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ctx = Context(config=config, mix=mix, fleet_seed=fleet_seed(seed),
                  device=device, gen=gen)
    driver = kind.Driver(ctx)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    gc.collect()
    before, n0 = _counters(), driver.n
    window_s, apply_ms, call_s = _window(driver, seconds, device, False)
    prof = recorded = counted = None
    if trace:
        from repro_torch import tracing
        from torch.profiler import ProfilerActivity, profile

        from portbench import spans

        c0, r0 = _program_counters(kind.COUNTERS), driver.n
        with tracing.recording() as rec:
            _window(driver, seconds, device, False)
        c1 = _program_counters(kind.COUNTERS)
        recorded = spans.summarize(rec, driver.n - r0)
        counted = {k: c1[k] - c0[k] for k in c1}
        # the record's spans live on: collect before the profiled window,
        # as before the first one
        gc.collect()
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        before, n0 = _counters(), driver.n
        with prof:
            window_s, _, _ = _window(driver, seconds, device, True)
    after, n1 = _counters(), driver.n
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Window(batches=n1 - n0, items=(n1 - n0) * driver.items_per_batch,
                 window_s=window_s, call_s=call_s,
                 launches={k: after[k] - before[k] for k in after},
                 work=driver.work(), program=driver.prog,
                 trace=devtrace.read(prof) if prof is not None else None,
                 spans=recorded, counters=counted)

    checks = driver.check(control)
    correct = all(v <= lim for v, lim in checks.values())

    if trace:
        metrics = {}
        for m in manifest["per_layer"]:
            if not _applies(m, cell_name):
                continue
            value = _load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"items_per_s": run.items / run.window_s,
                  "apply_p95_ms": float(np.percentile(apply_ms, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest["end_to_end"] if _applies(m, cell_name)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.batches,
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["window_s"] = window_s
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            result["breakdown"] = {"device_ops": run.trace.top_ops(),
                                   "idle_gaps": run.trace.top_idle()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard
    output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t_start: float, control: bool = False) -> None:
    args = parse_args(argv)
    manifest = load_manifest()
    cell = next((w for w in manifest["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card", 3)
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{cell['chips']} card(s) asked for, "
             f"{torch.cuda.device_count()} present", 3)
    torch.set_num_threads(2)
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start, control=control)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {bad}", 4)
    if not all(math.isfinite(m["value"]) for m in result["metrics"].values()):
        fail(f"a metric is not finite: {result['metrics']}", 5)
    emit(result)
