"""The harness at small sizes on the CPU: the manifest and its files, the
result line, the import check, the control and the planted faults of each
cell's kind, which must all read ``correct`` false, the three windows of a
traced run, the span summary and its readers, the program counters of the
recorded window, and a kind that these tests bring themselves and hand to
the harness by name, as a later cell's new files would be found; and on
the card, a small run of each cell."""
import importlib
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import devtrace, harness, reference, spans, traffic

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def _workload(cell, manifest=MANIFEST):
    return next(x for x in manifest["workloads"] if x["name"] == cell)


def kind_of(cell, manifest=MANIFEST):
    """The module of the cell's kind, found by name as the harness finds
    it."""
    mix = harness._load_json("traffic", _workload(cell, manifest)["traffic"])
    return harness._load_module("kinds", mix["kind"])


def small(cell, control=False, manifest=MANIFEST):
    """The cell's configuration and mix at the size its kind gives a CPU
    run (``CPU_SIZE``, and ``CPU_SIZE_CONTROL`` over it for the control),
    every other parameter as the files give it."""
    w = _workload(cell, manifest)
    config = harness._load_json("configs", w["config"])
    mix = harness._load_json("traffic", w["traffic"])
    kind = kind_of(cell, manifest)
    for size in (kind.CPU_SIZE, kind.CPU_SIZE_CONTROL)[:1 + control]:
        config = dict(config, **size.get("config", {}))
        mix = dict(mix, **size.get("mix", {}))
    return config, mix


def run_small(cell, seed=2 ** 31 + 11, control=False, trace=False,
              manifest=MANIFEST):
    config, mix = small(cell, control, manifest)
    return harness.run_cell(manifest, cell, seed, 0.15, trace, "cpu",
                            time.perf_counter(), config=config, mix=mix,
                            control=control)


def plant(monkeypatch, kind, fault):
    """Wrap the function of ``repro_torch`` that ``kind.FAULTS[fault]``
    names with the fault's wrapper."""
    module, name, make = kind.FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.{module}")
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))


def serve_files(monkeypatch, files: dict):
    """Let the harness find the objects of ``files``, keyed (folder,
    name), where it would load ``<folder>/<name>.py`` or ``.json``."""
    load_module, load_json = harness._load_module, harness._load_json
    monkeypatch.setattr(harness, "_load_module", lambda folder, name: (
        files[folder, name] if (folder, name) in files
        else load_module(folder, name)))
    monkeypatch.setattr(harness, "_load_json", lambda folder, name: (
        files[folder, name] if (folder, name) in files
        else load_json(folder, name)))


def test_manifest_names_its_files_and_keeps_the_contract():
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in MANIFEST[part]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
        mix = harness._load_json("traffic", w["traffic"])
        assert (ROOT / "portbench" / "kinds" / f"{mix['kind']}.py").is_file()
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_its_line_keeps_the_contract(cell, capsys):
    result = run_small(cell)
    assert result["correct"] is True
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"]
                                      for m in MANIFEST["end_to_end"]
                                      if harness._applies(m, cell)}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert all(c["value"] == 0 == c["limit"]
               for c in result["checks"].values())
    harness.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    checks = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and "(limit 0)" in line
               for line in checks)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(cell):
    """The reference in bfloat16 in place of the system's outputs. Its
    estimates differ from float32's mostly where a coin lands within
    bfloat16's rounding of the target, so the cell needs some thousands
    of lanes to show it every time."""
    result = run_small(cell, control=True)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


FAULT_CASES = [(cell, fault) for cell in CELLS
               for fault in sorted(kind_of(cell).FAULTS)]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_fault_under_the_timed_path_reads_not_correct(cell, fault,
                                                        monkeypatch):
    """Each fault that the cell's kind plants under its own timed path:
    for dense, a step that leaves the state as it was, half of each batch
    left out, and one answer altered where it is produced."""
    plant(monkeypatch, kind_of(cell), fault)
    result = run_small(cell)
    assert result["correct"] is False


def test_the_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.api.fleet", "reprox", "jaxtyping",
         "repro", "repro.core.rng", "jax.numpy", "jaxlib", "flax.linen",
         "portbench.harness"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                   "repro", "repro.core.rng"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.pop("PYTEST_XDIST_WORKER", None)
    return env


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "from portbench import harness\n"
        "from portbench.test_portbench_harness import small\n"
        f"for cell in {CELLS!r}:\n"
        "    config, mix = small(cell)\n"
        "    r = harness.run_cell(harness.load_manifest(), cell, 5, 0.05,\n"
        "                         False, 'cpu', time.perf_counter(),\n"
        "                         config=config, mix=mix)\n"
        "    assert r['correct'], r\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_the_trace_summary_splits_busy_ops_and_idle_gaps():
    us = [  # name, kind, start us, end us, thread
        ("pb.window", "cpu", 0, 1000, 1),
        ("pb.call", "cpu", 10, 200, 1), ("aten::add", "cpu", 20, 30, 1),
        ("ingest_stream", "cpu", 15, 190, 1),
        # the device's copies of host spans, the benchmark's and the
        # program's: no operations, whatever their names
        ("pb.call", "cuda annotation", 25, 600, 0),
        ("ingest_stream", "cuda annotation", 25, 600, 0),
        ("void frugal_dense_kernel<3>(Args)", "cuda", 100, 600, 0),
        ("vectorized_elementwise_kernel", "cuda", 25, 60, 0),
        ("indexSelect", "cuda", 710, 720, 0),
    ]
    tr = devtrace.summarize(us)
    assert tr.busy_s == pytest.approx((35 + 500 + 10) / 1e6)
    assert tr.kernel("frugal_dense_kernel") == (1, pytest.approx(500e-6))
    assert set(tr.ops) == {"frugal_dense_kernel",
                           "vectorized_elementwise_kernel", "indexSelect"}
    # gap [0, 25] falls in the call, [60, 100] in the program's span
    # inside it, [600, 710] and [720, 1000] in the loop between calls
    assert tr.idle == {"pb.call": pytest.approx(25e-6),
                       "pb.call/ingest_stream": pytest.approx(40e-6),
                       "pb.window": pytest.approx(390e-6)}
    assert devtrace.summarize([("k", "cuda", 0, 1, 0)]) is None


def test_a_traced_run_reads_the_host_call_from_its_untraced_window(
        monkeypatch):
    """The profiler slows every host op, so the host metric comes from
    the run's first window, untraced; the span metrics from the second,
    recorded with the program's spans and under no profiler; and the
    device metrics from the third, profiled."""
    from repro_torch import tracing

    windows, summaries = [], []
    orig, summarize = harness._window, spans.summarize

    def record(driver, seconds, device, traced):
        n0 = driver.n
        out = orig(driver, seconds, device, traced)
        windows.append((traced, tracing._record is not None, driver.n - n0,
                        out))
        return out

    def keep(*a):
        summaries.append(summarize(*a))
        return summaries[-1]

    monkeypatch.setattr(harness, "_window", record)
    monkeypatch.setattr(spans, "summarize", keep)
    result = run_small(CELLS[0], trace=True)
    assert [w[:2] for w in windows] == [(False, False), (False, True),
                                        (True, False)]
    (_, _, _, (_, _, plain)), (_, _, recorded, _), \
        (_, _, _, (window_s, _, _)) = windows
    metrics = result["metrics"]
    got = metrics["fleet_call_host_ms"]["value"]
    assert got == pytest.approx(1e3 * sum(plain) / len(plain))
    (summary,) = summaries
    assert summary.batches == recorded and summary.dropped == 0
    assert metrics["stream_self_ms"]["value"] == summary.self_ms(
        ("fleet.ingest_stream", "stream.next_block"))
    assert result["device"]["window_s"] == window_s
    assert result["correct"] is True


MS = 1_000_000  # nanoseconds


def _record(kept, dropped=0):
    """A ``tracing.Record`` holding ``kept``: (name, parent, root, t0 ns,
    t1 ns), None for a span still open."""
    from repro_torch import tracing

    rec = tracing.Record()
    rec.spans = list(kept)
    rec.counts = {}
    for s in kept:
        if s is not None:
            rec.counts[s[0]] = rec.counts.get(s[0], 0) + 1
    rec.dropped = dropped
    return rec


# Two batches of the dense path's nesting, the second with two launches,
# and a span still open; times in ms.
DENSE_BATCHES = [
    ("fleet.ingest_stream", -1, 0, 0, 10), ("stream.next_block", 0, 0, 1, 2),
    ("ops.update_auto", 0, 0, 3, 9), ("ops.blocks", 2, 0, 3, 4),
    ("ops.pack", 2, 0, 4, 5), ("kernels.dense_launch", 2, 0, 5, 7),
    ("ops.unpack", 2, 0, 7, 8),
    ("fleet.ingest_stream", -1, 7, 20, 32),
    ("stream.next_block", 7, 7, 20.5, 21), ("ops.update_auto", 7, 7, 22, 31),
    ("ops.blocks", 9, 7, 22, 22.5), ("ops.pack", 9, 7, 22.5, 23),
    ("kernels.dense_launch", 9, 7, 23, 25),
    ("kernels.dense_launch", 9, 7, 25, 28), ("ops.unpack", 9, 7, 28, 29),
    None,
]


def _dense_record(dropped=0):
    return _record([s if s is None else
                    (*s[:3], int(s[3] * MS), int(s[4] * MS))
                    for s in DENSE_BATCHES], dropped)


def test_the_span_summary_reads_totals_self_times_and_the_first_launch():
    sp = spans.summarize(_dense_record(), 2)
    assert sp.counts == {"fleet.ingest_stream": 2, "stream.next_block": 2,
                          "ops.update_auto": 2, "ops.blocks": 2,
                          "ops.pack": 2, "kernels.dense_launch": 3,
                          "ops.unpack": 2}
    assert sp.total_s == pytest.approx({
        "fleet.ingest_stream": 22e-3, "stream.next_block": 1.5e-3,
        "ops.update_auto": 15e-3, "ops.blocks": 1.5e-3, "ops.pack": 1.5e-3,
        "kernels.dense_launch": 7e-3, "ops.unpack": 2e-3})
    # root: 10 - (1 + 6) and 12 - (0.5 + 9); update_auto: 6 - 5, 9 - 7
    assert sp.self_s == pytest.approx({
        "fleet.ingest_stream": 5.5e-3, "stream.next_block": 1.5e-3,
        "ops.update_auto": 3e-3, "ops.blocks": 1.5e-3, "ops.pack": 1.5e-3,
        "kernels.dense_launch": 7e-3, "ops.unpack": 2e-3})
    # the first launch ends 7 ms and 5 ms after its root starts
    assert sp.lead_ms("fleet.ingest_stream",
                      "kernels.dense_launch") == pytest.approx(6.0)
    assert sp.entry_ms("kernels.dense_launch") == pytest.approx(7 / 3)
    assert sp.self_ms(("ops.pack", "ops.unpack")) == pytest.approx(1.75)
    assert sp.dropped == 0
    assert sp.self_ms(("ops.update_sparse",)) is None
    full = spans.summarize(_dense_record(dropped=1), 2)
    assert full.self_ms(("ops.pack",)) is None
    assert full.entry_ms("kernels.dense_launch") is None
    assert full.lead_ms("fleet.ingest_stream", "kernels.dense_launch") is None


SPAN_READERS = {"prelaunch_host_ms": 6.0, "stream_self_ms": (5.5 + 1.5) / 2,
                "entry_self_ms": (3 + 1.5 + 1.5 + 2) / 2,
                "launch_host_ms": 7 / 3}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_on_a_recorded_window(name):
    """Each reader on the hand-built window, and None where the window
    has no spans, a span it names is missing, or spans were dropped."""
    read = harness._load_module("metrics", name).read
    sp = spans.summarize(_dense_record(), 2)
    assert read(types.SimpleNamespace(spans=sp)) == pytest.approx(
        SPAN_READERS[name])
    assert read(types.SimpleNamespace(spans=None)) is None
    dropped = spans.summarize(_dense_record(dropped=3), 2)
    assert read(types.SimpleNamespace(spans=dropped)) is None
    roots_only = spans.summarize(_record(
        [("fleet.ingest_stream", -1, 0, 0, 10 * MS)]), 1)
    assert read(types.SimpleNamespace(spans=roots_only)) is None


def test_a_program_counter_is_read_across_the_recorded_window(monkeypatch):
    """A counter that the kind names is read before and after the
    recorded window alone: a planted one, bumped once a chunk, moves by
    that window's batches, not by all that came before."""
    from repro_torch.core import streaming

    cell = CELLS[0]
    kind = types.SimpleNamespace(**vars(kind_of(cell)))
    kind.COUNTERS = (("core.streaming", "chunks_applied"),)
    mix = harness._load_json("traffic", _workload(cell)["traffic"])
    serve_files(monkeypatch, {("kinds", mix["kind"]): kind})
    monkeypatch.setattr(streaming, "chunks_applied", 0, raising=False)
    apply_chunk = streaming._apply_chunk

    def counted(*a, **k):
        streaming.chunks_applied += 1
        return apply_chunk(*a, **k)

    monkeypatch.setattr(streaming, "_apply_chunk", counted)
    windows, window = [], harness.Window
    monkeypatch.setattr(harness, "Window", lambda **kw: (
        windows.append(window(**kw)) or windows[-1]))
    assert run_small(cell, trace=True)["correct"] is True
    (run,) = windows
    moved = run.counters["core.streaming.chunks_applied"]
    assert moved == run.spans.batches > 0
    assert streaming.chunks_applied > moved + run.batches
    assert run_small(cell)["correct"] is True
    assert windows[-1].counters is None and windows[-1].spans is None


# A kind that no file of ``kinds/`` holds: events on the per-lane clock,
# through ``QuantileFleet.tick_lanes_sparse`` and
# ``kernels.ops.frugal_update_sparse``, a path on which the dense kind's
# faults never run. It brings its own configuration, mix, faults and CPU
# sizes, and two metric readers: of a span and of a program counter that
# the sparse path does not have yet, which the fixture plants where a
# later change to the program would put them.


def _events_reference(prog, planes, ticks, lanes, items, seed, quantiles,
                      dtype):
    """Apply sorted events to the planes in ``dtype``: round i takes the
    i-th event of each lane's run, each coin keyed on (seed, the lane's
    own tick, the lane). Returns float32 planes and the clocks."""
    planes = [p.to(dtype) for p in planes]
    ticks = ticks.clone()
    lanes = lanes.long()
    pos = torch.arange(lanes.shape[0], device=lanes.device)
    head = torch.ones_like(lanes, dtype=torch.bool)
    head[1:] = lanes[1:] != lanes[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
    q = reference.lane_quantiles(quantiles, torch.arange(
        planes[0].shape[0], device=lanes.device)).to(dtype)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        idx = lanes[sel]
        u = reference.uniform(reference.tick_hash(seed, ticks[idx].long()),
                              reference.lane_key(idx)).to(dtype)
        out = prog.tick(tuple(p[idx] for p in planes), items[sel].to(dtype),
                        u, q[idx])
        for p, o in zip(planes, out):
            p[idx] = o
        ticks[idx] += 1
    return tuple(p.to(torch.float32) for p in planes), ticks


class EventsDriver:
    """Each batch ``events`` (lane, item) pairs, the lanes drawn from the
    seed and sorted so that each lane's events are adjacent (the run
    contract), handed to ``tick_lanes_sparse`` (which keeps the fleet
    before it). The check applies the window's last batch to the fleet's
    state before it and compares planes and clocks bit for bit."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.quantiles = tuple(float(q) for q in ctx.config["quantiles"])
        self.lanes = int(ctx.config["num_groups"]) * len(self.quantiles)
        self.items_per_batch = int(ctx.mix["events"])
        self.prog = reference.load_program(ctx.config["program"])
        self.n = 0

    def setup(self):
        from repro_torch.api import FleetSpec, QuantileFleet

        ctx, cfg, k = self.ctx, self.ctx.config, self.items_per_batch
        spec = FleetSpec(num_groups=int(cfg["num_groups"]),
                         quantiles=self.quantiles, program=cfg["program"],
                         backend=cfg["backend"])
        self.fleet = QuantileFleet.create(spec, init=float(cfg["init"]),
                                          seed=ctx.fleet_seed,
                                          per_lane_clock=True,
                                          device=ctx.device)
        self.ring = []
        for _ in range(int(ctx.mix["ring"])):
            lanes = torch.randint(self.lanes, (k,), generator=ctx.gen,
                                  device=ctx.device)
            items = traffic._values(ctx.gen, ctx.mix["value"], (k,),
                                    ctx.device)
            order = torch.argsort(lanes, stable=True)
            self.ring.append((lanes[order].to(torch.int32), items[order]))
        for _ in range(int(ctx.mix["warmup_batches"])):
            self.submit()

    def submit(self):
        lanes, items = self.ring[self.n % len(self.ring)]
        self.prev = self.fleet
        self.fleet = self.fleet.tick_lanes_sparse(lanes, items)
        self.n += 1

    def work(self) -> dict:
        return {}

    def _planes(self, fleet):
        return tuple(getattr(fleet.state, f) for f in self.prog.PLANES)

    def check(self, control: bool) -> dict:
        lanes, items = self.ring[(self.n - 1) % len(self.ring)]
        start = (self.prog, self._planes(self.prev), self.prev.cursor.t_offset,
                 lanes, items, self.ctx.fleet_seed, self.quantiles)
        want, want_ticks = _events_reference(*start, torch.float32)
        if control:
            got, got_ticks = _events_reference(*start,
                                               reference.CONTROL_DTYPE)
        else:
            got = self._planes(self.fleet)
            got_ticks = self.fleet.cursor.t_offset
        return {"lanes_differ": (reference.lanes_differ(got, want), 0),
                "clocks_differ": (int((got_ticks != want_ticks).sum()), 0)}


def _unchanged_events(orig):
    return lambda lanes, items, mask, planes, ticks, *a, **k: (
        tuple(planes), ticks)


def _half_events(orig):
    def f(lanes, items, mask, *a, **k):
        h = lanes.shape[0] // 2
        return orig(lanes[:h], items[:h], None if mask is None else mask[:h],
                    *a, **k)
    return f


def _altered_events(orig):
    def f(lanes, *a, **k):
        planes, ticks = orig(lanes, *a, **k)
        planes[0][lanes[0]] += 1.0
        return planes, ticks
    return f


EVENTS = types.SimpleNamespace(
    Driver=EventsDriver,
    CPU_SIZE={"config": {"num_groups": 37}, "mix": {"events": 64}},
    CPU_SIZE_CONTROL={"config": {"num_groups": 2000}, "mix": {"events": 8192}},
    FAULTS={"unchanged": ("kernels.ops", "frugal_update_sparse",
                          _unchanged_events),
            "half": ("kernels.ops", "frugal_update_sparse", _half_events),
            "altered": ("kernels.ops", "frugal_update_sparse",
                        _altered_events)},
    LAUNCHES_PER_BATCH=1,
    COUNTERS=(("kernels.ops", "sparse_events"),))

EVENTS_MANIFEST = dict(
    MANIFEST,
    workloads=[{"name": "g-2u-q2.test-events", "config": "test-2u-q2",
                "traffic": "test-events", "chips": 1,
                "why": "events on the per-lane clock, a kind of the tests"}],
    per_layer=[
        {"name": "sparse_update_host_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "entry points",
         "moves": "items_per_s"},
        {"name": "sparse_events_per_batch", "unit": "events",
         "better": "higher", "source": "program_counter",
         "layer": "entry points", "moves": "items_per_s"}])


def _instrumented(orig):
    """The sparse entry with the span and counter it does not have yet."""
    from repro_torch import tracing
    from repro_torch.kernels import ops

    def f(lanes, *a, **k):
        with tracing.span("ops.update_sparse"):
            ops.sparse_events += lanes.shape[0]
            return orig(lanes, *a, **k)
    return f


@pytest.fixture
def events_files(monkeypatch):
    """The kind's files, served to the harness by name."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "sparse_events", 0, raising=False)
    monkeypatch.setattr(ops, "frugal_update_sparse",
                        _instrumented(ops.frugal_update_sparse))
    serve_files(monkeypatch, {
        ("configs", "test-2u-q2"): {
            "name": "test-2u-q2", "num_groups": 4096,
            "quantiles": [0.5, 0.9], "program": "2u", "backend": "fused",
            "init": 0.0},
        ("traffic", "test-events"): {
            "kind": "test-events", "events": 65536, "ring": 2,
            "warmup_batches": 2,
            "value": {"dist": "cauchy", "x0": 10000.0, "gamma": 1250.0}},
        ("kinds", "test-events"): EVENTS,
        ("metrics", "sparse_update_host_ms"): types.SimpleNamespace(
            read=lambda run: None if run.spans is None
            else run.spans.entry_ms("ops.update_sparse")),
        ("metrics", "sparse_events_per_batch"): types.SimpleNamespace(
            read=lambda run: None if run.spans is None else
            run.counters["kernels.ops.sparse_events"] / run.spans.batches)})
    return EVENTS_MANIFEST["workloads"][0]["name"]


@pytest.mark.parametrize("case", ["sound", "control", *sorted(EVENTS.FAULTS)])
def test_a_kind_of_new_files_runs_through_the_harness(case, events_files,
                                                      monkeypatch):
    """A traced run of the kind reads ``correct`` and its readers return
    their values; its control and each of its planted faults read not
    ``correct``. Nothing of the harness or of the dense kind changes."""
    if case in EVENTS.FAULTS:
        plant(monkeypatch, EVENTS, case)
    result = run_small(events_files, control=case == "control",
                       trace=case == "sound", manifest=EVENTS_MANIFEST)
    assert result["correct"] is (case == "sound")
    if case == "sound":
        metrics = result["metrics"]
        assert metrics["sparse_events_per_batch"]["value"] == 64
        assert metrics["sparse_update_host_ms"]["value"] > 0
        assert all(c["value"] == 0 for c in result["checks"].values())
    else:
        assert any(c["value"] > c["limit"]
                   for c in result["checks"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest -q "
                    "-m cuda portbench)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_traced_run_on_the_card(cell, card):
    config, mix = small(cell)
    result = harness.run_cell(MANIFEST, cell, 2 ** 31 + 3, 0.5, True, card,
                              time.perf_counter(), config=config, mix=mix)
    assert result["correct"] is True
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["metrics"]["launches_per_batch"]["value"] == \
        kind_of(cell).LAUNCHES_PER_BATCH
    assert set(result["metrics"]) == {m["name"] for m in MANIFEST["per_layer"]
                                      if harness._applies(m, cell)}
