"""The harness at small sizes on the CPU: the manifest and its files, the
result line, the import check, the control and the planted faults, which
must all read ``correct`` false; and on the card, a small run of each
kind of traffic."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import devtrace, harness

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def small(cell, groups=37):
    """The cell's configuration and mix at a size the CPU runs in a blink,
    every other parameter as the files give it."""
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    config = dict(harness._load_json("configs", w["config"]),
                  num_groups=groups)
    mix = dict(harness._load_json("traffic", w["traffic"]), rows=8, ring=2,
               warmup_batches=2)
    return config, mix


def run_small(cell, seed=2 ** 31 + 11, control=False, trace=False,
              groups=37):
    config, mix = small(cell, groups)
    return harness.run_cell(MANIFEST, cell, seed, 0.15, trace, "cpu",
                            time.perf_counter(), config=config, mix=mix,
                            control=control)


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
    result = run_small(cell, control=True, groups=2000)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _unchanged_dense(orig):
    return lambda sk, chunk, *a, **k: sk


def _half_dense(orig):
    return lambda sk, chunk, *a, **k: orig(sk, chunk[:chunk.shape[0] // 2],
                                           *a, **k)


def _altered_dense(orig):
    def f(*a, **k):
        planes = orig(*a, **k)
        planes[0][0] += 1.0
        return planes
    return f


DENSE_FAULTS = {"unchanged": ("core.streaming", "_apply_chunk",
                              _unchanged_dense),
                "half": ("core.streaming", "_apply_chunk", _half_dense),
                "altered": ("kernels.ops", "frugal_update_auto",
                            _altered_dense)}


@pytest.mark.parametrize("fault", sorted(DENSE_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_reads_not_correct(cell, fault,
                                                        monkeypatch):
    """A step that leaves the state as it was, half of each batch left
    out, and one answer altered where it is produced."""
    import importlib

    module, name, make = DENSE_FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.{module}")
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
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
    the run's first window, and the device metrics from the second."""
    windows = []
    orig = harness._window

    def record(driver, seconds, device, traced):
        out = orig(driver, seconds, device, traced)
        windows.append((traced, out))
        return out

    monkeypatch.setattr(harness, "_window", record)
    result = run_small(CELLS[0], trace=True)
    assert [traced for traced, _ in windows] == [False, True]
    (_, (_, _, plain)), (_, (window_s, traced_ms, _)) = windows
    got = result["metrics"]["fleet_call_host_ms"]["value"]
    assert got == pytest.approx(1e3 * sum(plain) / len(plain))
    assert result["device"]["window_s"] == window_s
    assert result["correct"] is True


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
    assert result["metrics"]["launches_per_batch"]["value"] == 1.0
