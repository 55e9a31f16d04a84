"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``, the port's card run) imports JAX or the JAX package
``repro``, at run time or in its sources."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")
IMPORT = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                    r"(\.|\s))", re.MULTILINE)


def port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), SRC)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_every_module_loads_neither_jax_nor_repro():
    mods = port_modules()
    for m in ("repro_torch.kernels.frugal_update", "repro_torch.kernels.ops",
              "repro_torch.api.fleet", "repro_torch.serve",
              "repro_torch.serve.slo", "repro_torch.resilience.chaos",
              "repro_torch.resilience.health",
              "repro_torch.train.checkpoint", "repro_torch.data",
              "repro_torch.data.streams", "repro_torch.data.pipeline",
              "repro_torch.service", "repro_torch.service.telemetry",
              "repro_torch.service.snapshot", "repro_torch.service.pipeline",
              "repro_torch.service.server"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_no_jax_or_repro_import():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, fn) for fn in files
                  if fn.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for m in IMPORT.finditer(f.read()):
                offenders.append(f"{path}: {m.group(0).strip()}")
    assert len(paths) > 20 and not offenders, offenders
