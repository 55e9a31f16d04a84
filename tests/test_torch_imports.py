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
              "repro_torch.service.server", "repro_torch.core.reference",
              "repro_torch.core.baselines", "repro_torch.core.baselines.gk",
              "repro_torch.core.baselines.qdigest",
              "repro_torch.core.baselines.selection",
              "repro_torch.core.baselines.reservoir",
              "repro_torch.core.baselines.exact",
              "repro_torch.core.baselines.protocol",
              "repro_torch.api.estimators", "repro_torch.api.lint",
              "repro_torch.kernels.ref", "repro_torch.parallel",
              "repro_torch.parallel.topology", "repro_torch.parallel.mesh2d",
              "repro_torch.parallel.group_sharding",
              "repro_torch.train.elastic", "repro_torch.roofline",
              "repro_torch.roofline.analysis",
              "repro_torch.roofline.kernel_model",
              "repro_torch.roofline.autotune", "repro_torch.roofline.report",
              "repro_torch.configs", "repro_torch.configs.platform",
              "repro_torch.models", "repro_torch.models.config",
              "repro_torch.models.blocks", "repro_torch.models.causal_lm",
              "repro_torch.models.model", "repro_torch.models.convert",
              "repro_torch.models.encdec",
              "repro_torch.models.layers",
              "repro_torch.models.layers.attention",
              "repro_torch.models.layers.norm",
              "repro_torch.models.layers.rope",
              "repro_torch.models.layers.embedding",
              "repro_torch.models.layers.mlp",
              "repro_torch.models.layers.moe",
              "repro_torch.models.layers.mla",
              "repro_torch.models.layers.mamba2",
              "repro_torch.models.layers.rwkv6", "repro_torch.serve.engine",
              "repro_torch.launch", "repro_torch.launch.serve",
              "repro_torch.configs.qwen2_vl_2b",
              "repro_torch.configs.zamba2_2p7b", "repro_torch.configs.yi_6b",
              "repro_torch.configs.minitron_4b",
              "repro_torch.configs.gemma2_9b",
              "repro_torch.configs.granite_20b",
              "repro_torch.configs.deepseek_v2_lite",
              "repro_torch.configs.olmoe_1b_7b",
              "repro_torch.configs.whisper_large_v3",
              "repro_torch.configs.rwkv6_1p6b", "repro_torch.optim",
              "repro_torch.optim.optimizer", "repro_torch.optim.schedule",
              "repro_torch.optim.clipping", "repro_torch.monitor",
              "repro_torch.monitor.registry",
              "repro_torch.monitor.moe_stats", "repro_torch.train",
              "repro_torch.train.train_state", "repro_torch.train.steps",
              "repro_torch.train.trainer", "repro_torch.launch.train",
              "repro_torch.core.batched", "repro_torch.launch.mesh",
              "repro_torch.launch.specs", "repro_torch.launch.dryrun",
              "repro_torch.parallel.sharding",
              "repro_torch.parallel.compression",
              "repro_torch.roofline.trace_cost"):
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


def test_every_jax_module_has_a_counterpart_but_two():
    """``comm`` of the two trees' ``*.py`` lists: only the removed
    ``parallel/pipeline_parallel.py`` stubs and ``roofline/hlo_parse.py``
    (XLA HLO text; ``roofline/trace_cost.py`` takes its place) have no
    counterpart in the port."""
    def modules(pkg):
        root = os.path.join(SRC, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}

    missing = modules("repro") - modules("repro_torch")
    assert missing == {os.path.join("parallel", "pipeline_parallel.py"),
                       os.path.join("roofline", "hlo_parse.py")}, missing
