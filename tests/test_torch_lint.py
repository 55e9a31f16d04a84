"""The port's public-API lint (``repro_torch.api.lint``): every
``__all__`` of every subpackage resolves, a drifted export is caught and
named, the lane-program registry validates as the JAX package's does, the
walk imports no leaf module and builds no kernel, and
``python -m repro_torch.api.lint`` passes."""
import os
import subprocess
import sys

import pytest

from repro_torch.api.lint import (check_programs, check_public_api,
                                  check_topology_spellings, iter_subpackages)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT_PACKAGES = ("repro_torch", "repro_torch.api", "repro_torch.core",
                 "repro_torch.core.baselines", "repro_torch.kernels",
                 "repro_torch.serve", "repro_torch.service",
                 "repro_torch.resilience", "repro_torch.data",
                 "repro_torch.parallel")


def test_every_dunder_all_name_resolves():
    exported = check_public_api("repro_torch")
    for pkg in PORT_PACKAGES:
        assert pkg in exported and exported[pkg], f"{pkg} exports nothing?"


def test_walker_sees_only_packages():
    names = [name for name, _ in iter_subpackages()]
    assert "repro_torch.core.baselines" in names
    assert "repro_torch.api.lint" not in names
    assert "repro_torch.kernels.build" not in names


@pytest.mark.parametrize("pkg", ["repro_torch.api", "repro_torch.core",
                                 "repro_torch.core.baselines"])
def test_drift_is_reported_with_package_and_name(monkeypatch, pkg):
    import importlib

    mod = importlib.import_module(pkg)
    monkeypatch.setattr(mod, "__all__", list(mod.__all__) +
                        ["NotARealExport"])
    with pytest.raises(AssertionError,
                       match=rf"{pkg}.__all__ exports 'NotARealExport'"):
        check_public_api("repro_torch")


def test_programs_validate_as_in_jax():
    from repro.api.lint import check_programs as jax_check_programs

    assert check_programs() == jax_check_programs() == (
        "1u", "2u", "2u-decay", "1u-window", "2u-window", "2u-dp")


def test_api_exports_match_jax():
    import repro.api as japi
    import repro_torch.api as tapi

    # from_jax_state is the port's own.
    assert set(japi.__all__) == set(tapi.__all__) - {"from_jax_state"}


def test_topology_spellings_scan_the_tree_as_jax_does(tmp_path):
    """The port's source scan passes on the tree and counts what the JAX
    package's does (both skip their own shims), and names a FleetSpec call
    that spells the deprecated placement, in code but not in prose."""
    from repro.api.lint import check_topology_spellings as jax_check

    assert check_topology_spellings() == jax_check() - 2
    # The sources are assembled so that this file spells no offending
    # call itself (both lints scan it).
    spec = "Fleet" + "Spec("
    src = tmp_path / "src"
    src.mkdir()
    (src / "ok.py").write_text(
        f'{spec}num_groups=2, backend="jnp")\n'
        f'# {spec}backend="sharded")\n'
        f'"""{spec}num_groups=2, mesh=m)"""\n'
        f'x = {spec}num_groups=2, topology=t) if mesh == 1 else None\n')
    assert check_topology_spellings(str(tmp_path)) == 1
    (src / "bad.py").write_text(
        f'a = 1\nspec = {spec}num_groups=4,\n'
        '                 backend="sharded")\n'
        f'{spec}num_groups=2, mesh=devices)\n')
    with pytest.raises(AssertionError, match=r"src/bad.py:2\n  src/bad.py:4"):
        check_topology_spellings(str(tmp_path))


def test_lint_main_builds_nothing():
    """``python -m repro_torch.api.lint`` passes, with every way to start
    a compiler (a child process) made to fail: importing every subpackage
    builds no kernel."""
    code = (
        "import runpy, subprocess, sys, warnings\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'started a process: {a!r}')\n"
        "subprocess.Popen.__init__ = refuse\n"
        "warnings.simplefilter('ignore', RuntimeWarning)\n"
        "runpy.run_module('repro_torch.api.lint', run_name='__main__')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("public API OK:")
    assert lines[1].startswith("lane programs OK: 6 registered families")
    assert lines[2].startswith("topology spellings OK:")
    assert lines[-1] == "[]"
