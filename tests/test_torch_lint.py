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
                                  iter_subpackages)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT_PACKAGES = ("repro_torch", "repro_torch.api", "repro_torch.core",
                 "repro_torch.core.baselines", "repro_torch.kernels",
                 "repro_torch.serve", "repro_torch.service",
                 "repro_torch.resilience", "repro_torch.data")


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

    # The placement surface waits for the parallel/ port; from_jax_state
    # is the port's own.
    assert set(japi.__all__) - {"TopologySpec",
                                "check_topology_spellings"} == \
        set(tapi.__all__) - {"from_jax_state"}


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
    assert lines[-1] == "[]"
