"""Public-API lint: exports must resolve, lane programs must be whole.

``import repro_torch.x`` alone never checks an ``__all__`` (Python reads it
only on ``from x import *``). ``check_public_api`` imports every
subpackage of the port (packages only) and getattr-checks each
``__all__`` entry; importing them builds no kernel (the CUDA sources
compile at a wrapper's first launch on a card).

``check_programs`` validates the LaneProgram registry
(``core.program.validate_registry``): each registered family's canonical
instance must declare a packing spec that enumerates its planes, a query
that answers, scalar slots that match its tick, and an invariant domain
for every plane field, from which lane health is derived.

``check_topology_spellings`` scans the repository's sources for the
deprecated placement spelling (backend="sharded" or mesh= inside a
FleetSpec call); ``topology=TopologySpec(...)`` is the one spelling.

    python -m repro_torch.api.lint
"""
from __future__ import annotations

import importlib
import os
import pkgutil
import re
from typing import Dict, List, Tuple


def iter_subpackages(package: str = "repro_torch"):
    """Yield (name, module) for ``package`` and every subpackage under
    it."""
    pkg = importlib.import_module(package)
    yield package, pkg
    for info in pkgutil.walk_packages(pkg.__path__, prefix=package + "."):
        if info.ispkg:
            yield info.name, importlib.import_module(info.name)


def check_public_api(package: str = "repro_torch") -> Dict[str, List[str]]:
    """Import every subpackage; assert each ``__all__`` name resolves.

    Returns {subpackage: sorted __all__}. Raises AssertionError naming
    every drifted export, not just the first.
    """
    exported: Dict[str, List[str]] = {}
    problems: List[Tuple[str, str]] = []
    # Import them all first: an ``__all__`` may name a subpackage, which
    # ``from package import *`` imports and a bare import does not.
    for name, mod in list(iter_subpackages(package)):
        names = getattr(mod, "__all__", None)
        if names is None:
            continue
        exported[name] = sorted(names)
        for n in names:
            if not hasattr(mod, n):
                problems.append((name, n))
    if problems:
        lines = "\n".join(f"  {pkg}.__all__ exports {n!r} which does not "
                          "resolve" for pkg, n in problems)
        raise AssertionError(f"public-API export drift:\n{lines}")
    return exported


def check_programs() -> Tuple[str, ...]:
    """Validate every registered LaneProgram family; raises AssertionError
    naming a broken one, returns the family names checked."""
    from repro_torch.core import program as program_mod

    return program_mod.validate_registry()


# The deprecated placement spelling inside a FleetSpec(...) call span:
# backend="sharded" or any mesh= keyword ((?!=) keeps `mesh ==` out).
# Engine spellings backend="jnp"/"fused" are not placements.
_DEPRECATED_SPELLING = re.compile(
    r"backend\s*=\s*['\"]sharded['\"]|\bmesh\s*=(?!=)")
# Files that legitimately spell the deprecated form: the shims, the lints
# and the JAX package's test of its warning.
_SPELLING_ALLOWLIST = frozenset({
    "src/repro/api/spec.py",
    "src/repro/api/lint.py",
    "tests/test_deprecations.py",
    "src/repro_torch/api/spec.py",
    "src/repro_torch/api/lint.py",
})
_TRIPLE_STRING = re.compile(r"('''|\"\"\")(?:.|\n)*?\1")
_LINE_COMMENT = re.compile(r"#[^\n]*")


def _strip_prose(text: str) -> str:
    """Blank out triple-quoted strings and # comments (newlines kept, so
    line numbers stay true): prose may describe the deprecated spelling,
    code may not use it."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))

    return _LINE_COMMENT.sub(blank, _TRIPLE_STRING.sub(blank, text))


def _fleet_spec_spans(text: str):
    """Yield (offset, argument text) of each FleetSpec(...) call in
    ``text`` (prose stripped), the span found by balancing parentheses."""
    for m in re.finditer(r"\bFleetSpec\s*\(", text):
        depth, i = 1, m.end()
        while i < len(text) and depth:
            if text[i] == "(":
                depth += 1
            elif text[i] == ")":
                depth -= 1
            i += 1
        yield m.start(), text[m.end():i - 1]


def check_topology_spellings(root: str = None) -> int:
    """Assert that no FleetSpec(...) call in the repository's sources
    (src/, tests/, benchmarks/, examples/) uses the deprecated
    backend="sharded" / mesh= placement spelling; the shim exists for
    outside callers only. Returns the number of files scanned; raises
    AssertionError listing every offending file:line."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    offenders: List[str] = []
    scanned = 0
    for top in ("src", "tests", "benchmarks", "examples"):
        base = os.path.join(root, top)
        if not os.path.isdir(base):
            continue
        for dirpath, _, files in os.walk(base):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                if rel in _SPELLING_ALLOWLIST:
                    continue
                with open(path, encoding="utf-8") as f:
                    text = _strip_prose(f.read())
                scanned += 1
                for pos, span in _fleet_spec_spans(text):
                    if _DEPRECATED_SPELLING.search(span):
                        line = text.count("\n", 0, pos) + 1
                        offenders.append(f"  {rel}:{line}")
    if offenders:
        raise AssertionError(
            "deprecated placement spelling in the repository (use "
            "topology=TopologySpec(...) — DESIGN.md §9):\n"
            + "\n".join(offenders))
    return scanned


def main() -> None:
    exported = check_public_api()
    total = sum(len(v) for v in exported.values())
    print(f"public API OK: {total} exports across {len(exported)} "
          "subpackages resolve")
    families = check_programs()
    print(f"lane programs OK: {len(families)} registered families validate "
          f"({', '.join(families)})")
    scanned = check_topology_spellings()
    print(f"topology spellings OK: {scanned} source files free of the "
          "deprecated backend='sharded'/mesh= placement spelling")


if __name__ == "__main__":
    main()
