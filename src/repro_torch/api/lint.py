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

The JAX package's third check, ``check_topology_spellings``, guards the
placement surface, which the port does not have yet (ROADMAP.md queue A,
item 2).

    python -m repro_torch.api.lint
"""
from __future__ import annotations

import importlib
import pkgutil
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


def main() -> None:
    exported = check_public_api()
    total = sum(len(v) for v in exported.values())
    print(f"public API OK: {total} exports across {len(exported)} "
          "subpackages resolve")
    families = check_programs()
    print(f"lane programs OK: {len(families)} registered families validate "
          f"({', '.join(families)})")


if __name__ == "__main__":
    main()
