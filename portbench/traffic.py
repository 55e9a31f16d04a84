"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<mix>.json``) and makes its batches on the device from the
seed, during set-up.

Kind ``dense``: ``ring`` blocks of [``rows``, G] float32 items, one item a
group and row; block b is batch b mod ``ring``.

Values: ``{"dist": "cauchy", "x0", "gamma"}``, every item drawn on its own
from the Cauchy law of median ``x0`` and scale ``gamma``.
"""
from __future__ import annotations

from typing import List

import torch


def _values(gen, spec: dict, shape, device) -> torch.Tensor:
    if spec["dist"] != "cauchy":
        raise ValueError(f"unknown value distribution {spec['dist']!r}")
    return torch.empty(shape, dtype=torch.float32, device=device).cauchy_(
        float(spec["x0"]), float(spec["gamma"]), generator=gen)


def dense_ring(mix: dict, groups: int, gen, device) -> List[torch.Tensor]:
    return [_values(gen, mix["value"], (int(mix["rows"]), groups), device)
            for _ in range(int(mix["ring"]))]
