"""Production and test meshes (port of the JAX package's
``launch/mesh.py``).

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; 'pod' is the slow
axis between pods (data parallel across pods).

The port places from one controller process: a mesh is a numpy object
array of ``torch.device``s with named axes (``parallel/topology.py``'s
placement model). Its production meshes default to repeated
``torch.device("meta")`` placeholders, the counterpart of the JAX
package's forced host device count: the dry run prices a 256/512-device
mesh without a device, and needs no flag set before an import.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device axes: ``devices`` an object array of ``torch.device``s
    (a device may repeat), ``axis_names`` one name per axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _device_array(devices: Sequence, shape) -> np.ndarray:
    out = np.empty(len(devices), dtype=object)
    out[:] = [torch.device(d) for d in devices]
    return out.reshape(shape)


def make_production_mesh(multi_pod: bool = False, devices=None) -> Mesh:
    """The (16, 16) or (2, 16, 16) mesh over ``devices`` (None: 256 or
    512 ``meta`` placeholders, the dry run's; else at least that many)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    devices = [torch.device("meta")] * n if devices is None \
        else list(devices)[:n]
    if len(devices) < n:
        raise RuntimeError(f"production mesh needs {n} devices, found "
                           f"{len(devices)}")
    return Mesh(_device_array(devices, shape), axes)


def make_test_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A (n // model, model) mesh, model the largest of 4, 2, 1 dividing
    n: over the visible CUDA devices (n of them; None: all), or over
    ``device`` repeated n times (None: once), as the tests place on
    ``"cpu"``."""
    if device is None:
        avail = torch.cuda.device_count()
        n = n_devices or avail
        if n < 1 or avail < n:
            raise RuntimeError(f"a test mesh of {n} CUDA devices needs "
                               f"them; {avail} visible (pass device=)")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n = n_devices or 1
        devices = [torch.device(device)] * n
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return Mesh(_device_array(devices, (n // model, model)),
                ("data", "model"))


def mesh_info(mesh: Mesh) -> dict:
    return {
        "axes": dict(mesh.shape),
        "n_devices": mesh.size,
        "multi_pod": "pod" in mesh.shape,
    }


__all__ = ["Mesh", "make_production_mesh", "make_test_mesh", "mesh_info"]
