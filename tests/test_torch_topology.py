"""Placement across ``torch.distributed`` ranks: the port's counterpart of
``tests/test_fault_tolerance.py::test_jax_distributed_two_process_smoke``.

The JAX smoke runs 2 processes x 2 forced host devices under
``jax.distributed`` and resolves a (2, 2) mesh over the 4 global devices.
Here 4 gloo ranks with no CUDA device contribute one ``cpu`` device each:
the same global view of 4 devices. Each rank resolves
``TopologySpec(data=2, lanes=2)`` against the gathered list, and every
fleet refuses the topology (it holds other ranks' devices). Without a
process group ``resolve()`` reads the local CUDA devices as before.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.parallel.topology import (RankDevice, TopologySpec,
                                           local_devices)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
WORLD = 4
INIT_TIMEOUT_S = 60
RUN_TIMEOUT_S = 180

RANK_SCRIPT = r"""
import datetime, sys
port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=int(sys.argv[4])))
from repro_torch.api import FleetSpec, QuantileFleet
from repro_torch.core.sketch import GroupedQuantileSketch
from repro_torch.parallel.group_sharding import ShardedGroupFleet
from repro_torch.parallel.mesh2d import Mesh2DFleet
from repro_torch.parallel.topology import (RankDevice, TopologySpec,
                                           local_devices)

gathers = 0
gather = dist.all_gather_object
def counted(*a, **k):
    global gathers
    gathers += 1
    return gather(*a, **k)
dist.all_gather_object = counted

topo = TopologySpec(data=2, lanes=2).resolve()
assert topo.on_devices and topo.num_devices == 4, topo
assert topo.devices == tuple(RankDevice(r, torch.device("cpu"))
                             for r in range(world)), topo.devices
mesh = topo.mesh2d()
assert mesh.shape == (2, 2), mesh.shape
assert [d.rank for d in mesh.reshape(-1)] == list(range(world))
lanes = TopologySpec(lanes=4).resolve()
assert lanes.mesh1d().shape == (4,) and lanes.devices == topo.devices
assert gathers == 1, gathers
mine = RankDevice(rank, torch.device("cpu"))
assert local_devices((mine, "cpu")) == (torch.device("cpu"),) * 2

# every fleet refuses a topology holding another rank's devices
sk = GroupedQuantileSketch.create(8, device="cpu")
for make in (
        lambda: QuantileFleet.create(FleetSpec(num_groups=8, topology=topo)),
        lambda: QuantileFleet.create(FleetSpec(num_groups=8,
                                               topology=lanes)),
        lambda: Mesh2DFleet.from_sketch(sk, topo),
        lambda: ShardedGroupFleet.from_sketch(sk, lanes.devices)):
    try:
        make()
    except ValueError as e:
        assert "a rank-aware fleet is not ported" in str(e), e
    else:
        raise AssertionError("a fleet took another rank's devices")
dist.barrier()
dist.destroy_process_group()
print("TOPOLOGY_OK", rank)
"""


def test_four_gloo_ranks_resolve_the_global_device_list(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, str(script), port, str(r), str(WORLD),
         str(INIT_TIMEOUT_S)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=RUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        assert f"TOPOLOGY_OK {r}" in out, f"rank {r}: {out!r}"


def test_resolve_without_a_process_group_reads_the_local_cuda_devices():
    assert not dist.is_initialized()
    n = torch.cuda.device_count()
    two = TopologySpec(data=2, lanes=2).resolve()
    if n >= 4:
        assert two.devices == tuple(torch.device("cuda", i)
                                    for i in range(4))
    else:
        assert two.devices is None and not two.on_devices
        with pytest.raises(ValueError, match="loop-fallback"):
            two.mesh2d()
    if n < 2:
        with pytest.raises(ValueError, match=f"found {n} CUDA device"):
            TopologySpec(lanes=2).resolve()
    explicit = TopologySpec(data=2, lanes=1, devices=("cpu", "cpu"))
    assert explicit.resolve() is explicit
    assert explicit.devices == (torch.device("cpu"),) * 2
    assert TopologySpec().resolve().devices is None


def test_rank_devices_are_refused_without_a_process_group():
    assert local_devices(("cpu", torch.device("cpu"))) == \
        (torch.device("cpu"),) * 2
    entry = RankDevice(0, torch.device("cpu"))
    topo = TopologySpec(data=2, lanes=1, devices=(entry,) * 2)
    assert topo.devices == (entry,) * 2 and topo.resolve() is topo
    assert hash(topo) == hash(TopologySpec(data=2, lanes=1,
                                           devices=(entry, entry)))
    with pytest.raises(ValueError, match="a rank-aware fleet is not ported"):
        local_devices(topo.devices)
