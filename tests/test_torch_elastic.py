"""Checkpoints across topologies and across the two packages
(``train.elastic.fleet_reshard_restore``, ``QuantileFleet.checkpoint`` /
``restore`` on meshed placements).

A fleet checkpoint holds the merged canonical lanes (a sync point), so it
restores onto any topology by re-placement alone. Here the JAX package
writes under a 2 × 2 topology (its replica loop on one CPU device) and the
port restores onto a 1-D topology of three CPU devices, onto one device
and onto 2-D topologies in both of its modes; the port writes under 2 × 2
and the JAX package restores. Both sides' manifests agree, the canonical
planes are bit-identical, and both continue bit-identically. The JAX
package's committed checkpoints (``tests/data/jax_checkpoints``) restore
onto meshed placements and continue to their golden words. The golden
file's six-program placement keys (``place/six/*``, the JAX package's
replica loop under 3 × 2) hold the port in both modes, the torch fold of
``sync`` included.

JAX is imported at the top: this file runs on the CPU only.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import QuantileFleet as JQuantileFleet
from repro.api import TopologySpec as JTopologySpec
from repro.core import program as jprogram
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro_torch.api import FleetSpec, QuantileFleet, TopologySpec
from repro_torch.core import program as tprogram
from repro_torch.parallel import Mesh2DFleet, ShardedGroupFleet
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

PAIRS = list(zip(jprogram.test_instances(), tprogram.test_instances()))
IDS = [p.family for p, _ in PAIRS]
G, QS, T, CHUNK, SEED = 6, (0.5, 0.9), 300, 32, 3
PORT_TOPOLOGIES = {
    "1d-x3": TopologySpec(lanes=3, devices=("cpu",) * 3),
    "single": TopologySpec(),
    "3x2-devices": TopologySpec(data=3, lanes=2, devices=("cpu",) * 6),
    "2x1-loop": TopologySpec(data=2),
}


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def stream(seed, t=T):
    rng = np.random.default_rng(seed)
    return rng.lognormal(3.0, 1.0, (t, G)).astype(np.float32)


def assert_canonical(tfl, jfl, what):
    sk, jsk = tfl._lane_sketch(), jfl._lane_sketch()
    for f in tfl.spec.program.layout.plane_fields:
        assert_bits(getattr(sk, f).numpy(), np.asarray(getattr(jsk, f)),
                    f"{what}: plane {f}")
    assert_bits(tfl.estimate(), np.asarray(jfl.estimate()),
                f"{what}: estimates")
    assert tfl.cursor.t_offset == int(jfl.cursor.t_offset)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_jax_writes_under_2x2_port_restores_anywhere(tmp_path, pair):
    jprog, tprog = pair
    jspec = JFleetSpec(num_groups=G, quantiles=QS, chunk_t=CHUNK,
                       program=jprog, topology=JTopologySpec(data=2, lanes=2))
    jfl = JQuantileFleet.create(jspec, seed=SEED).ingest(stream(1))
    assert jfl.state.mode == "loop"
    d = str(tmp_path / "jax")
    jfl.checkpoint(d, step=4)
    assert ckpt.read_manifest(d)["topology"] == {
        "data": 2, "lanes": 2, "placement": "mesh2d"}
    # the JAX package's own continuation, on one device
    jref = jelastic.fleet_reshard_restore(d, jspec, JTopologySpec())
    jmore = jref.ingest(stream(2, 100))
    tspec = FleetSpec(num_groups=G, quantiles=QS, chunk_t=CHUNK,
                      program=tprog)
    for name, topo in PORT_TOPOLOGIES.items():
        tfl = elastic.fleet_reshard_restore(d, tspec, topo, device="cpu")
        assert tfl.spec.topology == topo.resolve()
        assert_canonical(tfl, jfl, f"{tprog.family} onto {name}")
        if topo.data == 1:      # one trajectory: the JAX continuation
            assert_canonical(tfl.ingest(stream(2, 100)), jmore,
                             f"{tprog.family} continued on {name}")


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_port_writes_under_2x2_jax_restores(tmp_path, pair):
    jprog, tprog = pair
    topo = TopologySpec(data=2, lanes=2, devices=("cpu",) * 4)
    tfl = QuantileFleet.create(
        FleetSpec(num_groups=G, quantiles=QS, chunk_t=CHUNK, program=tprog,
                  topology=topo), seed=SEED, device="cpu").ingest(stream(5))
    jspec = JFleetSpec(num_groups=G, quantiles=QS, chunk_t=CHUNK,
                       program=jprog, topology=JTopologySpec(data=2, lanes=2))
    jfl = JQuantileFleet.create(jspec, seed=SEED).ingest(stream(5))
    dt, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    tfl.checkpoint(dt, step=2)
    jfl.checkpoint(dj, step=2)
    assert ckpt.read_manifest(dt) == jckpt.read_manifest(dj)
    for jtopo in (JTopologySpec(), JTopologySpec(data=2),
                  JTopologySpec(data=3)):
        back = jelastic.fleet_reshard_restore(dt, jspec, jtopo)
        assert_canonical(tfl, back, f"{tprog.family} JAX onto {jtopo}")
    # same-R continuation: the port's replicas and the JAX replicas restored
    # from the port's file go on identically
    jback = jelastic.fleet_reshard_restore(dt, jspec, JTopologySpec(data=2))
    tback = elastic.fleet_reshard_restore(dt, tfl.spec, topo)
    more = stream(6, 77)
    a, b = tback.ingest(more), jback.ingest(more)
    for x, y in zip(a.state.replica_planes(), b.state.replica_planes()):
        assert_bits(x, y, f"{tprog.family} continued 2x2")


def copy_ckpt(tmp_path, family, tag):
    """A copy of a committed JAX checkpoint (restore may quarantine in
    place)."""
    dst = str(tmp_path / f"{family}-{tag}")
    shutil.copytree(os.path.join(golden.CKPT_ROOT, family), dst)
    return dst


@pytest.fixture(scope="module")
def golden_file():
    return dict(np.load(golden.GOLDEN))


@pytest.mark.parametrize("family", list(golden.CKPT_PROGRAMS))
def test_committed_jax_checkpoint_onto_meshed_topologies(tmp_path, family,
                                                         golden_file):
    """The committed JAX checkpoints restore onto a 1-D topology and
    continue to the golden words (1-D is the single trajectory), and onto
    2-D topologies in both modes with the canonical lanes the file holds."""
    spec = FleetSpec(num_groups=golden.CKPT_G, quantiles=golden.QUANTILES,
                     chunk_t=golden.CKPT_CHUNK_T,
                     program=tprogram.make_program(
                         family, **golden.CKPT_PROGRAMS[family]))
    single = QuantileFleet.restore(copy_ckpt(tmp_path, family, "single"), spec,
                                   device="cpu")
    one_d = elastic.fleet_reshard_restore(
        copy_ckpt(tmp_path, family, "1d"), spec,
        TopologySpec(lanes=3, devices=("cpu",) * 3), device="cpu")
    assert isinstance(one_d.state, ShardedGroupFleet)
    cont = one_d.ingest(golden.ckpt_items(family, 1))
    packed = cont.state.packed()
    for name in packed._fields:
        x = getattr(packed, name)
        if x is not None:
            assert_bits(x.numpy(), golden_file[f"ckpt/{family}/{name}"],
                        name)
    assert list(cont.cursor) == golden_file[f"ckpt/{family}/cursor"].tolist()
    for name, topo in (("2x2-devices", TopologySpec(
            data=2, lanes=2, devices=("cpu",) * 4)),
            ("3x1-loop", TopologySpec(data=3))):
        fl = elastic.fleet_reshard_restore(
            copy_ckpt(tmp_path, family, name), spec, topo,
            device="cpu")
        assert isinstance(fl.state, Mesh2DFleet)
        for f in spec.program.layout.plane_fields:
            assert torch.equal(getattr(fl._lane_sketch(), f),
                               getattr(single.state, f)), (name, f)
        for p, f in zip(fl.state.replica_planes(),
                        spec.program.layout.plane_fields):
            for r in range(topo.data):
                assert_bits(p[r], getattr(single.state, f).numpy(),
                            f"{name} replica {r} {f}")


@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_six_program_placement_golden(golden_file, mode):
    from repro_torch.parallel import merge_replica_planes

    six = golden.six_items()
    assert golden.chunk_crc32(six) == int(golden_file["place/six/items_crc32"])
    devices = ("cpu",) * 6 if mode == "devices" else None
    for prog in tprogram.test_instances():
        fl = QuantileFleet.create(FleetSpec(
            num_groups=golden.SIX_G, quantiles=golden.SIX_QS,
            chunk_t=golden.SIX_CHUNK_T, program=prog,
            topology=TopologySpec(data=golden.SIX_DATA,
                                  lanes=golden.SIX_LANES, devices=devices)),
            seed=golden.SIX_SEED, device="cpu").ingest(six)
        assert fl.state.mode == mode
        key = f"place/six/{prog.family}"
        reps = fl.state.replica_planes()
        synced = fl.sync().state.replica_planes()
        folded = merge_replica_planes(
            prog, tuple(torch.from_numpy(p) for p in reps), xp=torch)
        for f, a, m, s, t in zip(prog.layout.plane_fields, reps,
                                 fl.state.merged_planes(), synced, folded):
            assert_bits(a, golden_file[f"{key}/replicas/{f}"], f"{key} {f}")
            want = golden_file[f"{key}/merged/{f}"]
            assert_bits(m, want, f"{key} merged {f}")
            assert_bits(t.numpy(), want, f"{key} torch fold {f}")
            for r in range(golden.SIX_DATA):
                assert_bits(s[r], want, f"{key} sync {f} replica {r}")
