"""2-D (data × lane) fleets and the TopologySpec surface of the port
against the JAX package (``tests/test_mesh2d.py``, test for test).

Every program at topologies (1,2), (1,3) with a ragged lane count, (2,1),
(2,2) and (3,2), in the port's per-device mode (an explicit tuple of CPU
devices, the counterpart of the JAX package's forced host device count)
and its loop mode, against the JAX package on one CPU device: its single
placement for the 1-D topologies (1-D equals single bit for bit), its
sequential replica loop for the 2-D ones. Replica planes, merged planes,
estimates, ``sync`` and the reshard matrix; growth; the pinned merge in
numpy and torch; quarantine; the guards. Tolerance everywhere: bit-exact
(float32 compared as int32 bit patterns).

JAX is imported at the top: this file runs on the CPU only.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import QuantileFleet as JQuantileFleet
from repro.api import TopologySpec as JTopologySpec
from repro.core import program as jprogram
from repro.parallel.mesh2d import merge_replica_planes as jmerge
from repro_torch.api import FleetSpec, QuantileFleet, TopologySpec
from repro_torch.core import program as tprogram
from repro_torch.core import streaming
from repro_torch.core.sketch import GroupedQuantileSketch
from repro_torch.parallel.group_sharding import ShardedGroupFleet
from repro_torch.parallel.mesh2d import Mesh2DFleet, merge_replica_planes
from repro_torch.resilience import health as health_mod
from repro_torch.train import checkpoint as ckpt_lib

PAIRS = list(zip(jprogram.test_instances(), tprogram.test_instances()))
FAMILIES = [p.family for p, _ in PAIRS]
G, T, CHUNK, QS, SEED = 7, 400, 32, (0.5, 0.9), 9
TOPOS = ((1, 2), (1, 3), (2, 1), (2, 2), (3, 2))
CASES = [(d, s, mode) for d, s in TOPOS for mode in ("devices", "loop")
         if d > 1 or mode == "devices"]
CASE_IDS = [f"{d}x{s}-{mode}" for d, s, mode in CASES]


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def stream(t=T, g=G, seed=4):
    rng = np.random.default_rng(seed)
    return rng.normal(3.0, 2.0, size=(t, g)).astype(np.float32)


def topology(data=1, lanes=1, mode="loop"):
    devices = ("cpu",) * (data * lanes) if mode == "devices" else None
    return TopologySpec(data=data, lanes=lanes, devices=devices)


def program(family):
    return dict(zip(FAMILIES, tprogram.test_instances()))[family]


def fleet(topo=None, family="2u", g=G, seed=SEED, **kw):
    spec = FleetSpec(num_groups=g, quantiles=QS, chunk_t=CHUNK,
                     topology=topo, program=program(family), **kw)
    return QuantileFleet.create(spec, seed=seed, device="cpu")


def jfleet(data=1, family="2u", g=G, seed=SEED, **kw):
    jprog = dict(zip(FAMILIES, jprogram.test_instances()))[family]
    spec = JFleetSpec(num_groups=g, quantiles=QS, chunk_t=CHUNK,
                      topology=JTopologySpec(data=data) if data > 1
                      else None, program=jprog, **kw)
    return JQuantileFleet.create(spec, seed=seed)


def planes_of(sk):
    return tuple(getattr(sk, f) for f in sk.program.layout.plane_fields)


def np_planes(planes):
    return tuple(np.asarray(p) for p in planes)


@functools.lru_cache(maxsize=None)
def jax_reference(family, data):
    """The JAX fleet after the whole stream: estimates, canonical planes,
    and for data > 1 the replica planes before and after sync."""
    jfl = jfleet(data, family).ingest(stream())
    out = {"estimate": np.asarray(jfl.estimate()),
           "canonical": np_planes(planes_of(jfl._lane_sketch()))}
    if data > 1:
        out["replicas"] = jfl.state.replica_planes()
        out["synced"] = jfl.sync().state.replica_planes()
    return out


def split_ingest(fl, items):
    return fl.ingest(items[:137]).ingest_stream([items[137:211],
                                                 items[211:]])


# ------------------------------------------- every program, every topology
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_program_at_topology_matches_jax(family, case):
    data, lanes, mode = case
    ref = jax_reference(family, data)
    tfl = split_ingest(fleet(topology(data, lanes, mode), family), stream())
    what = f"{family} {data}x{lanes} {mode}"
    if data == 1:
        assert isinstance(tfl.state, ShardedGroupFleet)
        assert tfl.state.padded_groups == -(-G * 2 // lanes) * lanes
    else:
        assert tfl.state.mode == mode
        for f, a, b in zip(tprogram.make_program(family).layout.plane_fields,
                           tfl.state.replica_planes(), ref["replicas"]):
            assert_bits(a, b, f"{what}: replica plane {f}")
        for a, b in zip(tfl.state.merged_planes(), ref["canonical"]):
            assert_bits(a, b, f"{what}: merged planes")
        synced = tfl.sync()
        for a, b in zip(synced.state.replica_planes(), ref["synced"]):
            assert_bits(a, b, f"{what}: sync")
        assert_bits(synced.estimate(), ref["estimate"], f"{what}: synced")
    for a, b in zip(planes_of(tfl._lane_sketch()), ref["canonical"]):
        assert_bits(a.numpy(), b, f"{what}: canonical planes")
    assert_bits(tfl.estimate(), ref["estimate"], f"{what}: estimates")
    assert tfl.cursor.t_offset == T


# --------------------------------------------------------------- TopologySpec
def test_topology_spec_placement_and_validation():
    assert TopologySpec().placement == "single"
    assert TopologySpec(lanes=4).placement == "sharded"
    assert TopologySpec(data=2).placement == "mesh2d"
    assert TopologySpec(data=2, lanes=4).num_devices == 8
    assert TopologySpec() == TopologySpec(data=1, lanes=1)
    assert hash(topology(2, 2, "devices")) == hash(topology(2, 2, "devices"))
    with pytest.raises(ValueError):
        TopologySpec(data=0)
    with pytest.raises(ValueError):
        TopologySpec(lanes=-1)
    with pytest.raises(ValueError, match="needs 4 devices"):
        TopologySpec(data=2, lanes=2, devices=("cpu",) * 3)
    for d, s in TOPOS:
        assert TopologySpec(data=d, lanes=s).describe() == \
            JTopologySpec(data=d, lanes=s).describe()
    assert TopologySpec(data=2, lanes=3).describe() == {
        "data": 2, "lanes": 3, "placement": "mesh2d"}


def test_topology_resolve_without_cards():
    """No CUDA device here: a 2-D topology falls back to the replica loop,
    a 1-D one raises (no hidden fallback), explicit devices hold."""
    assert torch.cuda.device_count() == 0
    topo = TopologySpec(data=2, lanes=2).resolve()
    assert not topo.on_devices
    with pytest.raises(ValueError, match="loop-fallback"):
        topo.mesh2d()
    with pytest.raises(ValueError, match="needs 8 devices"):
        TopologySpec(lanes=8).resolve()
    with pytest.raises(ValueError, match="needs 2 devices"):
        FleetSpec(num_groups=4, topology=TopologySpec(lanes=2))
    dev = topology(2, 2, "devices").resolve()
    assert dev.on_devices and dev.mesh2d().shape == (2, 2)
    assert all(d == torch.device("cpu") for d in dev.mesh2d().ravel())
    assert topology(1, 3, "devices").mesh1d().shape == (3,)
    assert TopologySpec(data=1, lanes=1, devices=("cpu",)).resolve() == \
        TopologySpec()
    with pytest.raises(ValueError, match="needs 4 devices"):
        TopologySpec(data=2, lanes=2, devices=3).resolve()


def test_device_that_contradicts_the_topology_raises():
    spec = FleetSpec(num_groups=G, topology=topology(2, 2, "devices"))
    assert QuantileFleet.create(spec, device="cpu").device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="contradicts"):
        QuantileFleet.create(spec, device="meta")
    # loop mode and single placement: device None is the card
    for t in (TopologySpec(data=2), None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QuantileFleet.create(FleetSpec(num_groups=G, topology=t))


# ------------------------------------------------- replica trajectory pinning
@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_replica_state_is_single_fleet_over_its_chunk_shard(mode):
    """replica(c) = c mod R on the absolute chunk index: replica r equals
    a single fleet that ingested exactly r's chunks at their absolute
    offsets (through core.streaming.ingest_slabs), and the JAX replica."""
    items = stream()
    fl = fleet(topology(2, 2, mode)).ingest(items)
    planes = fl.state.replica_planes()
    jplanes = jfleet(2).ingest(items).state.replica_planes()
    for r in range(2):
        sk = fleet().state
        own = [c for c in range(-(-T // CHUNK)) if c % 2 == r]
        sk = streaming.ingest_slabs(
            sk, [torch.from_numpy(items[c * CHUNK:(c + 1) * CHUNK])
                 for c in own], [c * CHUNK for c in own], SEED, 0,
            lanes_per_group=len(QS))
        for f, p, jp in zip(sk.program.layout.plane_fields, planes, jplanes):
            assert_bits(getattr(sk, f).numpy(), p[r],
                        f"replica {r} plane {f!r} != its sub-stream")
            assert_bits(p[r], jp[r], f"replica {r} plane {f!r} != JAX")


@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_split_invariance_at_arbitrary_call_boundaries(mode):
    """Mid-chunk call splits NaN-pad both sides of the cut, so every item
    lands on the same replica at the same tick regardless of batching."""
    items = stream()
    base = fleet(topology(3, 2, mode))
    one = base.ingest(items)
    for cut in (1, 137, 320):
        two = base.ingest(items[:cut]).ingest(items[cut:])
        for a, b in zip(one.state.replica_planes(),
                        two.state.replica_planes()):
            assert_bits(a, b, f"cut={cut}")
    streamed = base.ingest_stream([items[:50], items[50:211], items[211:]])
    for a, b in zip(one.state.replica_planes(),
                    streamed.state.replica_planes()):
        assert_bits(a, b)
    for a, b in zip(one.state.replica_planes(),
                    jfleet(3).ingest(items).state.replica_planes()):
        assert_bits(a, b, "JAX")


def test_estimates_invariant_to_lane_shard_count_at_fixed_replicas():
    items = stream()
    ref = fleet(topology(2, 1)).ingest(items).estimate()
    assert_bits(ref, jfleet(2).ingest(items).estimate())
    for lanes in (2, 3, 4):
        got = fleet(topology(2, lanes, "devices")).ingest(items)
        assert_bits(ref, got.estimate(), f"lanes={lanes}")


# ----------------------------------------------------------- pinned merge rule
def test_merge_rule_folds_by_invariant_domain():
    """finite → fixed-order running mean; step → elementwise max; sign →
    replica 0: numpy and torch give the JAX package's bits, with divisors
    (3, 5, 6, 7) whose reciprocal is inexact."""
    prog = tprogram.family_base("2u")
    rng = np.random.default_rng(1)
    m = rng.normal(size=(7, 4096)).astype(np.float32) * \
        np.float32(10.0) ** rng.integers(-6, 7, (7, 4096)).astype(np.float32)
    step = rng.integers(1, 100, (7, 4096)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], (7, 4096)).astype(np.float32)
    for r in (2, 3, 4, 7):
        planes = (m[:r], step[:r], sign[:r])
        want = jmerge(jprogram.family_base("2u"), planes)
        got = merge_replica_planes(prog, planes)
        got_t = merge_replica_planes(
            prog, tuple(torch.from_numpy(p) for p in planes), xp=torch)
        acc = m[0]
        for i in range(1, r):
            acc = acc + (m[i] - acc) / np.float32(i + 1)
        assert_bits(got[0], acc)
        assert_bits(got[1], np.max(step[:r], axis=0))
        assert_bits(got[2], sign[0])
        for a, b, c in zip(got, got_t, want):
            assert_bits(a, np.asarray(c), f"numpy R={r}")
            assert_bits(b.numpy(), np.asarray(c), f"torch R={r}")


def test_merge_of_equal_replicas_is_identity_and_r1_is_identity():
    prog = tprogram.family_base("2u")
    rng = np.random.default_rng(2)
    planes = (rng.normal(size=(5,)).astype(np.float32),
              rng.integers(1, 50, (5,)).astype(np.float32),
              rng.choice([-1.0, 1.0], (5,)).astype(np.float32))
    eq = tuple(np.broadcast_to(p, (4,) + p.shape) for p in planes)
    for a, b in zip(merge_replica_planes(prog, eq), planes):
        assert_bits(a, b)
    r1 = tuple(torch.from_numpy(p)[None] for p in planes)
    for a, b in zip(merge_replica_planes(prog, r1, xp=torch), planes):
        assert_bits(a.numpy(), b)


@pytest.mark.parametrize("family", ["1u", "2u", "2u-window"])
def test_merged_state_satisfies_program_invariants(family):
    """The fold lands inside every declared invariant domain, so health
    scans and packed checkpoints accept merged state."""
    fl = fleet(topology(3, 1), family).ingest(stream())
    sk = fl._lane_sketch()
    prog = fl.spec.program
    mask = health_mod.validate_planes(prog, sk.planes())
    assert not bool(mask.any()), family
    rt = GroupedQuantileSketch.from_packed(sk.packed(), drift=sk.drift,
                                           device="cpu")
    for f in prog.layout.plane_fields:
        assert torch.equal(getattr(sk, f), getattr(rt, f)), f


@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_sync_is_idempotent_and_estimate_preserving(mode):
    fl = fleet(topology(2, 2, mode)).ingest(stream())
    synced = fl.sync()
    assert_bits(fl.estimate(), synced.estimate())
    again = synced.sync()
    for a, b in zip(synced.state.replica_planes(),
                    again.state.replica_planes()):
        assert_bits(a, b)
    for p in synced.state.replica_planes():
        for r in range(1, p.shape[0]):
            assert_bits(p[0], p[r])
    # sync leaves the fleet it was called on as it was
    assert not all(np.array_equal(p[0], p[1])
                   for p in fl.state.replica_planes())
    single = fleet(TopologySpec()).ingest(stream())
    assert single.sync() is single


def test_replicas_own_their_tensors():
    """Per-device mode: no two (replica, shard) cells share storage, not
    even where every device is the same CPU."""
    fl = fleet(topology(2, 2, "devices")).ingest(stream(64))
    ptrs = [getattr(sh, f).data_ptr()
            for rep in fl.state.replicas for sh in rep.shards
            for f in sh.program.layout.plane_fields + ("quantile",)]
    assert len(set(ptrs)) == len(ptrs)


# ------------------------------------------------------------------- elastic
@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_reshard_matrix_preserves_or_syncs(mode):
    """(1×1) → (2×1) → (2×2) → (4×1) → (1×1), each step against the JAX
    fleet's same step: same-R reshards carry every replica bit for bit,
    R-changing reshards pass through the pinned merge (estimate
    unchanged); the cursor never moves."""
    items = stream()
    fl, jfl = fleet().ingest(items[:200]), jfleet().ingest(items[:200])
    est = fl.estimate()
    assert_bits(est, jfl.estimate())

    fl2 = fl.reshard(topology(2, 1, mode))
    jfl2 = jfl.reshard(JTopologySpec(data=2))
    assert isinstance(fl2.state, Mesh2DFleet) and fl2.state.mode == mode
    assert_bits(fl2.estimate(), est)
    assert fl2.cursor.t_offset == 200

    fl2, jfl2 = fl2.ingest(items[200:]), jfl2.ingest(items[200:])
    est2 = fl2.estimate()
    assert_bits(est2, jfl2.estimate())
    fl22 = fl2.reshard(topology(2, 2, mode))      # same R: bit-exact
    for a, b, c in zip(fl2.state.replica_planes(),
                       fl22.state.replica_planes(),
                       jfl2.state.replica_planes()):
        assert_bits(a, b)
        assert_bits(a, c, "JAX")

    fl41 = fl22.reshard(topology(4, 1, mode))     # R change: sync point
    jfl41 = jfl2.reshard(JTopologySpec(data=4))
    assert_bits(fl41.estimate(), est2)
    for a, c in zip(fl41.state.replica_planes(),
                    jfl41.state.replica_planes()):
        assert_bits(a, c, "4x1 JAX")
    back = fl41.reshard(TopologySpec())           # collapse to single
    assert isinstance(back.state, GroupedQuantileSketch)
    assert back.spec.backend == "fused" and back.device == torch.device("cpu")
    assert_bits(back.estimate(), est2)
    lanes3 = fl41.reshard(topology(1, 3, "devices"))
    assert isinstance(lanes3.state, ShardedGroupFleet)
    assert_bits(lanes3.estimate(), est2)

    more = stream(100, seed=77)
    assert_bits(fl2.ingest(more).estimate(), fl22.ingest(more).estimate())
    assert_bits(fl22.ingest(more).estimate(), jfl2.ingest(more).estimate())
    assert_bits(fl41.ingest(more).estimate(), jfl41.ingest(more).estimate())
    assert_bits(back.ingest(more).estimate(), lanes3.ingest(more).estimate())


@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_grow_mid_stream_keeps_existing_lanes_bit_for_bit(mode):
    items = stream()
    fl = fleet(topology(2, 2, mode)).ingest(items[:200])
    jfl = jfleet(2).ingest(items[:200])
    before = fl.state.replica_planes()
    grown, jgrown = fl.grow_groups(G + 3), jfl.grow_groups(G + 3)
    after = grown.state.replica_planes()
    old = G * len(QS)
    for a, b in zip(after, before):
        assert_bits(a[:, :old], b)
    for a, b in zip(after, jgrown.state.replica_planes()):
        assert_bits(a, b, "JAX")
    # new lanes tick like lanes created at the current cursor
    wide = fleet(topology(2, 2, mode), g=G + 3)
    pad = np.full((200, 3), np.nan, np.float32)
    wide = wide.ingest(np.concatenate([items[:200], pad], axis=1))
    more = stream(100, g=G + 3, seed=5)
    assert_bits(grown.ingest(more).estimate(), wide.ingest(more).estimate())
    assert_bits(grown.ingest(more).estimate(),
                jgrown.ingest(more).estimate())
    # 1-D: gather, append, re-shard
    one_d = fleet(topology(1, 3, "devices")).ingest(items[:200])
    single = fleet().ingest(items[:200])
    assert_bits(one_d.grow_groups(G + 3).ingest(more).estimate(),
                single.grow_groups(G + 3).ingest(more).estimate())


def test_from_replica_planes_rejects_replica_count_change():
    fl = fleet(topology(2, 1)).ingest(stream(64))
    m2 = fl.state
    quantile = np.tile(np.float32(QS), (2, G))
    with pytest.raises(ValueError, match="sync point"):
        Mesh2DFleet.from_replica_planes(
            fl._lane_sketch(), m2.replica_planes(), quantile,
            topology(3, 1), lanes_per_group=len(QS))
    same = Mesh2DFleet.from_replica_planes(
        fl._lane_sketch(), m2.replica_planes(), quantile,
        topology(2, 2, "devices"), lanes_per_group=len(QS))
    for a, b in zip(same.replica_planes(), m2.replica_planes()):
        assert_bits(a, b)


# ---------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_checkpoint_records_topology_stanza_and_restores_cross_shape(
        tmp_path, mode):
    from repro_torch.train import elastic

    fl = fleet(topology(2, 2, mode)).ingest(stream())
    d = str(tmp_path)
    fl.checkpoint(d, step=3)
    man = ckpt_lib.read_manifest(d)
    assert man["topology"] == {"data": 2, "lanes": 2,
                               "placement": "mesh2d"}
    assert man["format"] == 4
    canon = fl._lane_sketch()
    for topo in (TopologySpec(), topology(4, 1), topology(3, 2, "devices"),
                 topology(1, 3, "devices")):
        rs = elastic.fleet_reshard_restore(d, fl.spec, topo, device="cpu")
        rsk = rs._lane_sketch()
        for f in fl.spec.program.layout.plane_fields:
            assert torch.equal(getattr(canon, f), getattr(rsk, f)), \
                f"plane {f!r} restored onto {topo}"
        assert_bits(fl.estimate(), rs.estimate())
        assert rs.cursor.t_offset == fl.cursor.t_offset


def test_single_placement_checkpoint_stanza(tmp_path):
    fl = fleet().ingest(stream(64))
    fl.checkpoint(str(tmp_path), step=1)
    man = ckpt_lib.read_manifest(str(tmp_path))
    assert man["topology"] == {"data": 1, "lanes": 1, "placement": "single"}


# ------------------------------------------------------------------- facade
@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_mesh2d_fleet_properties_and_event_mode_guard(mode):
    fl = fleet(topology(2, 2, mode))
    st = fl.state
    assert st.data_replicas == 2
    assert st.memory_words() == 2         # per lane per replica
    assert fl.memory_words() == 2
    assert st.mode == mode
    assert st.padded_groups == G * 2 and \
        st.shard_groups == (G if mode == "devices" else G * 2)
    with pytest.raises(NotImplementedError, match="meshed"):
        fl.tick_lanes(np.zeros(fl.num_lanes, np.float32))
    with pytest.raises(NotImplementedError, match="meshed"):
        fl.tick_lanes_sparse([0], [1.0])
    sharded = fleet(topology(1, 2, "devices"))
    with pytest.raises(NotImplementedError, match="meshed"):
        sharded.tick_lanes(np.zeros(fl.num_lanes, np.float32))
    with pytest.raises(ValueError, match="shape"):
        fl.ingest(np.zeros((4, G + 1), np.float32))


@pytest.mark.parametrize("mode", ["devices", "loop"])
def test_quarantine_heals_on_2d_placement(mode):
    """A corrupt lane of one replica: check_health scans the merged lanes,
    heals them and re-places the healed sketch (a sync point), as the JAX
    fleet does."""
    items = stream()
    fl = fleet(topology(2, 2, mode), health="quarantine").ingest(items)
    jfl = jfleet(2, health="quarantine").ingest(items)
    rep0 = fl.state.replicas[0]
    m = rep0.shards[0].m.clone()
    m[1] = float("nan")
    bad = dataclasses.replace(fl, state=dataclasses.replace(
        fl.state, replicas=(dataclasses.replace(rep0, shards=(
            dataclasses.replace(rep0.shards[0], m=m),) + rep0.shards[1:]),)
        + fl.state.replicas[1:]))
    import jax.numpy as jnp

    jm = np.asarray(jfl.state.sketch.m).copy()
    jm[0, 1] = np.nan
    jbad = dataclasses.replace(jfl, state=dataclasses.replace(
        jfl.state, sketch=dataclasses.replace(jfl.state.sketch,
                                              m=jnp.asarray(jm))))
    healed, rep = bad.check_health()
    jhealed, jrep = jbad.check_health()
    assert not rep.healthy and rep.quarantined == jrep.quarantined
    assert rep.corrupt_lanes == jrep.corrupt_lanes
    ok, rep2 = healed.check_health()
    assert rep2.healthy
    assert isinstance(healed.state, Mesh2DFleet) and healed.state.mode == mode
    for a, b in zip(healed.state.replica_planes(),
                    jhealed.state.replica_planes()):
        assert_bits(a, b)


@pytest.mark.parametrize("topo", [topology(1, 3, "devices"),
                                  topology(2, 2, "devices"), topology(3, 1)],
                         ids=["1x3-devices", "2x2-devices", "3x1-loop"])
def test_dying_source_resumes_bit_exact_on_meshed_placements(topo):
    """A source that dies mid-stream raises a resumable StreamInterrupted
    at a chunk boundary; resuming with skip_items ends bit-identical to
    the uninterrupted run, on every placement (the JAX package's
    ingest_stream contract)."""
    from repro_torch.resilience import chaos

    items = stream()
    whole = fleet(topo).ingest_stream([items])

    def dying():
        yield items[:50]
        yield items[50:101]
        raise OSError("source died")

    with pytest.raises(chaos.StreamInterrupted) as err:
        fleet(topo).ingest_stream(dying())
    e = err.value
    assert e.items_applied == 96            # three full chunks of 32
    assert e.fleet.cursor.t_offset == 96
    resumed = e.fleet.ingest_stream([items], skip_items=e.items_applied)
    assert_bits(resumed.estimate(), whole.estimate())
    planes = (resumed.state.replica_planes() if topo.data > 1
              else resumed.state.host_planes())
    want = (whole.state.replica_planes() if topo.data > 1
            else whole.state.host_planes())
    for a, b in zip(planes, want):
        assert_bits(a, b)
    assert resumed.cursor.t_offset == T
