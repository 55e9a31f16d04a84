"""Lane-sharded fleets of the port (``parallel.group_sharding``) against
the JAX package (``tests/test_group_sharding.py``, test for test).

The JAX package's contract is bit-exactness: a fleet sharded over any
number of devices reproduces the single-device trajectory, for any
chunking and any ragged lane count, because uniforms key on the absolute
(seed, tick, lane). The port's shards run on explicit tuples of CPU
devices here (the per-device execution the card runs with
``("cuda:0",) * n``). The JAX side runs on one CPU device, where the
sharded trajectory is the single one. Tolerance: bit-exact.

JAX is imported at the top: this file runs on the CPU only.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import GroupedQuantileSketch as JSketch
from repro.core import program as jprogram
from repro.core import streaming as jstreaming
from repro.api import FleetSpec as JFleetSpec
from repro.api import QuantileFleet as JQuantileFleet
from repro_torch.api import FleetSpec, QuantileFleet, TopologySpec
from repro_torch.core import program as tprogram
from repro_torch.parallel import ShardedGroupFleet, group_mesh
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

PAIRS = list(zip(jprogram.test_instances(), tprogram.test_instances()))
IDS = [p.family for p, _ in PAIRS]


def cpus(n):
    return ("cpu",) * n


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def items_of(t, g, seed=0, domain=800):
    rng = np.random.default_rng(seed)
    return rng.integers(0, domain, (t, g)).astype(np.float32)


def jax_run(g, items, seed, algo="2u", quantile=0.5):
    """The JAX single-device trajectory (the jnp scan)."""
    sk = JSketch.create(g, quantile=quantile, algo=algo)
    return sk.process_seeded(jnp.asarray(items), seed)


# --------------------------------------------------- g_offset core invariant
@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_g_offset_column_slices_reproduce_full_run(algo):
    """A shard IS a column slice ingested at its absolute offset: a fleet
    of columns [a:b] at g_offset=a equals the slice of the full JAX run."""
    t, g = 300, 29
    items = items_of(t, g, seed=1)
    full = JSketch.create(g, quantile=0.7, algo=algo).process_seeded(
        jnp.asarray(items), 3)
    for a, b in ((0, 7), (7, 20), (20, 29)):
        part = ShardedGroupFleet.create(b - a, quantile=0.7, algo=algo,
                                        mesh=cpus(2))
        part = part.ingest_array(items[:, a:b], seed=3, chunk_t=64,
                                 g_offset=a).unshard()
        for f in part.program.layout.plane_fields:
            assert_bits(np.asarray(getattr(full, f))[a:b],
                        getattr(part, f).numpy(), f"{algo} [{a}:{b}] {f}")


def test_g_offset_stream_matches_array():
    t, g = 257, 11
    items = items_of(t, g, seed=2)
    fl = ShardedGroupFleet.create(g, quantile=0.25, algo="2u", mesh=cpus(3))
    a = fl.ingest_array(items, seed=8, chunk_t=100, g_offset=5).unshard()
    b = fl.ingest_stream([items[:40], items[40:]], seed=8, chunk_t=100,
                         g_offset=5).unshard()
    j = jstreaming.ingest_array(JSketch.create(g, quantile=0.25), items,
                                seed=8, chunk_t=100, g_offset=5)
    for f in ("m", "step", "sign"):
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert_bits(getattr(a, f).numpy(), np.asarray(getattr(j, f)), f)


# ------------------------------------------------------------ shard counts
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_fleet_bit_identical_at_any_shard_count(algo, n):
    t, g = 500, 37
    items = items_of(t, g, seed=3)
    base = jax_run(g, items, 9, algo, 0.9)
    fleet = ShardedGroupFleet.create(g, quantile=0.9, algo=algo,
                                     mesh=cpus(n))
    assert fleet.padded_groups == -(-g // n) * n
    fa = fleet.ingest_array(items, seed=9, chunk_t=128)
    assert_bits(np.asarray(base.m), fa.estimate())
    fs = fleet.ingest_stream([items[:123], items[123:]], seed=9, chunk_t=99)
    assert_bits(np.asarray(base.m), fs.estimate())
    un = fa.unshard()
    for f in un.program.layout.plane_fields:
        assert_bits(np.asarray(getattr(base, f)), getattr(un, f).numpy(), f)


@pytest.mark.parametrize("n", [4, 7])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_lane_plane_fleet_matches_jax_for_every_program(pair, n):
    """A (G × Q) lane plane under TopologySpec(lanes=n): the flattened lane
    axis is what shards (items fanned out Q-fold, pad lanes at the tail),
    equal to the JAX fleet's single trajectory."""
    jprog, tprog = pair
    g, qs = 10, (0.25, 0.5, 0.99)       # 30 lanes: ragged at n = 4, 7
    items = items_of(333, g, seed=11)
    jfl = JQuantileFleet.create(JFleetSpec(num_groups=g, quantiles=qs,
                                           chunk_t=64, program=jprog),
                                seed=5).ingest(items)
    tfl = QuantileFleet.create(
        FleetSpec(num_groups=g, quantiles=qs, chunk_t=64, program=tprog,
                  topology=TopologySpec(lanes=n, devices=cpus(n))),
        seed=5, device="cpu")
    assert tfl.state.padded_groups > tfl.num_lanes        # ragged
    tfl = tfl.ingest(items[:100]).ingest_stream([items[100:]])
    assert_bits(tfl.estimate(), np.asarray(jfl.estimate()), tprog.family)
    sk = jfl._lane_sketch()
    for f in tprog.layout.plane_fields:
        assert_bits(getattr(tfl._lane_sketch(), f).numpy(),
                    np.asarray(getattr(sk, f)), f"{tprog.family} {f}")


def test_fleet_packed_checkpoint_roundtrip(tmp_path):
    g = 48
    items = items_of(200, g, seed=4)
    fleet = ShardedGroupFleet.create(g, quantile=0.5, algo="2u",
                                     mesh=cpus(3))
    fleet = fleet.ingest_array(items, seed=1, chunk_t=64)
    save_checkpoint(str(tmp_path), 3, fleet.packed())
    like = ShardedGroupFleet.create(g, quantile=0.5, algo="2u",
                                    mesh=cpus(1)).packed()
    restored, step = restore_checkpoint(str(tmp_path), like=like,
                                        device="cpu")
    assert step == 3
    f2 = ShardedGroupFleet.from_packed(restored, mesh=cpus(2))
    assert_bits(fleet.estimate(), f2.estimate())
    more = items_of(100, g, seed=5)
    a = fleet.ingest_array(more, seed=2, chunk_t=64, t_offset=200)
    b = f2.ingest_array(more, seed=2, chunk_t=64, t_offset=200)
    assert_bits(a.estimate(), b.estimate())
    assert_bits(np.asarray(jax_run(g, items, 1).m), fleet.estimate())
    with pytest.raises(ValueError, match="shadow plane"):
        ShardedGroupFleet.from_packed(
            restored, mesh=cpus(2),
            drift=tprogram.make_program("2u-window", window=96).drift)


def test_t_offset_continuation_matches_one_shot():
    """Continuing a stream across calls with a running t_offset equals one
    uninterrupted ingest, on the array and the stream entry points."""
    t, g = 400, 13
    items = items_of(t, g, seed=9)
    base = jax_run(g, items, 6)
    fleet = ShardedGroupFleet.create(g, mesh=cpus(2))
    f1 = fleet.ingest_array(items[:150], seed=6, chunk_t=64)
    f1 = f1.ingest_array(items[150:], seed=6, chunk_t=64, t_offset=150)
    assert_bits(np.asarray(base.m), f1.estimate())
    f2 = fleet.ingest_stream([items[:70]], seed=6, chunk_t=64)
    f2 = f2.ingest_stream([items[70:]], seed=6, chunk_t=64, t_offset=70)
    assert_bits(np.asarray(base.m), f2.estimate())


def test_fleet_accepts_preplaced_padded_items():
    """_pad_items is idempotent: [T, Gp] padded items ingest like [T, G]
    ones (ragged G, Gp > G)."""
    t, g = 200, 13
    items = items_of(t, g, seed=10)
    fleet = ShardedGroupFleet.create(g, mesh=cpus(2))
    placed, q = fleet._pad_items(items)
    assert q == 1 and placed.shape == (t, 14)
    assert torch.isnan(placed[:, 13]).all()
    a = fleet.ingest_array(items, seed=7, chunk_t=64)
    b = fleet.ingest_array(placed, seed=7, chunk_t=64)
    assert_bits(a.estimate(), b.estimate())


def test_fleet_rejects_bad_item_shapes():
    fleet = ShardedGroupFleet.create(8, mesh=cpus(2))
    with pytest.raises(ValueError):
        fleet.ingest_array(np.zeros((10, 5), np.float32), seed=0)
    with pytest.raises(ValueError):
        fleet.ingest_array(np.zeros((10, 8), np.float32), seed=0, chunk_t=0)
    with pytest.raises(ValueError, match="key= or seed="):
        fleet.ingest_array(np.zeros((10, 8), np.float32))


def test_group_mesh_without_cards_raises():
    """No CUDA device here: the default mesh is refused, not replaced by
    the CPU."""
    with pytest.raises(ValueError, match="found 0 CUDA"):
        group_mesh()
    with pytest.raises(ValueError, match="found 0 CUDA"):
        ShardedGroupFleet.create(8)


def test_sharded_restore_onto_mesh():
    """Elastic path: a fleet saved from one mesh re-places onto another
    through from_packed, at any G."""
    g = 64 * 3 + 5
    items = items_of(150, g, seed=7)
    fleet = ShardedGroupFleet.create(g, mesh=cpus(3))
    fleet = fleet.ingest_array(items, seed=5, chunk_t=64)
    small = ShardedGroupFleet.from_packed(fleet.packed(), mesh=cpus(2))
    assert small.mesh.shape == (2,)
    assert_bits(fleet.estimate(), small.estimate())
    assert_bits(fleet.estimate(), np.asarray(jax_run(g, items, 5).m))


CASES = [tuple(int(v) for v in row) for row in np.stack([
    np.random.default_rng(17).integers(1, 24, 12),     # g
    np.random.default_rng(18).integers(1, 121, 12),    # t
    np.random.default_rng(19).integers(1, 65, 12),     # chunk_t
    np.random.default_rng(20).integers(1, 5, 12),      # shards
    np.random.default_rng(21).integers(0, 120, 12),    # cut
    np.random.default_rng(22).integers(0, 2, 12),      # algo
], axis=1)]


@pytest.mark.parametrize("case", CASES)
def test_any_mesh_and_chunking_is_bit_exact(case):
    """The JAX package's property sweep as 12 seeded cases: any shard
    count × chunk_t × producer slicing × ragged G reproduces the
    unsharded one-shot JAX trajectory."""
    g, t, chunk_t, n, cut, algo = case
    algo = ("1u", "2u")[algo]
    items = items_of(t, g, seed=g * 131 + t)
    base = jax_run(g, items, g + 7 * t, algo)
    fleet = ShardedGroupFleet.create(g, algo=algo, mesh=cpus(n))
    cut = min(cut, t)
    pieces = [items[:cut], items[cut:]] if 0 < cut < t else [items]
    fs = fleet.ingest_stream(pieces, seed=g + 7 * t, chunk_t=chunk_t)
    assert_bits(np.asarray(base.m), fs.estimate())
    fa = fleet.ingest_array(items, seed=g + 7 * t, chunk_t=chunk_t)
    assert_bits(np.asarray(base.m), fa.estimate())


def test_deprecated_spelling_maps_onto_topology():
    """backend="sharded" with a device sequence as mesh builds, under a
    DeprecationWarning, a spec equal to the topology= spelling (spelled
    through a dict: the source lints refuse it inside FleetSpec calls)."""
    legacy = {"backend": "sharded", "mesh": cpus(3)}
    with pytest.warns(DeprecationWarning, match="deprecated placement"):
        old = FleetSpec(num_groups=5, **legacy)
    new = FleetSpec(num_groups=5, topology=TopologySpec(lanes=3,
                                                        devices=cpus(3)))
    assert old == new and hash(old) == hash(new)
    assert new.backend == "sharded" and new.mesh == (torch.device("cpu"),) * 3
    with pytest.warns(DeprecationWarning):
        assert FleetSpec(num_groups=5, **{"backend": "sharded",
                                          "mesh": cpus(2)}).topology.lanes \
            == 2
    mesh_only = {"mesh": cpus(2)}
    with pytest.raises(ValueError, match="deprecated placement spelling"):
        FleetSpec(num_groups=5, topology=TopologySpec(lanes=2,
                                                      devices=cpus(2)),
                  **mesh_only)
    with pytest.raises(ValueError, match="only applies"):
        FleetSpec(num_groups=5, **mesh_only)
    with pytest.raises(ValueError, match="contradicts topology"):
        FleetSpec(num_groups=5, topology=TopologySpec(data=2),
                  **{"backend": "sharded"})
    with pytest.raises(ValueError, match="scan engine"):
        FleetSpec(num_groups=5, backend="jnp",
                  topology=TopologySpec(data=2))
    # a normalized spec round-trips through replace without warning
    import dataclasses
    assert dataclasses.replace(new, num_groups=6).mesh == new.mesh
    assert new.with_topology(TopologySpec()).backend == "fused"
    assert FleetSpec(num_groups=5, backend="jnp").with_topology(
        TopologySpec()).backend == "jnp"
