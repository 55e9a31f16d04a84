"""The port's main path as a whole against the JAX package's facade:
FleetSpec + QuantileFleet on the CPU for every registered family, Q = 2,
ingest then ingest_stream with chunks of 51 rows and the rest (the
single-device half of tests/conftest.py's run_program_invariance_sweep).
Estimates (window query and DP noise included) and full plane state must
be bit-identical; state carries across the two packages both ways."""
import numpy as np
import pytest
import torch

from repro.api import FleetSpec as JFleetSpec
from repro.api import QuantileFleet as JQuantileFleet
from repro.core import program as jprogram
from repro_torch.api import FleetSpec, QuantileFleet, TopologySpec, from_jax_state
from repro_torch.core import program as tprogram
from repro_torch.resilience import chaos

PAIRS = list(zip(jprogram.test_instances(), tprogram.test_instances()))
IDS = [p.family for p, _ in PAIRS]
G, QS, T, SEED = 5, (0.5, 0.9), 400, 9


def stream():
    return np.random.default_rng(4).integers(0, 800, (T, G)).astype(
        np.float32)


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same(jfleet, tfleet, what):
    np.testing.assert_array_equal(bits(jfleet.estimate()),
                                  bits(tfleet.estimate()),
                                  err_msg=f"{what}: estimates")
    sk = jfleet._lane_sketch()
    for f in tfleet.spec.program.layout.plane_fields:
        np.testing.assert_array_equal(
            bits(getattr(sk, f)), bits(getattr(tfleet.state, f).numpy()),
            err_msg=f"{what}: plane {f}")
    assert int(jfleet.cursor.t_offset) == tfleet.cursor.t_offset


def split_ingest(fleet, items):
    cut = T // 3
    return fleet.ingest(items[:cut]).ingest_stream(
        [items[cut:cut + 51], items[cut + 51:]])


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_fleet_matches_jax_across_engines_and_chunkings(pair):
    jprog, tprog = pair
    items = stream()
    ref = split_ingest(JQuantileFleet.create(
        JFleetSpec(num_groups=G, quantiles=QS, backend="jnp",
                   chunk_t=4096, program=jprog), seed=SEED), items)
    for chunk_t in (64, 333):
        jfl = split_ingest(JQuantileFleet.create(
            JFleetSpec(num_groups=G, quantiles=QS, chunk_t=chunk_t,
                       program=jprog), seed=SEED), items)
        tfl = split_ingest(QuantileFleet.create(
            FleetSpec(num_groups=G, quantiles=QS, chunk_t=chunk_t,
                      program=tprog), seed=SEED, device="cpu"), items)
        assert_same(jfl, tfl, f"{tprog.family} chunk_t={chunk_t}")
        assert_same(ref, tfl, f"{tprog.family} vs jnp engine")
        assert tfl.memory_words() == jfl.memory_words()


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_state_carries_across_both_ways(pair):
    jprog, tprog = pair
    items = stream()
    jspec = JFleetSpec(num_groups=G, quantiles=QS, chunk_t=100,
                       program=jprog)
    tspec = FleetSpec(num_groups=G, quantiles=QS, chunk_t=100,
                      program=tprog)
    jfl = JQuantileFleet.create(jspec, seed=SEED).ingest(items[:150])
    packed = {k: None if v is None else np.asarray(v)
              for k, v in jfl._lane_sketch().packed()._asdict().items()}
    cursor = tuple(int(x) for x in jfl.cursor)
    tfl = from_jax_state(tspec, type("P", (), packed), cursor, device="cpu")
    assert_same(jfl, tfl, f"{tprog.family} carried in")
    jfl, tfl = jfl.ingest(items[150:]), tfl.ingest(items[150:])
    assert_same(jfl, tfl, f"{tprog.family} continued")

    out, cur = tfl.to_numpy_state()
    want = jfl._lane_sketch().packed()
    for name in want._fields:
        a, b = getattr(want, name), getattr(out, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
    assert tuple(cur) == tuple(int(x) for x in jfl.cursor)
    back = from_jax_state(tspec, out, cur, device="cpu")
    np.testing.assert_array_equal(bits(back.estimate()),
                                  bits(tfl.estimate()))


def test_from_jax_state_refuses_mismatched_payloads():
    items = stream()
    jfl = JQuantileFleet.create(
        JFleetSpec(num_groups=G, quantiles=QS, program="2u"), seed=1
    ).ingest(items[:10])
    p = jfl._lane_sketch().packed()
    packed = type("P", (), {k: None if v is None else np.asarray(v)
                            for k, v in p._asdict().items()})
    with pytest.raises(ValueError, match="lanes"):
        from_jax_state(FleetSpec(num_groups=G + 1, quantiles=QS,
                                 program="2u"), packed, (1, 10, 0),
                       device="cpu")
    with pytest.raises(ValueError, match="shadow plane"):
        from_jax_state(FleetSpec(num_groups=G, quantiles=QS,
                                 program="2u-window"), packed, (1, 10, 0),
                       device="cpu")
    with pytest.raises(ValueError, match="1u"):
        from_jax_state(FleetSpec(num_groups=G, quantiles=QS, program="1u"),
                       packed, (1, 10, 0), device="cpu")


def test_interrupted_stream_resumes_bit_exact():
    prog = tprogram.make_program("2u-window", window=96)
    spec = FleetSpec(num_groups=G, quantiles=QS, chunk_t=64, program=prog)
    items = stream()
    whole = QuantileFleet.create(spec, seed=SEED, device="cpu").ingest(items)

    def dying():
        yield items[:100]
        yield items[100:170]
        raise OSError("source died")

    with pytest.raises(chaos.StreamInterrupted) as err:
        QuantileFleet.create(spec, seed=SEED,
                             device="cpu").ingest_stream(dying())
    e = err.value
    assert e.items_applied == 128        # two full chunks committed
    resumed = e.fleet.ingest_stream([items], skip_items=e.items_applied)
    np.testing.assert_array_equal(bits(resumed.estimate()),
                                  bits(whole.estimate()))
    assert resumed.cursor.t_offset == T


def test_cursor_and_spec_rules():
    spec = FleetSpec(num_groups=3, quantiles=(0.25, 0.75), program="1u")
    assert spec.num_lanes == 6 and spec.lane(2, 0.75) == 5
    assert spec.memory_words() == 1
    np.testing.assert_array_equal(spec.lane_quantiles(),
                                  np.tile(np.float32([0.25, 0.75]), 3))
    with pytest.raises(ValueError,
                       match="topology must be a parallel.TopologySpec"):
        FleetSpec(num_groups=3, topology=object())
    with pytest.raises(ValueError, match="contradicts"):
        FleetSpec(num_groups=3, algo="1u", program="2u-window")
    cur = QuantileFleet.create(spec, seed=4, device="cpu").cursor
    assert tuple(cur) == (4, 0, 0)
    assert cur.advance(2 ** 31 + 5).t_offset == -2 ** 31 + 5
    assert cur.advance(2 ** 32).t_offset == 0


def test_create_without_device_needs_the_card():
    spec = FleetSpec(num_groups=4, quantiles=(0.5,))
    if torch.cuda.is_available():
        assert QuantileFleet.create(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            QuantileFleet.create(spec)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_rechunk_stages_on_the_given_device(device):
    from repro_torch.core.streaming import rechunk_blocks

    items = stream()[:150]
    chunks = [items[:50], torch.from_numpy(items[50:120].copy()),
              items[120:]]
    blocks = list(rechunk_blocks(chunks, G, 64, device))
    assert [int(t0) for _, t0 in blocks] == [0, 64, 128]
    staged = isinstance(blocks[0][0], torch.Tensor)
    assert staged == (device is not None)    # None: staged on the host
    got = np.concatenate([np.asarray(b) for b, _ in blocks])
    np.testing.assert_array_equal(got[:150], items)
    assert np.isnan(got[150:]).all()


# --------------------------------------------- engines and the rest of the API
import jax  # noqa: E402

from repro.api import BACKENDS as JBACKENDS  # noqa: E402
from repro.api import StreamCursor as JStreamCursor  # noqa: E402
from repro_torch.api import BACKENDS, StreamCursor  # noqa: E402


def jax_fleet(prog, **kw):
    cursor = kw.pop("cursor", None)
    spec = JFleetSpec(num_groups=kw.pop("groups", G), quantiles=QS,
                      backend="jnp", chunk_t=128, program=prog)
    if cursor is not None:
        kw["cursor"] = JStreamCursor.create(*cursor)
    return JQuantileFleet.create(spec, **kw)


def port_fleet(prog, backend="fused", **kw):
    cursor = kw.pop("cursor", None)
    spec = FleetSpec(num_groups=kw.pop("groups", G), quantiles=QS,
                     backend=backend, chunk_t=128, program=prog)
    if cursor is not None:
        kw["cursor"] = StreamCursor.create(*cursor)
    return QuantileFleet.create(spec, device="cpu", **kw)


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_engines_match_jax(pair, backend):
    """spec.backend picks the engine only: the plain loop ("jnp") and the
    chunked dense path ("fused") give the JAX package's bits, through
    ingest and ingest_stream."""
    jprog, tprog = pair
    items = stream()
    jfl = split_ingest(jax_fleet(jprog, seed=SEED), items)
    tfl = split_ingest(port_fleet(tprog, backend, seed=SEED), items)
    assert tfl.spec.backend == backend
    assert_same(jfl, tfl, f"{tprog.family} backend={backend}")


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_create_key_init_and_estimate_quantile_match_jax(pair):
    jprog, tprog = pair
    items = stream()
    k = jax.random.PRNGKey(2024)
    words = np.asarray(jax.random.key_data(k))
    init = np.linspace(-50.0, 50.0, G).astype(np.float32)
    for kw_j, kw_t in ((dict(key=k), dict(key=words)),
                       (dict(key=k, init=7.5), dict(key=words, init=7.5)),
                       (dict(seed=3, init=init), dict(seed=3, init=init))):
        jfl = jax_fleet(jprog, **kw_j)
        tfl = port_fleet(tprog, **kw_t)
        assert tfl.cursor.seed == int(jfl.cursor.seed)
        assert_same(jfl, tfl, f"{tprog.family} fresh {sorted(kw_t)}")
        jfl, tfl = jfl.ingest(items), tfl.ingest(items)
        assert_same(jfl, tfl, f"{tprog.family} {sorted(kw_t)}")
        for q in QS:
            np.testing.assert_array_equal(
                bits(jfl.estimate(quantile=q)),
                bits(tfl.estimate(quantile=q)))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_cursor_near_int32_wrap_with_lane_offset(pair):
    jprog, tprog = pair
    items = stream()
    cursor = (11, 2 ** 31 - 170, 2 ** 31 - 3)
    jfl = jax_fleet(jprog, cursor=cursor).ingest(items[:250])
    tfl = port_fleet(tprog, cursor=cursor).ingest(items[:250])
    assert tfl.cursor.t_offset == int(jfl.cursor.t_offset) < 0
    jfl, tfl = jfl.ingest(items[250:]), tfl.ingest(items[250:])
    assert_same(jfl, tfl, f"{tprog.family} across the wrap")


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_grow_groups_then_ingest_and_zero_rows(pair, backend):
    jprog, tprog = pair
    items = stream()
    wide = np.random.default_rng(8).integers(0, 800, (200, G + 3)).astype(
        np.float32)
    jfl = jax_fleet(jprog, seed=SEED).ingest(items[:120])
    tfl = port_fleet(tprog, backend, seed=SEED).ingest(items[:120])
    jfl, tfl = jfl.grow_groups(G + 3, init=4.0), tfl.grow_groups(G + 3,
                                                                 init=4.0)
    assert tfl.num_groups == G + 3 and tfl.spec.backend == backend
    jfl, tfl = jfl.ingest(wide), tfl.ingest(wide)
    assert_same(jfl, tfl, f"{tprog.family} grown")
    empty = np.empty((0, G + 3), np.float32)
    j0, t0 = jfl.ingest(empty), tfl.ingest(empty)
    assert t0.cursor.t_offset == tfl.cursor.t_offset == 320
    assert_same(j0, t0, f"{tprog.family} zero rows")
    for f in tprog.layout.plane_fields:
        assert torch.equal(getattr(t0.state, f), getattr(tfl.state, f))


def test_backend_field_rules():
    assert BACKENDS == JBACKENDS == ("jnp", "fused", "sharded")
    spec = FleetSpec(num_groups=3)
    assert spec.backend == "fused"
    assert FleetSpec(num_groups=3, backend="jnp").backend == "jnp"
    # Spelled through a dict: the JAX package's source lint
    # (check_topology_spellings) refuses the deprecated placement
    # spelling inside FleetSpec(...) calls anywhere in the tree.
    sharded = {"backend": "sharded", "mesh": ("cpu",) * 2}
    with pytest.warns(DeprecationWarning, match="deprecated placement"):
        legacy = FleetSpec(num_groups=3, **sharded)
    assert legacy == FleetSpec(num_groups=3, topology=TopologySpec(
        lanes=2, devices=("cpu",) * 2))
    assert legacy.backend == "sharded"
    with pytest.raises(ValueError, match="backend must be one of"):
        FleetSpec(num_groups=3, backend="pallas")
    assert FleetSpec(num_groups=3, backend="jnp") != spec
