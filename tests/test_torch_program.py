"""The port's lane programs and their plain ingest loop against the JAX
package: ``program_process_seeded`` for every ``test_instances()`` program,
bit-exact, across lanes_per_group, lane offsets, ticks across the int32
wrap (so the window rules see negative ticks), NaN ticks, and negative and
duplicate items; plus the registry and the word layout."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import frugal as jfrugal
from repro.core import program as jprogram
from repro_torch.core import frugal as tfrugal
from repro_torch.core import program as tprogram

PAIRS = list(zip(jprogram.test_instances(), tprogram.test_instances()))
IDS = [p.family for p, _ in PAIRS]


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def case(prog, g, q, t, seed):
    rng = np.random.default_rng(seed)
    lanes = g * q
    items = rng.integers(-300, 300, (t, g)).astype(np.float32)
    items[:, 0] = items[0, 0]                       # one duplicate stream
    items[rng.random((t, g)) < 0.07] = np.nan
    items[t // 2] = np.nan                          # an all-NaN row
    quantile = np.tile(rng.uniform(0.05, 0.95, q).astype(np.float32), g)
    planes = []
    for f in prog.layout.plane_fields:
        if f in prog.layout.heads:
            planes.append(rng.normal(0.0, 50.0, lanes).astype(np.float32))
        elif f.startswith("step"):
            planes.append(rng.integers(-4, 5, lanes).astype(np.float32))
        else:
            planes.append(rng.choice([-1.0, 1.0], lanes).astype(np.float32))
    return items, quantile, planes


@pytest.mark.parametrize("offsets", [(0, 0), (2 ** 31 - 250, 17),
                                     (-2 ** 31 + 3, 2 ** 31 - 40)],
                         ids=["zero", "wrap", "negative"])
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_program_process_seeded_matches_jax(pair, q, offsets):
    jprog, tprog = pair
    g, t = 37, 500
    t_off, g_off = offsets
    items, quantile, planes = case(tprog, g, q, t, seed=q + g_off % 7)
    jp, jtr = jfrugal.program_process_seeded(
        jprog, tuple(jnp.asarray(p) for p in planes), jnp.asarray(items),
        -123, jnp.asarray(quantile), return_trace=True, t_offset=t_off,
        g_offset=g_off, lanes_per_group=q)
    tp, ttr = tfrugal.program_process_seeded(
        tprog, tuple(torch.from_numpy(p) for p in planes),
        torch.from_numpy(items), -123, torch.from_numpy(quantile),
        return_trace=True, t_offset=t_off, g_offset=g_off,
        lanes_per_group=q)
    for f, a, b in zip(tprog.layout.plane_fields, jp, tp):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)
    np.testing.assert_array_equal(bits(jtr), bits(ttr))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_scalar_quantile_and_fresh_state_match(pair):
    """A scalar target (0.9: rounds differently in float64) on the
    default starting state."""
    jprog, tprog = pair
    items, _, _ = case(tprog, 12, 1, 300, seed=9)
    fill = [tprog.layout.pad_fill(f) for f in tprog.layout.plane_fields]
    jp, _ = jfrugal.program_process_seeded(
        jprog, tuple(jnp.full((12,), v, jnp.float32) for v in fill),
        jnp.asarray(items), 4, 0.9)
    tp, _ = tfrugal.program_process_seeded(
        tprog, tuple(torch.full((12,), v) for v in fill),
        torch.from_numpy(items), 4, 0.9)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_registry_matches_jax():
    assert tprogram.registered_families() == jprogram.registered_families()
    for jp, tp in PAIRS:
        assert (jp.family, jp.algo, jp.kernel_family) == \
            (tp.family, tp.algo, tp.kernel_family)
        assert jp.scalar_values() == tp.scalar_values()
        assert jp.layout.plane_fields == tp.layout.plane_fields
        assert jp.layout.packing == tp.layout.packing
        assert jp.layout.scalar_names == tp.layout.scalar_names
        assert jp.layout.query_fields == tp.layout.query_fields
        assert jp.layout.num_words == tp.layout.num_words == \
            tp.memory_words()
        for f in tp.layout.plane_fields:
            assert jp.layout.pad_fill(f) == tp.layout.pad_fill(f)
    assert tprogram.family_base("2u") is tprogram.family_base("2u")
    dec = tprogram.program_for("2u", tprogram.DriftConfig(mode="decay",
                                                          half_life=7))
    assert dec.family == "2u-decay" and dec.drift.half_life == 7
    assert tprogram.program_for("2u", dp_epsilon=2.0).family == "2u-dp"
    with pytest.raises(ValueError, match="unknown lane program"):
        tprogram.make_program("3u")
    with pytest.raises(ValueError, match="takes no"):
        tprogram.make_program("1u", window=3)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_word_layout_matches_jax(pair):
    jprog, tprog = pair
    _, _, planes = case(tprog, 16, 2, 1, seed=3)
    jw = jprog.layout.pack_planes(tuple(jnp.asarray(p) for p in planes))
    tw = tprog.layout.pack_planes(tuple(torch.from_numpy(p) for p in planes))
    assert [w.dtype for w in tw] == list(tprog.layout.word_dtypes)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(bits(a), bits(b))
    back = tprog.layout.unpack_words(tw)
    for a, b in zip(planes, back):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_query_matches_jax(pair):
    """Every family's query: head, older window plane by cursor parity,
    and the DP rule's Laplace release keyed on (seed, t_next, lane)."""
    jprog, tprog = pair
    rng = np.random.default_rng(11)
    m_planes = tuple(rng.normal(0.0, 10.0, 50).astype(np.float32)
                     for _ in tprog.layout.query_fields)
    lanes = 1000 + np.arange(50, dtype=np.int64)
    for t_next in (1, 95, 96, 97, 193, 2 ** 31 - 1):
        want = jprog.run_query(m_planes, t_next=np.int32(t_next), seed=77,
                               lanes=lanes)
        got = tprog.run_query(m_planes, t_next=np.int32(t_next), seed=77,
                              lanes=lanes)
        np.testing.assert_array_equal(bits(want), bits(got))


# ------------------------------------------------ the rest of core/, kernels/ref
import jax  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import drift as jdrift  # noqa: E402
from repro.core import rng as jrng  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.kernels import ref as jkref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import drift as tdrift  # noqa: E402
from repro_torch.core import rng as trng  # noqa: E402
from repro_torch.core import sketch as tsketch  # noqa: E402
from repro_torch.kernels import ref as tkref  # noqa: E402

OFFSETS = [(0, 0), (2 ** 31 - 150, 5), (-2 ** 31 + 7, 2 ** 31 - 9)]
OFFSET_IDS = ["zero", "wrap", "negative"]


def key_words(k):
    """The uint32 words of a JAX key: how the port takes a key."""
    return np.asarray(jax.random.key_data(k))


def assert_same(a, b, msg=""):
    np.testing.assert_array_equal(bits(np.asarray(a)), bits(np.asarray(b)),
                                  err_msg=msg)


@pytest.mark.parametrize("num", [1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 123, 2 ** 31 + 5])
def test_tick_uniforms_matches_jax(seed, num):
    k = jax.random.PRNGKey(seed)
    assert_same(jrng.tick_uniforms(k, num),
                trng.tick_uniforms(key_words(k), num, device="cpu"))


@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_init_matches_jax(algo):
    g = 9
    init = np.linspace(-4.0, 4.0, g).astype(np.float32)
    for value in (0.0, 2.5, init):
        js = getattr(jcore, f"frugal{algo}_init")(g, jnp.asarray(value))
        ts = getattr(tcore, f"frugal{algo}_init")(g, torch.as_tensor(value),
                                                  device="cpu")
        assert type(ts).__name__ == type(js).__name__
        for a, b in zip(js, ts):
            assert_same(a, b)
        ptrs = {x.data_ptr() for x in ts}
        assert len(ptrs) == len(ts)       # a buffer of its own per leaf


def planes_case(algo, g, q, t, seed):
    prog = tprogram.program_for(algo)
    items, quantile, planes = case(prog, g, q, t, seed)
    return items, quantile, planes


@pytest.mark.parametrize("offsets", OFFSETS, ids=OFFSET_IDS)
@pytest.mark.parametrize("family", ["1u", "2u", "2u-decay"])
def test_frugal_process_seeded_matches_jax(family, offsets):
    t_off, g_off = offsets
    algo = family[:2]
    drift = tdrift.DriftConfig(mode="decay", half_life=37) \
        if family == "2u-decay" else None
    jd = jdrift.DriftConfig(mode="decay", half_life=37) if drift else None
    items, quantile, planes = planes_case(algo, 11, 2, 300, seed=len(family))
    jstate = getattr(jcore.frugal, f"Frugal{algo.upper()}State")(
        *(jnp.asarray(p) for p in planes))
    tstate = getattr(tfrugal, f"Frugal{algo.upper()}State")(
        *(torch.from_numpy(p) for p in planes))
    kw = dict(return_trace=True, t_offset=t_off, g_offset=g_off,
              lanes_per_group=2)
    if algo == "1u":
        jst, jtr = jcore.frugal.frugal1u_process_seeded(
            jstate, jnp.asarray(items), 77, jnp.asarray(quantile), **kw)
        tst, ttr = tfrugal.frugal1u_process_seeded(
            tstate, torch.from_numpy(items), 77,
            torch.from_numpy(quantile), **kw)
    else:
        jst, jtr = jcore.frugal.frugal2u_process_seeded(
            jstate, jnp.asarray(items), 77, jnp.asarray(quantile),
            drift=jd, **kw)
        tst, ttr = tfrugal.frugal2u_process_seeded(
            tstate, torch.from_numpy(items), 77,
            torch.from_numpy(quantile), drift=drift, **kw)
    assert type(tst).__name__ == type(jst).__name__
    for f, a, b in zip(jst._fields, jst, tst):
        assert_same(a, b, f)
    assert_same(jtr, ttr)


def test_frugal2u_process_seeded_refuses_window():
    st = tfrugal.frugal2u_init(3, device="cpu")
    with pytest.raises(ValueError, match="decay' only"):
        tfrugal.frugal2u_process_seeded(
            st, torch.zeros(2, 3), 0,
            drift=tdrift.DriftConfig(mode="window", window=4))


@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_frugal_process_key_and_fed_rand_match_jax(algo):
    items, quantile, planes = planes_case(algo, 6, 1, 200, seed=5)
    jinit = getattr(jcore, f"frugal{algo}_init")
    tinit = getattr(tcore, f"frugal{algo}_init")
    jproc = getattr(jcore, f"frugal{algo}_process")
    tproc = getattr(tcore, f"frugal{algo}_process")
    k = jax.random.PRNGKey(42)
    jst, jtr = jproc(jinit(6), jnp.asarray(items), key=k, quantile=0.3,
                     return_trace=True, t_offset=2 ** 31 - 100, g_offset=3)
    tst, ttr = tproc(tinit(6, device="cpu"), torch.from_numpy(items),
                     key=key_words(k), quantile=0.3, return_trace=True,
                     t_offset=2 ** 31 - 100, g_offset=3)
    for a, b in zip(jst, tst):
        assert_same(a, b)
    assert_same(jtr, ttr)
    rand = np.random.default_rng(6).random(items.shape).astype(np.float32)
    jst, jtr = jproc(jinit(6), jnp.asarray(items), rand=jnp.asarray(rand),
                     quantile=jnp.asarray(quantile), return_trace=True)
    tst, ttr = tproc(tinit(6, device="cpu"), torch.from_numpy(items),
                     rand=torch.from_numpy(rand),
                     quantile=torch.from_numpy(quantile), return_trace=True)
    for a, b in zip(jst, tst):
        assert_same(a, b)
    assert_same(jtr, ttr)
    jst, jtr = jproc(jinit(6), jnp.asarray(items), rand=jnp.asarray(rand))
    tst, ttr = tproc(tinit(6, device="cpu"), torch.from_numpy(items),
                     rand=torch.from_numpy(rand))
    assert jtr is None and ttr is None
    assert_same(jst.m, tst.m)
    with pytest.raises(ValueError, match="key or rand"):
        tproc(tinit(6, device="cpu"), torch.from_numpy(items))


@pytest.mark.parametrize("offsets", OFFSETS, ids=OFFSET_IDS)
@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_window_process_seeded_matches_jax(algo, offsets):
    t_off, g_off = offsets
    items, quantile, _ = planes_case(algo, 7, 3, 300, seed=8)
    rng = np.random.default_rng(9)
    planes = [rng.normal(0, 30, 21).astype(np.float32) for _ in range(2)]
    steps = [rng.integers(-3, 4, 21).astype(np.float32) for _ in range(2)]
    signs = [rng.choice([-1.0, 1.0], 21).astype(np.float32)
             for _ in range(2)]
    if algo == "1u":
        steps = signs = [np.ones(21, np.float32)] * 2
    leaves = (planes[0], steps[0], signs[0], planes[1], steps[1], signs[1])
    jcfg = jdrift.DriftConfig(mode="window", window=96)
    tcfg = tdrift.DriftConfig(mode="window", window=96)
    kw = dict(return_trace=True, t_offset=t_off, g_offset=g_off,
              lanes_per_group=3, algo=algo)
    jst, jtr = jdrift.window_process_seeded(
        jdrift.WindowState(*(jnp.asarray(x) for x in leaves)),
        jnp.asarray(items), -5, jnp.asarray(quantile), jcfg, **kw)
    tst, ttr = tdrift.window_process_seeded(
        tdrift.WindowState(*(torch.from_numpy(x) for x in leaves)),
        torch.from_numpy(items), -5, torch.from_numpy(quantile), tcfg, **kw)
    for f, a, b in zip(jst._fields, jst, tst):
        assert_same(a, b, f)
    assert_same(jtr, ttr)


def test_window_init_matches_jax():
    for init in (0.0, -3.25, np.arange(5, dtype=np.float32)):
        js = jdrift.window_init(5, jnp.asarray(init))
        ts = tdrift.window_init(5, torch.as_tensor(init), device="cpu")
        for f, a, b in zip(js._fields, js, ts):
            assert_same(a, b, f)
        assert len({x.data_ptr() for x in ts}) == 6


@pytest.mark.parametrize("kw", [dict(mode="decay"),
                                dict(mode="decay", half_life=3, floor=-2.5),
                                dict(mode="window"),
                                dict(mode="window", window=96)],
                         ids=["decay", "decay-params", "window",
                              "window-96"])
def test_drift_config_operands_match_jax(kw):
    j, t = jdrift.DriftConfig(**kw), tdrift.DriftConfig(**kw)
    assert t.windowed == j.windowed
    assert t.operand_slots() == j.operand_slots()


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_num_planes_matches_jax(pair):
    jprog, tprog = pair
    assert tprog.layout.num_planes == jprog.layout.num_planes == \
        len(tprog.layout.plane_fields)


SKETCH_KINDS = [("1u", None), ("2u", None), ("2u", dict(mode="decay",
                                                        half_life=50)),
                ("1u", dict(mode="window", window=40)),
                ("2u", dict(mode="window", window=40))]
SKETCH_IDS = ["1u", "2u", "2u-decay", "1u-window", "2u-window"]


@pytest.mark.parametrize("kind", SKETCH_KINDS, ids=SKETCH_IDS)
def test_sketch_process_matches_jax(kind):
    algo, dkw = kind
    jd = jdrift.DriftConfig(**dkw) if dkw else None
    td = tdrift.DriftConfig(**dkw) if dkw else None
    items = np.random.default_rng(2).normal(0, 40, (150, 8)).astype(
        np.float32)
    items[::17] = np.nan
    k = jax.random.PRNGKey(9)
    qs = (0.25, 0.9)
    js = jsketch.GroupedQuantileSketch.create_lanes(8, qs, algo=algo,
                                                    drift=jd)
    ts = tsketch.GroupedQuantileSketch.create_lanes(8, qs, algo=algo,
                                                    drift=td, device="cpu")
    js = js.process(jnp.asarray(items), k, g_offset=2 ** 31 - 3,
                    lanes_per_group=2)
    ts = ts.process(items, key_words(k), g_offset=2 ** 31 - 3,
                    lanes_per_group=2)
    assert ts.device.type == "cpu"
    for f in ts.program.layout.plane_fields:
        assert_same(getattr(js, f), getattr(ts, f), f)


@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_sketch_update_matches_jax(algo):
    rng = np.random.default_rng(3)
    js = jsketch.GroupedQuantileSketch.create(10, quantile=0.7, algo=algo)
    ts = tsketch.GroupedQuantileSketch.create(10, quantile=0.7, algo=algo,
                                              device="cpu")
    for i in range(40):
        items = rng.normal(0, 5, 10).astype(np.float32)
        rand = rng.random(10).astype(np.float32)
        if i % 2:
            js = jsketch.sketch_update_jit(js, jnp.asarray(items),
                                           jnp.asarray(rand), algo=algo)
            ts = tsketch.sketch_update_jit(ts, torch.from_numpy(items),
                                           torch.from_numpy(rand), algo=algo)
        else:
            js = js.update(jnp.asarray(items), jnp.asarray(rand))
            ts = ts.update(torch.from_numpy(items), torch.from_numpy(rand))
    for f in ts.program.layout.plane_fields:
        assert_same(getattr(js, f), getattr(ts, f), f)
    dec = tsketch.GroupedQuantileSketch.create(
        3, drift=tdrift.DriftConfig(mode="decay"), device="cpu")
    with pytest.raises(ValueError, match="carries no stream tick"):
        dec.update(torch.zeros(3), torch.zeros(3))


def test_core_exports_match_jax():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (300, 130)],
                         ids=["1x1", "7x3", "300x130"])
@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_kernels_ref_matches_jax_and_plain(algo, shape):
    t, g = shape
    items, quantile, planes = planes_case(algo, g, 1, t, seed=t + g)
    t_off, g_off = 2 ** 31 - 1 - t // 2, 2 ** 31 - 1 - g // 2
    jfn = getattr(jkref, f"frugal{algo}_ref_fused")
    tfn = getattr(tkref, f"frugal{algo}_ref_fused")
    jout = jfn(jnp.asarray(items), *(jnp.asarray(p) for p in planes),
               jnp.asarray(quantile), 31, t_offset=t_off, g_offset=g_off)
    tout = tfn(torch.from_numpy(items), *(torch.from_numpy(p)
                                          for p in planes),
               torch.from_numpy(quantile), 31, t_offset=t_off,
               g_offset=g_off)
    plain, _ = tfrugal.program_process_seeded(
        tprogram.family_base(algo), tuple(torch.from_numpy(p)
                                          for p in planes),
        torch.from_numpy(items), 31, torch.from_numpy(quantile),
        t_offset=t_off, g_offset=g_off)
    if algo == "1u":
        jout, tout = (jout,), (tout,)
    for a, b, c in zip(jout, tout, plain):
        assert_same(a, b)
        assert_same(b, c)
