"""The port's dense kernel path against the JAX package.

* CPU: ``kernels.ops.frugal_update_blocked`` / ``frugal_update_auto`` (the
  plain PyTorch version on CPU tensors) vs the JAX grid kernel in interpret
  mode and the JAX auto path; the committed golden file; and the kernel's
  own arithmetic (``csrc/frugal_tick.cuh``) built for the host with g++:
  its per-lane functions against the port's plain ones, its tick-hash
  table against ``core.rng``, and its whole tiled launch
  (``ft_host_dense``) against the JAX scan at every tile edge.
* Card (marker ``cuda``, skipped without a CUDA device): the CUDA kernel
  vs the plain version on the card, every program, three block shapes,
  Q = 1..5, T at the tile edges, both item producers; B2's block-shape
  invariance across block sizes; and the facade's tuned block size.

Tolerance everywhere: bit-exact (float32 compared as int32 bit patterns).
JAX is imported inside the tests that use it: the card tests run where JAX
is not installed (``--noconftest``, see README.md).
"""
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import drift as tdrift
from repro_torch.core import packing as tpacking
from repro_torch.core import program as tprogram
from repro_torch.core import rng as trng
from repro_torch.kernels import frugal_update as tkernel
from repro_torch.kernels import ops as tops

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

PROGS = tprogram.test_instances()
IDS = [p.family for p in PROGS]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")
# The most ticks a dense item tile holds (FT_DENSE_TILE_ROWS, a build-time
# constant of the kernel header).
with open(os.path.join(CSRC, "frugal_tick.cuh")) as _f:
    TILE = int(re.search(r"#define FT_DENSE_TILE_ROWS (\d+)",
                         _f.read()).group(1))


def jax_side(family):
    """(jax.numpy, repro.core.frugal, repro.kernels.ops, the JAX package's
    test instance of ``family``)."""
    import jax.numpy as jnp
    from repro.core import frugal, program
    from repro.kernels import ops

    prog = {p.family: p for p in program.test_instances()}[family]
    return jnp, frugal, ops, prog


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits_equal(a, b, what=""):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(bits(x), bits(y),
                                      err_msg=f"{what} element {i}")


def make_case(prog, g, q, t, seed=0, nan_frac=0.05):
    """Random items (negative, duplicate and NaN ticks included), per-lane
    targets and a non-trivial starting plane tuple, as numpy."""
    rng = np.random.default_rng(seed)
    lanes = g * q
    items = rng.integers(-40, 400, (t, g)).astype(np.float32)
    items[rng.random((t, g)) < nan_frac] = np.nan
    quantile = np.tile(rng.uniform(0.05, 0.95, q).astype(np.float32), g)
    planes = []
    for f in prog.layout.plane_fields:
        if f in prog.layout.heads:
            planes.append(rng.normal(0.0, 150.0, lanes).astype(np.float32))
        elif f.startswith("step"):
            planes.append(rng.integers(-6, 7, lanes).astype(np.float32))
        else:
            planes.append(rng.choice([-1.0, 1.0], lanes).astype(np.float32))
    return items, quantile, planes


# ----------------------------------------------------------------- golden
@pytest.fixture(scope="module")
def golden_file():
    return dict(np.load(golden.GOLDEN))


def test_golden_file_reproduced_by_jax(golden_file):
    """The JAX package still computes exactly the committed file."""
    fresh = golden.build()
    assert sorted(fresh) == sorted(golden_file)
    for k in fresh:
        np.testing.assert_array_equal(bits(fresh[k]), bits(golden_file[k]),
                                      err_msg=k)


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_golden_plain_version(golden_file, prog):
    g, q, t, t_off, g_off, seed = (int(v) for v in golden_file["meta"])
    n = prog.layout.num_words
    words = tuple(torch.from_numpy(golden_file[f"{prog.family}/in{i}"])
                  for i in range(n))
    out = tkernel.frugal_program_dense(
        prog, torch.from_numpy(golden_file["items"]), words,
        torch.from_numpy(golden_file["quantile"]), seed,
        tuple(golden_file[f"{prog.family}/scalars"].tolist()),
        t_offset=t_off, g_offset=g_off, lanes_per_group=q)
    assert_bits_equal(out, [golden_file[f"{prog.family}/out{i}"]
                            for i in range(n)], prog.family)


# ---------------------------------------------------------- ops vs JAX ops
@pytest.mark.parametrize("block", [(32, 64), (128, 100)], ids=str)
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_blocked_matches_jax_grid_kernel(tprog, block):
    """Ragged G and T, Q = 3, against the JAX revisit-grid kernel in
    interpret mode (whose contract pads G and T to the blocks)."""
    jnp, _, jops, jprog = jax_side(tprog.family)
    g, q, t = 23, 3, 173
    items, quantile, planes = make_case(tprog, g, q, t, seed=1)
    t_off, g_off, seed = 2 ** 31 - 90, 11, -77
    block_g, block_t = block
    jout = jops.frugal_update_blocked(
        jnp.repeat(jnp.asarray(items), q, axis=1),
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(quantile), seed,
        t_off, g_off, program=jprog, block_g=block_g, block_t=block_t,
        interpret=True, kernel="grid")
    tout = tops.frugal_update_blocked(
        torch.from_numpy(items), tuple(torch.from_numpy(p) for p in planes),
        torch.from_numpy(quantile), seed, t_off, g_off, program=tprog,
        block_g=block_g, block_t=block_t, lanes_per_group=q)
    assert_bits_equal(jout, tout, tprog.family)


@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_auto_matches_jax_auto(tprog):
    jnp, _, jops, jprog = jax_side(tprog.family)
    g, q, t = 40, 3, 300
    items, quantile, planes = make_case(tprog, g, q, t, seed=2)
    kw = dict(t_offset=2 ** 31 - 150, g_offset=5, lanes_per_group=q)
    jout = jops.frugal_update_auto(
        jnp.asarray(items), tuple(jnp.asarray(p) for p in planes),
        jnp.asarray(quantile), seed=3, program=jprog, **kw)
    tout = tops.frugal_update_auto(
        torch.from_numpy(items), tuple(torch.from_numpy(p) for p in planes),
        torch.from_numpy(quantile), seed=3, program=tprog, **kw)
    assert_bits_equal(jout, tout, tprog.family)


def test_cpu_tensors_run_the_plain_version_without_launching():
    prog = tprogram.make_program("2u")
    items, quantile, planes = make_case(prog, 4, 1, 10)
    before = tkernel.launch_count
    tops.frugal_update_auto(torch.from_numpy(items),
                            tuple(torch.from_numpy(p) for p in planes),
                            torch.from_numpy(quantile), seed=0, program=prog)
    assert tkernel.launch_count == before


def test_dense_refuses_bad_operands():
    prog = tprogram.make_program("2u")
    items = torch.zeros((3, 4))
    words = prog.layout.pack_planes((torch.zeros(4), torch.ones(4),
                                     torch.ones(4)))
    q = torch.full((4,), 0.5)
    with pytest.raises(ValueError, match="state words"):
        tkernel.frugal_program_dense(prog, items, words[:1], q, 0)
    with pytest.raises(ValueError, match="quantile"):
        tkernel.frugal_program_dense(prog, items, words, q[:3], 0)
    with pytest.raises(ValueError, match="no dense kernel"):
        tkernel.frugal_program_dense(prog, items.to("meta"),
                                     tuple(w.to("meta") for w in words),
                                     q.to("meta"), 0)


# ------------------------------------------- the tick header, built on CPU
@pytest.fixture(scope="module")
def tick_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "frugal_tick.cuh cannot be compiled")
    out = tmp_path_factory.mktemp("tick") / "libtick.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(out), os.path.join(CSRC, "tick_host_shim.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i64, i32, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, \
        ctypes.c_int
    lib.ft_host_counter.argtypes = [i64, p, p, p, p, p]
    lib.ft_host_pack.argtypes = [i64, p, p, p]
    lib.ft_host_unpack.argtypes = [i64, p, p, p]
    lib.ft_host_window_phase.argtypes = [i64, p, i32, p, p]
    lib.ft_host_tick.argtypes = [i, i64] + [p] * 9 + [i32] * 3
    lib.ft_host_tick.restype = i
    lib.ft_host_dense.argtypes = ([i, i32] + [p] * 14 + [i64] * 3
                                  + [i32] * 6 + [p])
    lib.ft_host_dense.restype = i
    lib.ft_host_tick_table.argtypes = [i64, i32, i32, p]
    return lib


def ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data


EDGE_TICKS = np.asarray([0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1,
                         12345, -98765], np.int32)


def test_header_counter_hash(tick_lib):
    rng = np.random.default_rng(5)
    n = 4000
    seed = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    t = np.concatenate([np.resize(EDGE_TICKS, 1000),
                        rng.integers(-2 ** 31, 2 ** 31, n - 1000)]
                       ).astype(np.int32)
    lane = rng.integers(0, 2 ** 24, n).astype(np.int32)
    hb = np.empty(n, np.uint32)
    hu = np.empty(n, np.float32)
    tick_lib.ft_host_counter(n, ptr(seed), ptr(t), ptr(lane), ptr(hb),
                             ptr(hu))
    args = [torch.from_numpy(x) for x in (seed, t, lane)]
    np.testing.assert_array_equal(hb.view(np.int32),
                                  trng.counter_bits(*args).numpy())
    np.testing.assert_array_equal(hu.view(np.int32),
                                  bits(trng.counter_uniform(*args)))


def _step_domain(rng, n):
    special = np.asarray([0.0, -0.0, 1.0, -1.0, 2.0 ** -63, -(2.0 ** -63),
                          2.0 ** -64, 1e-40, 5e-45, 2.0 ** 32, -(2.0 ** 32),
                          1e38, np.inf, -np.inf, np.nan, 4294967040.0,
                          -4294967040.0, 0.75, 3.5], np.float32)
    rand = (rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n))
    return np.concatenate([special, rand.astype(np.float32)])


def test_header_packing_domain(tick_lib):
    rng = np.random.default_rng(6)
    step = _step_domain(rng, 3000)
    for sgn in (1.0, -1.0):
        sign = np.full_like(step, sgn)
        hp = np.empty(step.size, np.uint32)
        tick_lib.ft_host_pack(step.size, ptr(step), ptr(sign), ptr(hp))
        tp = tpacking.pack_step_sign(torch.from_numpy(step),
                                     torch.from_numpy(sign))
        np.testing.assert_array_equal(hp.view(np.int32), tp.numpy())
    words = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 3000),
                            [0, -2 ** 31, 1, -1]]).astype(np.int32)
    hs = np.empty(words.size, np.float32)
    hg = np.empty(words.size, np.float32)
    tick_lib.ft_host_unpack(words.size, ptr(words), ptr(hs), ptr(hg))
    ts, tg = tpacking.unpack_step_sign(torch.from_numpy(words))
    np.testing.assert_array_equal(hs.view(np.int32), bits(ts))
    np.testing.assert_array_equal(hg.view(np.int32), bits(tg))


@pytest.mark.parametrize("w", [1, 2, 7, 96, 4096])
def test_header_window_phase_on_negative_ticks(tick_lib, w):
    rng = np.random.default_rng(w)
    t = np.concatenate([EDGE_TICKS, np.arange(-3 * w - 5, 3 * w + 5),
                        rng.integers(-2 ** 31, 2 ** 31, 2000)]
                       ).astype(np.int32)
    ha = np.empty(t.size, np.uint8)
    hb = np.empty(t.size, np.uint8)
    tick_lib.ft_host_window_phase(t.size, ptr(t), w, ptr(ha), ptr(hb))
    ra, rb = tdrift.window_phase(torch.from_numpy(t), w)
    np.testing.assert_array_equal(ha.astype(bool), ra.numpy())
    np.testing.assert_array_equal(hb.astype(bool), rb.numpy())


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_header_tick_matches_program_tick(tick_lib, prog):
    """One tick of each family on random and edge states: NaN items,
    steps at the packing limits, window boundaries at wrapped ticks."""
    rng = np.random.default_rng(7)
    n = 3000
    fields = ("m", "step", "sign", "m2", "step2", "sign2")
    planes = {
        "m": rng.normal(0.0, 100.0, n).astype(np.float32),
        "step": np.concatenate([[4294967040.0, -4294967040.0, 2.0 ** -63,
                                 0.0, -0.0],
                                rng.integers(-9, 10, n - 5)]
                               ).astype(np.float32),
        "sign": rng.choice([-1.0, 1.0], n).astype(np.float32),
    }
    planes["m2"] = rng.normal(0.0, 100.0, n).astype(np.float32)
    planes["step2"] = rng.integers(-9, 10, n).astype(np.float32)
    planes["sign2"] = rng.choice([-1.0, 1.0], n).astype(np.float32)
    item = rng.normal(0.0, 100.0, n).astype(np.float32)
    item[::7] = np.nan
    item[::11] = planes["m"][::11]          # ties
    u = trng.counter_uniform(3, 9, torch.arange(n, dtype=torch.int32))
    q = rng.uniform(0.01, 0.99, n).astype(np.float32)
    scalars = prog.scalar_values() + (0, 0)
    for t in (-2 ** 31, -97, -96, 0, 96, 2 ** 31 - 1):
        host = {f: planes[f].copy() for f in fields}
        rc = tick_lib.ft_host_tick(
            tkernel.FAMILY_IDS[prog.kernel_family], n,
            *[ptr(host[f]) for f in fields], ptr(item), ptr(u.numpy()),
            ptr(q), t, scalars[0], scalars[1])
        assert rc == 0
        ctx = tprogram.frugal.TickCtx(
            quantile=torch.from_numpy(q), t=t, seed=3,
            lanes=torch.arange(n, dtype=torch.int32),
            scalars=prog.scalar_values())
        want = prog.run_tick(tuple(torch.from_numpy(planes[f])
                                   for f in prog.layout.plane_fields),
                             torch.from_numpy(item), u, ctx)
        assert_bits_equal([host[f] for f in prog.layout.plane_fields], want,
                          f"{prog.family} t={t}")


def host_dense(tick_lib, tprog, fmt, items, quantile, state, q, t_off,
               g_off, seed, block_g):
    """One launch of the dense kernel run on the host (ft_host_dense: the
    plan, tick tables, staged tiles and ft_run_group) with the state in
    ``fmt`` (a key of ``STATE_FORMATS``); returns (state out, plan)."""
    state = [np.ascontiguousarray(x) for x in state]
    outs = [np.empty_like(x) for x in state]
    pin = [ptr(x) for x in state] + [None] * (6 - len(state))
    pout = [ptr(o) for o in outs] + [None] * (6 - len(outs))
    sc = tprog.scalar_values() + (0, 0)
    plan = np.zeros(6, np.int64)
    t, g = items.shape
    rc = tick_lib.ft_host_dense(
        tkernel.FAMILY_IDS[tprog.kernel_family], tkernel.STATE_FORMATS[fmt],
        ptr(items), ptr(quantile), *pin, *pout, t, g, q, seed,
        trng.wrap_i32(t_off), trng.wrap_i32(g_off), sc[0], sc[1], block_g,
        ptr(plan))
    assert rc == 0
    return outs, dict(zip(("lpt", "rows", "cols", "box", "tiles", "blocks"),
                          plan.tolist()))


def host_dense_vs_jax(tick_lib, tprog, g, q, t, t_off, g_off, seed,
                      block_g, case_seed):
    """The dense kernel's launch run on the host against the JAX scan
    ``program_process_seeded``, words in and out, bit-exact; returns the
    launch's plan."""
    jnp, jfrugal, _, jprog = jax_side(tprog.family)
    items, quantile, planes = make_case(tprog, g, q, t, seed=case_seed)
    layout = jprog.layout
    jp, _ = jfrugal.program_process_seeded(
        jprog, tuple(jnp.asarray(p) for p in planes), jnp.asarray(items),
        seed, jnp.asarray(quantile), t_offset=t_off, g_offset=g_off,
        lanes_per_group=q)
    want = [np.asarray(w) for w in layout.pack_planes(jp)]
    words = [np.asarray(w) for w in layout.pack_planes(
        tuple(jnp.asarray(p) for p in planes))]
    outs, plan = host_dense(tick_lib, tprog, "words", items, quantile, words,
                            q, t_off, g_off, seed, block_g)
    assert_bits_equal(outs, want, f"{tprog.family} G={g} Q={q} T={t}")
    return plan


@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_header_dense_run_matches_jax(tick_lib, tprog):
    """The kernel's whole launch (ft_host_dense), host-built, vs the JAX
    scan: words in, T ticks across the int32 wrap in 13 tiles, words
    out, at the default block size."""
    plan = host_dense_vs_jax(tick_lib, tprog, 30, 3, 400, 2 ** 31 - 200,
                             2 ** 31 - 50, 99, tkernel.DEFAULT_BLOCK_G, 8)
    assert plan["tiles"] == -(-400 // TILE)


TILE_TICKS = (1, TILE - 1, TILE + 3, 2 * TILE + 1)
TILE_GROUPS = (36, 37, 39)          # G % 4 = 0, 1, 3


@pytest.mark.parametrize("t", TILE_TICKS)
@pytest.mark.parametrize("q", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_header_dense_tiles_match_jax(tick_lib, tprog, q, t):
    """Every tile edge of the kernel's launch, host-built, vs the JAX scan:
    Q = 1..5 (Q = 5 one lane per thread), T short of, just past and
    twice past a tile, a ragged G (cycling through G % 4 = 0, 1, 3), ticks
    from within 64 of 2^31 across the int32 wrap, absolute lane ids
    across it too, 32-thread blocks (several per launch)."""
    g = TILE_GROUPS[(TILE_TICKS.index(t) + q) % len(TILE_GROUPS)]
    plan = host_dense_vs_jax(tick_lib, tprog, g, q, t, 2 ** 31 - 20,
                             2 ** 31 - 70, 4321, 32, 100 + 7 * q + t)
    assert plan["lpt"] == (q if q <= 4 else 1)
    assert plan["tiles"] == -(-t // plan["rows"])
    assert plan["rows"] == (TILE if t >= TILE else -(-t // 4) * 4)
    assert plan["blocks"] > 1


@pytest.mark.parametrize("seed", [0, 99, -2 ** 31, 2 ** 31 - 1])
def test_header_tick_table_is_counter_first_round(tick_lib, seed):
    """The dense kernel's shared tick-hash table (ft_fill_tick_tables) is
    the first round of ``counter_bits`` (``core.rng.tick_hash``), the
    ticks wrapping at int32; the lane round on top gives counter_bits."""
    for t0 in (0, -1, 2 ** 31 - 40, -2 ** 31, 123456):
        n = 96
        th = np.empty(n, np.uint32)
        tick_lib.ft_host_tick_table(n, seed, t0, ptr(th))
        ticks = torch.from_numpy(((np.arange(n, dtype=np.int64) + t0 + 2 ** 31)
                                  % 2 ** 32 - 2 ** 31).astype(np.int32))
        np.testing.assert_array_equal(th.view(np.int32),
                                      trng.tick_hash(seed, ticks).numpy())
        lanes = torch.arange(n, dtype=torch.int32) * 7919
        np.testing.assert_array_equal(
            trng.counter_bits(seed, ticks, lanes).numpy(),
            trng._fmix32(torch.from_numpy(th.view(np.int32))
                         + lanes * trng._C_GROUP).numpy())


# ------------------------------------------- the state formats: planes
# Steps outside the packing's domain, each planted with sign +1, -1 and 0:
# the planes format has to leave them as the word path does (NaN to 0,
# saturation below 2^32, |step| < 2^-63 to 0 with its sign kept).
ODD_STEPS = np.asarray([np.nan, np.inf, -np.inf, 2.0 ** 40, -(2.0 ** 40),
                        2.0 ** -70, -(2.0 ** -70), -0.0], np.float32)


def plant_odd_steps(prog, planes):
    """``planes`` with ODD_STEPS planted in the first lanes of every step
    plane (its sign plane +1, -1, then 0 across three runs of them)."""
    planes = [p.copy() for p in planes]
    fields = prog.layout.plane_fields
    n = ODD_STEPS.size
    for f in fields:
        if f.startswith("step"):
            step = planes[fields.index(f)]
            sign = planes[fields.index(f.replace("step", "sign"))]
            for k, sgn in enumerate((1.0, -1.0, 0.0)):
                step[k * n:(k + 1) * n] = ODD_STEPS
                sign[k * n:(k + 1) * n] = sgn
    return planes


def words_around(prog, planes, run):
    """The word path around ``run``: pack the planes (numpy) into words,
    ``run`` them, unpack the words it returns into planes (torch)."""
    layout = prog.layout
    words = layout.pack_planes(tuple(torch.from_numpy(p) for p in planes))
    out = run([w.numpy() for w in words])
    return layout.unpack_words(tuple(torch.from_numpy(np.asarray(w))
                                     for w in out))


@pytest.mark.parametrize("t", [TILE, TILE + 3])
@pytest.mark.parametrize("q", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_header_dense_planes_match_words(tick_lib, tprog, q, t):
    """ft_host_dense in the planes format against the word path around it
    (unpack_words of ft_host_dense on pack_planes' words), bit for bit as
    int32 patterns: every family, Q = 1..5 (lanes per thread 1-4, and one
    lane per thread), T at and just past a tile edge, a ragged G, 32-thread
    blocks, out-of-domain steps planted with both signs."""
    g = 37
    items, quantile, planes = make_case(tprog, g, q, t, seed=200 + q + t)
    planes = plant_odd_steps(tprog, planes)
    kw = dict(q=q, t_off=2 ** 31 - 11, g_off=2 ** 31 - 40, seed=-5,
              block_g=32)
    got, plan = host_dense(tick_lib, tprog, "planes", items, quantile,
                           planes, **kw)
    want = words_around(tprog, planes, lambda words: host_dense(
        tick_lib, tprog, "words", items, quantile, words, **kw)[0])
    assert_bits_equal(got, want, f"{tprog.family} Q={q} T={t}")
    assert plan["lpt"] == (q if q <= 4 else 1) and plan["blocks"] > 1


@pytest.mark.parametrize("t", [0, 70])
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_dense_planes_plain_version_matches_words(tprog, t):
    """frugal_program_dense_planes on CPU tensors against the word path
    around frugal_program_dense, out-of-domain steps planted, T = 0 (the
    planes through the packed word alone) included; no launch."""
    g, q = 30, 3
    items, quantile, planes = make_case(tprog, g, q, t, seed=300 + t)
    planes = plant_odd_steps(tprog, planes)
    kw = dict(t_offset=2 ** 31 - 20, g_offset=7, lanes_per_group=q)
    x, qv = torch.from_numpy(items), torch.from_numpy(quantile)
    before = dict(tkernel.state_io_launch_count)
    got = tkernel.frugal_program_dense_planes(
        tprog, x, tuple(torch.from_numpy(p) for p in planes), qv, 11, **kw)
    assert tkernel.state_io_launch_count == before
    want = words_around(tprog, planes, lambda words: (
        tkernel.frugal_program_dense(
            tprog, x, tuple(torch.from_numpy(w) for w in words), qv, 11,
            **kw) if t else words))
    assert_bits_equal(got, want, f"{tprog.family} T={t}")


def test_dense_planes_refuse_bad_operands():
    prog = tprogram.make_program("2u")
    items = torch.zeros((3, 4))
    planes = (torch.zeros(4), torch.ones(4), torch.ones(4))
    q = torch.full((4,), 0.5)
    dense = tkernel.frugal_program_dense_planes
    with pytest.raises(ValueError, match="planes"):
        dense(prog, items, planes[:2], q, 0)
    with pytest.raises(ValueError, match="plane"):
        dense(prog, items, (planes[0], planes[1].to(torch.int32), planes[2]),
              q, 0)
    with pytest.raises(ValueError, match="quantile"):
        dense(prog, items, planes, q[:3], 0)
    with pytest.raises(ValueError, match="no dense kernel"):
        dense(prog, items.to("meta"), tuple(p.to("meta") for p in planes),
              q.to("meta"), 0)


# ---------------------------------------------------------------- the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -q -m cuda tests/test_torch_kernels.py)")


CARD_BLOCKS = [(32, None), (256, 128), (1024, 77)]
# (Q, T, G): the tile edges of the host tests at card widths. G % 4 == 0
# stages item tiles by TMA, any other G by cp.async; Q = 5 holds one lane
# per thread.
CARD_CASES = [(3, 300, 1001), (3, 300, 1000), (1, TILE + 3, 4096),
              (2, TILE - 1, 1003), (4, 2 * TILE + 1, 1001),
              (5, 2 * TILE + 1, 1000), (5, 1, 1003)]


def card_operands(prog, g, q, t, seed):
    items, quantile, planes = make_case(prog, g, q, t, seed=seed)
    dev = torch.device("cuda")
    return (torch.from_numpy(items).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in planes),
            torch.from_numpy(quantile).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
@pytest.mark.parametrize("block", CARD_BLOCKS, ids=str)
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_kernel_matches_plain_version(prog, block, case):
    """The CUDA kernel vs the plain version on the card: ragged lanes,
    Q = 1..5, T at the tile edges, ticks across the wrap, NaN ticks, both
    item producers; (block_g, block_t) with None meaning one launch over
    all T."""
    _need_card()
    q, t, g = case
    x, ps, qv = card_operands(prog, g, q, t, 10)
    kw = dict(t_offset=2 ** 31 - 100, g_offset=12345, lanes_per_group=q,
              program=prog)
    block_g, block_t = block
    before = tkernel.launch_count
    producer = "tma" if g % 4 == 0 else "cp.async"
    staged = tkernel.producer_launch_count[producer]
    if block_t is None:
        got = tops.frugal_update_auto(x, ps, qv, seed=5, block_g=block_g,
                                      **kw)
        launches = 1
    else:
        got = tops.frugal_update_blocked(x, ps, qv, 5, block_g=block_g,
                                         block_t=block_t, **kw)
        launches = -(-t // block_t)
    torch.cuda.synchronize()
    assert tkernel.launch_count - before == launches
    assert tkernel.producer_launch_count[producer] - staged == launches
    layout = prog.layout
    want = tkernel.frugal_program_dense_reference(
        prog, x, tuple(w.contiguous() for w in layout.pack_planes(ps)), qv,
        5, t_offset=kw["t_offset"], g_offset=kw["g_offset"],
        lanes_per_group=q)
    assert_bits_equal(layout.pack_planes(got), want, prog.family)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1000, 1001], ids=["tma", "cp.async"])
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_block_g_changes_nothing(prog, g):
    """B2's contract on the redesigned kernel: the same rows launched with
    another block_g (and nothing else changed) give the same words, for
    each producer."""
    _need_card()
    q, t = 3, 2 * TILE + 5
    x, ps, qv = card_operands(prog, g, q, t, 11)
    kw = dict(t_offset=2 ** 31 - 30, g_offset=77, lanes_per_group=q,
              program=prog, block_t=TILE + 1)
    runs = [prog.layout.pack_planes(tops.frugal_update_blocked(
        x, ps, qv, 9, block_g=bg, **kw)) for bg in (32, 96, 256, 512, 1024)]
    torch.cuda.synchronize()
    for got in runs[1:]:
        assert_bits_equal(got, runs[0], prog.family)


@pytest.mark.cuda
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_tuned_blocks_change_nothing(prog):
    """frugal_update_auto with block_g=None takes the roofline tuner's
    block size on the card (32 threads at an E3-like width, where 256
    would leave SMs idle): the same words as at 256, as under a 100-row
    block_override, and as the plain version."""
    _need_card()
    q, t, g = 1, 700, 532
    x, ps, qv = card_operands(prog, g, q, t, 12)
    kw = dict(seed=3, program=prog, t_offset=2 ** 31 - 9)
    assert tops._auto_blocks(prog, (t, g), x.device, q, None) == (32, None)
    before = tkernel.launch_count
    tuned = prog.layout.pack_planes(tops.frugal_update_auto(x, ps, qv, **kw))
    torch.cuda.synchronize()
    assert tkernel.launch_count - before == 1
    at_256 = tops.frugal_update_auto(x, ps, qv, block_g=256, **kw)
    with tops.block_override(block_t=100):
        walk = tops.frugal_update_auto(x, ps, qv, **kw)
    plain = tops.frugal_update_auto(x.cpu(), tuple(p.cpu() for p in ps),
                                    qv.cpu(), **kw)
    for other, what in ((at_256, "256"), (walk, "100-row launches"),
                        (plain, "plain version")):
        assert_bits_equal(prog.layout.pack_planes(other), tuned,
                          f"{prog.family}: {what}")


@pytest.mark.cuda
def test_card_kernel_matches_golden_file(golden_file):
    _need_card()
    g, q, t, t_off, g_off, seed = (int(v) for v in golden_file["meta"])
    dev = torch.device("cuda")
    for prog in tprogram.test_instances():
        n = prog.layout.num_words
        words = tuple(torch.from_numpy(golden_file[f"{prog.family}/in{i}"])
                      .to(dev) for i in range(n))
        out = tkernel.frugal_program_dense(
            prog, torch.from_numpy(golden_file["items"]).to(dev), words,
            torch.from_numpy(golden_file["quantile"]).to(dev), seed,
            t_offset=t_off, g_offset=g_off, lanes_per_group=q)
        assert_bits_equal(out, [golden_file[f"{prog.family}/out{i}"]
                                for i in range(n)], prog.family)


@pytest.mark.cuda
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_fleet_matches_cpu_fleet(prog):
    """The whole slice on the card (kernel launches) vs on the CPU (the
    plain version), fed the same numpy and CUDA-tensor chunks."""
    _need_card()
    from repro_torch.api import FleetSpec, QuantileFleet

    g, t = 5, 400
    spec = FleetSpec(num_groups=g, quantiles=(0.5, 0.9), chunk_t=64,
                     program=prog)
    items = np.random.default_rng(4).integers(0, 800, (t, g)).astype(
        np.float32)
    cut = t // 3
    cpu = QuantileFleet.create(spec, seed=9, device="cpu").ingest(
        items[:cut]).ingest_stream([items[cut:cut + 51], items[cut + 51:]])
    before = tkernel.launch_count
    card = QuantileFleet.create(spec, seed=9, device="cuda")
    card = card.ingest(items[:cut]).ingest_stream(
        [torch.from_numpy(items[cut:cut + 51]).cuda(),
         torch.from_numpy(items[cut + 51:]).cuda()])
    assert tkernel.launch_count > before
    np.testing.assert_array_equal(bits(cpu.estimate()),
                                  bits(card.estimate()))
    for f in prog.layout.plane_fields:
        np.testing.assert_array_equal(
            bits(getattr(cpu.state, f).numpy()),
            bits(getattr(card.state, f).cpu().numpy()), err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1000, 1001], ids=["tma", "cp.async"])
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_planes_match_words(prog, g):
    """The CUDA kernel in the planes format against the words format, with
    the packing around it: every program, both item producers, Q = 3, T
    past a tile edge, out-of-domain steps planted; one launch in each
    format."""
    _need_card()
    q, t = 3, 2 * TILE + 5
    items, quantile, planes = make_case(prog, g, q, t, seed=13)
    planes = plant_odd_steps(prog, planes)
    dev = torch.device("cuda")
    x, qv = torch.from_numpy(items).to(dev), torch.from_numpy(quantile).to(dev)
    kw = dict(t_offset=2 ** 31 - 40, g_offset=99, lanes_per_group=q)
    io = dict(tkernel.state_io_launch_count)
    producer = "tma" if g % 4 == 0 else "cp.async"
    staged = tkernel.producer_launch_count[producer]
    got = tkernel.frugal_program_dense_planes(
        prog, x, tuple(torch.from_numpy(p).to(dev) for p in planes), qv, 7,
        **kw)
    want = words_around(prog, planes, lambda words: tuple(
        w.cpu() for w in tkernel.frugal_program_dense(
            prog, x, tuple(torch.from_numpy(w).to(dev) for w in words), qv,
            7, **kw)))
    torch.cuda.synchronize()
    assert {k: v - io[k] for k, v in tkernel.state_io_launch_count.items()} \
        == {"words": 1, "planes": 1}
    assert tkernel.producer_launch_count[producer] - staged == 2
    assert_bits_equal(got, want, f"{prog.family} G={g}")


@pytest.mark.cuda
def test_card_entry_points_launch_planes():
    """One frugal_update_auto call is one dense launch in the planes
    format and none in the words format."""
    _need_card()
    prog = tprogram.make_program("2u")
    x, ps, qv = card_operands(prog, 1000, 3, 100, 14)
    io = dict(tkernel.state_io_launch_count)
    tops.frugal_update_auto(x, ps, qv, seed=2, program=prog,
                            lanes_per_group=3)
    torch.cuda.synchronize()
    assert {k: v - io[k] for k, v in tkernel.state_io_launch_count.items()} \
        == {"words": 0, "planes": 1}


@pytest.mark.cuda
def test_card_2u_stream_matches_the_word_path(monkeypatch):
    """A 2U fleet's ingest_stream on the card against the same stream with
    the entry points' launches made as they were before the kernel took
    planes (pack_planes, frugal_program_dense, unpack_words): the same
    planes and estimate(), out-of-domain steps planted in the start."""
    _need_card()
    from repro_torch.api import FleetSpec, QuantileFleet

    prog = tprogram.make_program("2u")
    g, t = 1001, 300
    spec = FleetSpec(num_groups=g, quantiles=(0.5, 0.9, 0.99), chunk_t=128,
                     program=prog)
    rng = np.random.default_rng(15)
    start = QuantileFleet.create(spec, seed=21, device="cuda").ingest(
        rng.normal(1e4, 1250.0, (40, g)).astype(np.float32))
    planes = plant_odd_steps(prog, [getattr(start.state, f).cpu().numpy()
                                    for f in prog.layout.plane_fields])
    start = dataclasses.replace(start, state=start.state.with_planes(
        tuple(torch.from_numpy(p).cuda() for p in planes)))
    chunks = [torch.from_numpy(rng.normal(1e4, 1250.0, (n, g)).astype(
        np.float32)).cuda() for n in (t - 77, 77)]
    io = dict(tkernel.state_io_launch_count)
    now = start.ingest_stream(chunks)
    torch.cuda.synchronize()
    moved = {k: v - io[k] for k, v in tkernel.state_io_launch_count.items()}
    assert moved["words"] == 0 and moved["planes"] > 0

    layout = prog.layout

    def word_path(program, items, planes, *args, **kw):
        words = tuple(w.contiguous() for w in layout.pack_planes(planes))
        return layout.unpack_words(tkernel.frugal_program_dense(
            program, items, words, *args, **kw))

    monkeypatch.setattr(tops, "frugal_program_dense_planes", word_path)
    before = start.ingest_stream(chunks)
    torch.cuda.synchronize()
    for f in layout.plane_fields:
        np.testing.assert_array_equal(
            bits(getattr(now.state, f)), bits(getattr(before.state, f)),
            err_msg=f)
    np.testing.assert_array_equal(bits(now.estimate()),
                                  bits(before.estimate()))
