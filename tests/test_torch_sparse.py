"""The port's sparse event path against the JAX package.

* CPU: ``kernels.ops.frugal_update_sparse`` (the plain PyTorch version on
  CPU tensors) vs the JAX package's ``frugal_update_sparse`` on its jnp
  scatter pair (``interpret=None`` off a TPU), on rounds of distinct lanes
  and on batches of event runs (each lane's events adjacent, split into
  rounds for JAX); the run kernel's own arithmetic
  (``ft_run_lane_events`` in ``csrc/frugal_tick.cuh``) built for the host
  with g++; the committed golden rounds and run batch; and the
  ``QuantileFleet`` event API (per-lane clock, ``tick_lanes``,
  ``tick_lanes_sparse``, ``grow_groups``, ``estimate``) vs the JAX facade.
* Card (marker ``cuda``, skipped without a CUDA device): the run kernel
  vs its plain version on the card (rounds and run batches), pads on one
  lane, in-place updates, the golden rounds and run batch, and an
  ``SLOFleet`` of 10^4 routes vs one on the CPU.

Tolerance everywhere: bit-exact (float32 compared as int32 bit patterns,
clocks compared exactly). JAX is imported inside the tests that use it:
the card tests run where JAX is not installed (``--noconftest``).
"""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import FleetSpec, QuantileFleet, from_jax_state
from repro_torch.core import program as tprogram
from repro_torch.kernels import frugal_update as tkernel
from repro_torch.kernels import ops as tops

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

PROGS = tprogram.test_instances()
IDS = [p.family for p in PROGS]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")
L, K, ROUNDS = 4099, 300, 3
G_OFFSET = 2 ** 31 - 1000          # g_offset + lane wraps for high lanes
RUN_K = 600                        # a run batch's slots (longest run ~100)


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits_equal(a, b, what=""):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(bits(x), bits(y),
                                      err_msg=f"{what} element {i}")


def jax_prog(family):
    from repro.core import program

    return {p.family: p for p in program.test_instances()}[family]


def jax_rounds(family, planes, ticks, quantile, rounds, seed, g_offset):
    """The JAX package's jnp sparse rounds (never the Pallas interpret
    kernel): (planes, ticks) after every round."""
    import jax.numpy as jnp
    from repro.kernels import ops

    jprog = jax_prog(family)
    ps, tk = tuple(jnp.asarray(p) for p in planes), jnp.asarray(ticks)
    q = jnp.asarray(quantile)
    states = []
    for lanes, items, mask in rounds:
        ps, tk = ops.frugal_update_sparse(
            jnp.asarray(lanes), jnp.asarray(items), jnp.asarray(mask), ps,
            tk, q, seed, program=jprog, g_offset=g_offset)
        states.append((tuple(np.asarray(p) for p in ps), np.asarray(tk)))
    return states


# ------------------------------------------------------ ops vs JAX ops
@pytest.mark.parametrize("donate", [False, True], ids=["copy", "donate"])
@pytest.mark.parametrize("scalar_q", [False, True], ids=["q[L]", "q"])
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_sparse_rounds_match_jax(tprog, scalar_q, donate):
    planes, ticks, quantile, rounds = golden.sparse_case(tprog, L, K,
                                                         ROUNDS, 1)
    if scalar_q:
        quantile = np.float32(0.9)
    want = jax_rounds(tprog.family, planes, ticks, quantile, rounds, -77,
                      G_OFFSET)
    ps = tuple(torch.from_numpy(p.copy()) for p in planes)
    tk = torch.from_numpy(ticks.copy())
    q = torch.as_tensor(quantile)
    for r, ((lanes, items, mask), (wp, wt)) in enumerate(zip(rounds, want)):
        before = [p.clone() for p in ps], tk.clone()
        nps, ntk = tops.frugal_update_sparse(
            torch.from_numpy(lanes), torch.from_numpy(items),
            torch.from_numpy(mask), ps, tk, q, -77, program=tprog,
            g_offset=G_OFFSET, donate=donate)
        assert_bits_equal(nps, wp, f"{tprog.family} round {r}")
        np.testing.assert_array_equal(ntk.numpy(), wt)
        if donate:      # the caller's tensors were updated in place
            assert all(a is b for a, b in zip(nps, ps)) and ntk is tk
        else:           # the caller's tensors are untouched
            assert_bits_equal(ps, before[0], "inputs")
            assert torch.equal(tk, before[1])
        ps, tk = nps, ntk


def test_sparse_refuses_bad_operands():
    prog = tprogram.make_program("2u")
    planes = (torch.zeros(8), torch.ones(8), torch.ones(8))
    ticks = torch.zeros(8, dtype=torch.int32)
    lanes = torch.tensor([1, 2], dtype=torch.int32)
    items = torch.tensor([1.0, 2.0])
    mask = torch.ones(2, dtype=torch.int32)
    q = torch.full((8,), 0.5)
    run = tkernel.frugal_program_scatter
    with pytest.raises(ValueError, match="planes"):
        run(prog, lanes, items, mask, planes[:2], ticks, q, 0)
    with pytest.raises(ValueError, match="quantile"):
        run(prog, lanes, items, mask, planes, ticks, q[:3], 0)
    with pytest.raises(ValueError, match="ticks"):
        run(prog, lanes, items, mask, planes, ticks.float(), q, 0)
    with pytest.raises(ValueError, match="mask"):
        run(prog, lanes, items, mask[:1], planes, ticks, q, 0)
    with pytest.raises(ValueError, match="no scatter kernel"):
        run(prog, lanes.to("meta"), items.to("meta"), mask.to("meta"),
            tuple(p.to("meta") for p in planes), ticks.to("meta"),
            q.to("meta"), 0)


def test_cpu_tensors_run_the_plain_version_without_launching():
    prog = tprogram.make_program("2u")
    planes, ticks, quantile, rounds = golden.sparse_case(prog, 256, 64, 1, 0)
    before = tkernel.scatter_launch_count
    lanes, items, mask = rounds[0]
    tops.frugal_update_sparse(lanes, items, mask,
                              tuple(torch.from_numpy(p) for p in planes),
                              torch.from_numpy(ticks), quantile, 0,
                              program=prog)
    assert tkernel.scatter_launch_count == before


# ------------------------------------------------ run batches vs JAX
MASKS = ["mask", "mask=None"]


def run_inputs(prog, seed, masked):
    """(planes, ticks, quantile, port batch, JAX rounds) of a run batch.
    With a mask, the port's mask-0 slots carry finite items (the kernel and
    the plain version force them to NaN; JAX needs NaN there); without
    one, the port gets ``mask=None`` and JAX the mask of non-NaN items."""
    planes, ticks, quantile, (lanes, items, mask), pad_lane = \
        golden.run_case(prog, L, RUN_K, seed)
    assert golden.run_lengths(lanes).max() >= 64
    if masked:
        port = (lanes, np.where(mask == 0, np.float32(123.0), items), mask)
    else:
        port = (lanes, items, None)
        mask = (~np.isnan(items)).astype(np.int32)
    rounds = golden.run_rounds(lanes, items, mask, pad_lane)
    return planes, ticks, quantile, port, rounds


@pytest.mark.parametrize("masked", [True, False], ids=MASKS)
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_run_batch_matches_jax_rounds(tprog, masked):
    planes, ticks, quantile, (lanes, items, mask), rounds = run_inputs(
        tprog, 31, masked)
    want_p, want_t = jax_rounds(tprog.family, planes, ticks, quantile,
                                rounds, -77, G_OFFSET)[-1]
    before = tkernel.scatter_launch_count
    ps, tk = tops.frugal_update_sparse(
        torch.from_numpy(lanes), torch.from_numpy(items),
        None if mask is None else torch.from_numpy(mask),
        tuple(torch.from_numpy(p) for p in planes), torch.from_numpy(ticks),
        torch.from_numpy(quantile), -77, program=tprog, g_offset=G_OFFSET)
    assert tkernel.scatter_launch_count == before
    assert_bits_equal(ps, want_p, tprog.family)
    np.testing.assert_array_equal(tk.numpy(), want_t)


def test_run_ranks_and_plain_version_refuse_lanes_out_of_range():
    lanes = torch.tensor([4, 4, 1, 7, 7, 7, 4], dtype=torch.int32)
    assert tkernel.run_ranks(lanes).tolist() == [0, 1, 0, 0, 1, 2, 0]
    prog = tprogram.make_program("2u")
    planes = (torch.zeros(8), torch.ones(8), torch.ones(8))
    ticks = torch.zeros(8, dtype=torch.int32)
    for bad in (-1, 8):
        with pytest.raises(ValueError, match="lie in"):
            tkernel.frugal_program_scatter_reference(
                prog, torch.tensor([2, bad], dtype=torch.int32),
                torch.ones(2), None, planes, ticks, torch.tensor([0.5]), 0)


# ----------------------------------------------------------------- golden
@pytest.fixture(scope="module")
def golden_file():
    return dict(np.load(golden.GOLDEN))


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_golden_sparse_rounds_plain_version(golden_file, prog):
    ps, tk = golden.sparse_start(golden_file, prog, torch.from_numpy)
    for r, (lanes, items, mask) in enumerate(golden.sparse_rounds(
            golden_file, torch.from_numpy)):
        ps, tk = tkernel.frugal_program_scatter(
            prog, lanes, items, mask, ps, tk,
            torch.from_numpy(golden_file["sparse/quantile"]),
            golden.COUNTER_SEED, g_offset=golden.SPARSE_G_OFFSET)
    want = golden.sparse_final(golden_file, prog)
    assert_bits_equal(ps + (tk,), want, prog.family)


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_golden_run_batch_plain_version(golden_file, prog):
    ps, tk = golden.runs_start(golden_file, prog, torch.from_numpy)
    ps, tk = tkernel.frugal_program_scatter(
        prog, *golden.runs_batch(golden_file, torch.from_numpy), ps, tk,
        torch.from_numpy(golden_file["sparse/quantile"]),
        golden.COUNTER_SEED, g_offset=golden.SPARSE_G_OFFSET)
    assert_bits_equal(ps + (tk,), golden.runs_final(golden_file, prog),
                      prog.family)


# ------------------------------------------- the run body, built on CPU
@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "frugal_tick.cuh cannot be compiled")
    out = tmp_path_factory.mktemp("scatter") / "libtick.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(out), os.path.join(CSRC, "tick_host_shim.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.ft_host_scatter.argtypes = ([ctypes.c_int] + [p] * 4 + [i32]
                                    + [p] * 7 + [i64] * 2 + [i32] * 4)
    lib.ft_host_scatter.restype = ctypes.c_int
    return lib


def host_scatter(lib, prog, planes, ticks, quantile, lanes, items, mask,
                 seed, g_offset):
    """One batch (a round or runs) through the host build of the run
    kernel, in place on the numpy ``planes`` and ``ticks``; ``mask`` may
    be None."""
    q = np.ascontiguousarray(np.atleast_1d(np.asarray(quantile, np.float32)))
    ptrs = [p.ctypes.data for p in planes] + [None] * (6 - len(planes))
    sc = prog.scalar_values() + (0, 0)
    rc = lib.ft_host_scatter(
        tkernel.FAMILY_IDS[prog.kernel_family], lanes.ctypes.data,
        items.ctypes.data, None if mask is None else mask.ctypes.data,
        q.ctypes.data, int(q.size > 1),
        *ptrs, ticks.ctypes.data, lanes.size, ticks.size, seed,
        np.int32(g_offset), sc[0], sc[1])
    assert rc == 0


@pytest.mark.parametrize("scalar_q", [False, True], ids=["q[L]", "q"])
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_host_scatter_matches_jax(host_lib, tprog, scalar_q):
    planes, ticks, quantile, rounds = golden.sparse_case(tprog, L, K,
                                                         ROUNDS, 2)
    if scalar_q:
        quantile = np.float32(0.3)
    want = jax_rounds(tprog.family, planes, ticks, quantile, rounds, 4321,
                      G_OFFSET)
    planes = [np.ascontiguousarray(p) for p in planes]
    for r, ((lanes, items, mask), (wp, wt)) in enumerate(zip(rounds, want)):
        host_scatter(host_lib, tprog, planes, ticks, quantile, lanes, items,
                     mask, 4321, G_OFFSET)
        assert_bits_equal(planes, wp, f"{tprog.family} round {r}")
        np.testing.assert_array_equal(ticks, wt)


@pytest.mark.parametrize("masked", [True, False], ids=MASKS)
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_host_run_batch_matches_jax_rounds(host_lib, tprog, masked):
    planes, ticks, quantile, (lanes, items, mask), rounds = run_inputs(
        tprog, 32, masked)
    want_p, want_t = jax_rounds(tprog.family, planes, ticks, quantile,
                                rounds, 4321, G_OFFSET)[-1]
    planes = [np.ascontiguousarray(p) for p in planes]
    host_scatter(host_lib, tprog, planes, ticks, quantile, lanes, items,
                 mask, 4321, G_OFFSET)
    assert_bits_equal(planes, want_p, tprog.family)
    np.testing.assert_array_equal(ticks, want_t)


def test_host_scatter_skips_lanes_out_of_range(host_lib):
    prog = tprogram.make_program("2u")
    planes = [np.zeros(8, np.float32), np.ones(8, np.float32),
              np.ones(8, np.float32)]
    ticks = np.zeros(8, np.int32)
    lanes = np.asarray([-1, -1, 8, 3, 3], np.int32)
    items = np.full(5, 5.0, np.float32)
    mask = np.ones(5, np.int32)
    host_scatter(host_lib, prog, planes, ticks, 0.5, lanes, items, mask, 0,
                 0)
    np.testing.assert_array_equal(ticks, [0, 0, 0, 2, 0, 0, 0, 0])


# ------------------------------------------------ the fleet's event API
PAIRS = list(zip([jax_prog(p.family) for p in PROGS], PROGS))
G, QS, SEED = 7, (0.5, 0.9), 9


def fleet_pair(jprog, tprog, t_offset=None):
    from repro.api import FleetSpec as JFleetSpec
    from repro.api import QuantileFleet as JQuantileFleet

    jfl = JQuantileFleet.create(
        JFleetSpec(num_groups=G, quantiles=QS, backend="jnp", program=jprog),
        seed=SEED, per_lane_clock=True)
    tfl = QuantileFleet.create(FleetSpec(num_groups=G, quantiles=QS,
                                         program=tprog),
                               seed=SEED, per_lane_clock=True, device="cpu")
    return jfl, tfl


def assert_fleets_same(jfl, tfl, what):
    np.testing.assert_array_equal(bits(jfl.estimate()),
                                  bits(tfl.estimate()),
                                  err_msg=f"{what}: estimates")
    for f in tfl.spec.program.layout.plane_fields:
        np.testing.assert_array_equal(bits(getattr(jfl.state, f)),
                                      bits(getattr(tfl.state, f)),
                                      err_msg=f"{what}: plane {f}")
    np.testing.assert_array_equal(np.asarray(jfl.cursor.t_offset),
                                  tfl.cursor.t_offset.numpy(),
                                  err_msg=f"{what}: clocks")


def event_rounds(n_lanes, n, seed):
    """Rounds of (lanes, items, dense items [L], mask [L]) with distinct
    lanes, NaN events and a dense mask that also holds back NaN lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, n_lanes + 1))
        lanes = rng.choice(n_lanes, k, replace=False).astype(np.int32)
        vals = rng.lognormal(3.0, 1.0, k).astype(np.float32)
        vals[rng.random(k) < 0.1] = np.nan
        dense = np.full(n_lanes, np.nan, np.float32)
        dense[lanes] = vals
        out.append((lanes, vals, dense))
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_fleet_event_api_matches_jax(pair):
    """create(per_lane_clock) -> tick_lanes (with and without mask) ->
    tick_lanes_sparse (both donate modes) -> grow_groups -> more rounds,
    against the JAX facade after every step (window query and DP noise
    read the per-lane clock)."""
    jprog, tprog = pair
    jfl, tfl = fleet_pair(jprog, tprog)
    n = G * len(QS)
    rounds = event_rounds(n, 8, 3)
    for r, (lanes, vals, dense) in enumerate(rounds[:2]):
        mask = (~np.isnan(dense)).astype(np.int32) if r else None
        jfl, tfl = jfl.tick_lanes(dense, mask), tfl.tick_lanes(dense, mask)
        assert_fleets_same(jfl, tfl, f"tick_lanes {r}")
    for r, (lanes, vals, _) in enumerate(rounds[2:5]):
        jfl = jfl.tick_lanes_sparse(lanes, vals)
        tfl = tfl.tick_lanes_sparse(lanes, vals, donate=bool(r % 2))
        assert_fleets_same(jfl, tfl, f"tick_lanes_sparse {r}")
    jfl, tfl = jfl.grow_groups(G + 4, init=3.0), tfl.grow_groups(G + 4,
                                                                  init=3.0)
    assert tfl.num_lanes == jfl.num_lanes
    assert_fleets_same(jfl, tfl, "grown")
    for r, (lanes, vals, _) in enumerate(event_rounds(tfl.num_lanes, 3, 4)):
        jfl = jfl.tick_lanes_sparse(lanes, vals)
        tfl = tfl.tick_lanes_sparse(lanes, vals, donate=True)
        assert_fleets_same(jfl, tfl, f"grown round {r}")


@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_sparse_rounds_equal_dense_rounds(tprog):
    spec = FleetSpec(num_groups=24, quantiles=(0.5, 0.9), program=tprog)
    dense = QuantileFleet.create(spec, seed=5, per_lane_clock=True,
                                 device="cpu")
    sparse = QuantileFleet.create(spec, seed=5, per_lane_clock=True,
                                  device="cpu")
    for lanes, vals, items in event_rounds(spec.num_lanes, 6, 6):
        dense = dense.tick_lanes(items)
        sparse = sparse.tick_lanes_sparse(lanes, vals, donate=True)
    np.testing.assert_array_equal(bits(dense.estimate()),
                                  bits(sparse.estimate()))
    assert torch.equal(dense.cursor.t_offset, sparse.cursor.t_offset)
    for f in spec.program.layout.plane_fields:
        np.testing.assert_array_equal(bits(getattr(dense.state, f)),
                                      bits(getattr(sparse.state, f)))


def test_donate_aliases_and_copy_does_not():
    spec = FleetSpec(num_groups=4, quantiles=(0.5,))
    lanes, vals = np.asarray([0, 2], np.int32), np.float32([5.0, 7.0])
    old = QuantileFleet.create(spec, per_lane_clock=True, device="cpu")
    new = old.tick_lanes_sparse(lanes, vals)
    assert old.cursor.t_offset.tolist() == [0, 0, 0, 0]
    assert new.cursor.t_offset.tolist() == [1, 0, 1, 0]
    newer = new.tick_lanes_sparse(lanes, vals, donate=True)
    assert newer.state.m is new.state.m
    assert new.cursor.t_offset.tolist() == [2, 0, 2, 0]


def test_check_duplicates_refuses_both_contract_violations():
    spec = FleetSpec(num_groups=4, quantiles=(0.5,))
    fl = QuantileFleet.create(spec, per_lane_clock=True, device="cpu")
    with pytest.raises(ValueError, match="repeat within one round"):
        fl.tick_lanes_sparse([1, 1], [2.0, 3.0], check_duplicates=True)
    with pytest.raises(ValueError, match="pad slots reuse event lanes"):
        fl.tick_lanes_sparse([1, 1], [2.0, np.nan], [1, 0],
                             check_duplicates=True)
    with pytest.raises(ValueError, match="outside"):
        fl.tick_lanes_sparse([4], [2.0], check_duplicates=True)
    ok = fl.tick_lanes_sparse([1, 2, 2], [2.0, np.nan, np.nan], [1, 0, 0],
                              check_duplicates=True)
    assert ok.cursor.t_offset.tolist() == [0, 1, 0, 0]


def test_clock_modes_refuse_the_other_modes_calls():
    spec = FleetSpec(num_groups=3, quantiles=(0.5,))
    scalar = QuantileFleet.create(spec, device="cpu")
    with pytest.raises(ValueError, match="per-lane cursor"):
        scalar.tick_lanes(np.ones(3, np.float32), mask=np.ones(3))
    with pytest.raises(ValueError, match="per-lane cursor"):
        scalar.tick_lanes_sparse([0], [1.0])
    assert scalar.tick_lanes(np.ones(3, np.float32)).cursor.t_offset == 1
    lanes = QuantileFleet.create(spec, per_lane_clock=True, device="cpu")
    assert lanes.cursor.per_lane and not scalar.cursor.per_lane
    with pytest.raises(ValueError, match="scalar stream clock"):
        lanes.ingest(np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="scalar stream clock"):
        lanes.ingest_stream([np.ones((2, 3), np.float32)])
    wrapped = lanes.cursor._replace(t_offset=torch.full(
        (3,), 2 ** 31 - 1, dtype=torch.int32)).advance_lanes([1, 0, 1])
    assert wrapped.t_offset.tolist() == [-2 ** 31, 2 ** 31 - 1, -2 ** 31]
    with pytest.raises(ValueError, match="shrink"):
        lanes.grow_groups(2)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_per_lane_state_carries_across_both_ways(pair):
    from repro.api import QuantileFleet as JQuantileFleet
    from repro.api import StreamCursor as JStreamCursor
    from repro.core.sketch import GroupedQuantileSketch as JSketch

    jprog, tprog = pair
    jfl, _ = fleet_pair(jprog, tprog)
    rounds = event_rounds(jfl.num_lanes, 6, 7)
    for lanes, vals, _ in rounds[:3]:
        jfl = jfl.tick_lanes_sparse(lanes, vals)
    packed = {k: None if v is None else np.asarray(v)
              for k, v in jfl.state.packed()._asdict().items()}
    cursor = tuple(np.asarray(x) for x in jfl.cursor)
    tfl = from_jax_state(FleetSpec(num_groups=G, quantiles=QS,
                                   program=tprog), type("P", (), packed),
                         cursor, device="cpu")
    assert tfl.cursor.per_lane
    assert_fleets_same(jfl, tfl, "carried in")
    for lanes, vals, _ in rounds[3:]:
        jfl = jfl.tick_lanes_sparse(lanes, vals)
        tfl = tfl.tick_lanes_sparse(lanes, vals, donate=True)
    assert_fleets_same(jfl, tfl, "continued")

    out, cur = tfl.to_numpy_state()
    assert isinstance(cur.t_offset, np.ndarray)
    back = JQuantileFleet(
        state=JSketch.from_packed(out, drift=jfl.spec.drift),
        cursor=JStreamCursor.create(seed=cur.seed, t_offset=cur.t_offset,
                                    g_offset=cur.g_offset), spec=jfl.spec)
    assert_fleets_same(back, tfl, "carried out")
    for lanes, vals, _ in rounds[:2]:
        back = back.tick_lanes_sparse(lanes, vals)
        tfl = tfl.tick_lanes_sparse(lanes, vals)
    assert_fleets_same(back, tfl, "continued after carrying out")


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_sparse.py)")
    return torch.device("cuda")


def to_card(dev, planes, ticks, quantile):
    return (tuple(torch.from_numpy(p).to(dev) for p in planes),
            torch.from_numpy(ticks).to(dev),
            torch.as_tensor(quantile).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", [32, 128, 1024])
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_scatter_matches_plain_version(card, prog, block_k):
    planes, ticks, quantile, rounds = golden.sparse_case(prog, 70001, 4096,
                                                         4, 11)
    kp, kt, q = to_card(card, planes, ticks, quantile)
    rp, rt, _ = to_card(card, planes, ticks, quantile)
    before = tkernel.scatter_launch_count
    for lanes, items, mask in rounds:
        ev = [torch.from_numpy(x).to(card) for x in (lanes, items, mask)]
        ptrs = [p.data_ptr() for p in kp] + [kt.data_ptr()]
        kp, kt = tops.frugal_update_sparse(*ev, kp, kt, q, 99, program=prog,
                                           g_offset=G_OFFSET, donate=True,
                                           block_k=block_k)
        assert [p.data_ptr() for p in kp] + [kt.data_ptr()] == ptrs
        rp, rt = tkernel.frugal_program_scatter_reference(
            prog, *ev, rp, rt, q, 99, g_offset=G_OFFSET)
    torch.cuda.synchronize()
    assert tkernel.scatter_launch_count - before == len(rounds)
    assert_bits_equal(kp + (kt,), rp + (rt,), prog.family)


@pytest.mark.cuda
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_many_pads_on_one_lane(card, prog):
    """Half the slots of a round are pads on one lane with no event (a
    benign race: every pad stores the same bytes), at -0.0 heads too."""
    planes, ticks, quantile, rounds = golden.sparse_case(prog, 5000, 2048,
                                                         1, 12)
    planes[0][:] = -0.0
    lanes, items, mask = rounds[0]
    pad_lane = int(np.setdiff1d(np.arange(5000), lanes)[0])
    lanes = np.concatenate([lanes[mask == 1][:1024],
                            np.full(1024, pad_lane, np.int32)])
    items = np.concatenate([items[mask == 1][:1024],
                            np.full(1024, np.nan, np.float32)])
    mask = np.concatenate([np.ones(1024, np.int32),
                           np.zeros(1024, np.int32)])
    kp, kt, q = to_card(card, planes, ticks, quantile)
    rp, rt, _ = to_card(card, planes, ticks, quantile)
    ev = [torch.from_numpy(x).to(card) for x in (lanes, items, mask)]
    for _ in range(3):
        kp, kt = tops.frugal_update_sparse(*ev, kp, kt, q, 5, program=prog,
                                           donate=True)
        rp, rt = tkernel.frugal_program_scatter_reference(prog, *ev, rp, rt,
                                                          q, 5)
    torch.cuda.synchronize()
    assert_bits_equal(kp + (kt,), rp + (rt,), prog.family)


@pytest.mark.cuda
def test_card_scatter_matches_golden_file(card, golden_file):
    dev = card
    for prog in PROGS:
        ps, tk = golden.sparse_start(golden_file, prog,
                                     lambda x: torch.from_numpy(x).to(dev))
        for lanes, items, mask in golden.sparse_rounds(
                golden_file, lambda x: torch.from_numpy(x).to(dev)):
            ps, tk = tkernel.frugal_program_scatter(
                prog, lanes, items, mask, ps, tk,
                torch.from_numpy(golden_file["sparse/quantile"]).to(dev),
                golden.COUNTER_SEED, g_offset=golden.SPARSE_G_OFFSET)
        assert_bits_equal(ps + (tk,), golden.sparse_final(golden_file, prog),
                          prog.family)


@pytest.mark.cuda
@pytest.mark.parametrize("block_k", [32, 1024])
@pytest.mark.parametrize("masked", [True, False], ids=MASKS)
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_run_batch_matches_plain_version(card, prog, masked, block_k):
    """A batch of runs at 65,535 lanes (longest run several hundred), in
    one launch, in place, bit-identical to the plain version's rounds."""
    planes, ticks, quantile, (lanes, items, mask), _ = golden.run_case(
        prog, 65535, 4096, 13)
    assert golden.run_lengths(lanes).max() >= 256
    if masked:
        items = np.where(mask == 0, np.float32(123.0), items)
    else:
        mask = None
    ev = [None if x is None else torch.from_numpy(x).to(card)
          for x in (lanes, items, mask)]
    kp, kt, q = to_card(card, planes, ticks, quantile)
    rp, rt, _ = to_card(card, planes, ticks, quantile)
    ptrs = [p.data_ptr() for p in kp] + [kt.data_ptr()]
    before = tkernel.scatter_launch_count
    kp, kt = tops.frugal_update_sparse(*ev, kp, kt, q, 17, program=prog,
                                       g_offset=G_OFFSET, donate=True,
                                       block_k=block_k)
    assert tkernel.scatter_launch_count - before == 1
    rp, rt = tkernel.frugal_program_scatter_reference(
        prog, *ev, rp, rt, q, 17, g_offset=G_OFFSET)
    torch.cuda.synchronize()
    assert [p.data_ptr() for p in kp] + [kt.data_ptr()] == ptrs
    assert_bits_equal(kp + (kt,), rp + (rt,), prog.family)


@pytest.mark.cuda
def test_card_run_batch_matches_golden_file(card, golden_file):
    def conv(x):
        return torch.from_numpy(x).to(card)

    for prog in PROGS:
        ps, tk = golden.runs_start(golden_file, prog, conv)
        ps, tk = tkernel.frugal_program_scatter(
            prog, *golden.runs_batch(golden_file, conv), ps, tk,
            conv(golden_file["sparse/quantile"]), golden.COUNTER_SEED,
            g_offset=golden.SPARSE_G_OFFSET)
        assert_bits_equal(ps + (tk,), golden.runs_final(golden_file, prog),
                          prog.family)


@pytest.mark.cuda
@pytest.mark.parametrize("windowed", [False, True], ids=["2u", "2u-decay"])
def test_card_slo_fleet_matches_cpu_fleet(card, windowed):
    """An SLOFleet of 10^4 routes x 3 metrics (the sparse branch): one run
    kernel launch per flush, and the same planes and clocks as on the
    CPU."""
    from repro_torch.serve import DEFAULT_METRICS, SLOFleet

    metrics = [m for m, _ in DEFAULT_METRICS]
    rng = np.random.default_rng(4)
    names = [f"r{i}" for i in range(10 ** 4)]
    fleets = [SLOFleet(seed=2, capacity=64, windowed=windowed,
                       decay_half_life=64, device=d) for d in (card, "cpu")]
    for fl in fleets:
        fl.ensure_routes(names)
    before = tkernel.scatter_launch_count
    for _ in range(4):
        routes = (rng.zipf(1.2, 4096) - 1) % len(names)
        ms = rng.integers(0, len(metrics), 4096)
        vals = rng.lognormal(3.0, 1.0, 4096)
        vals[rng.random(4096) < 0.02] = np.nan
        for fl in fleets:
            for r, m, v in zip(routes, ms, vals):
                fl.observe(names[r], metrics[m], float(v))
            fl.flush()
    assert tkernel.scatter_launch_count - before == 4
    for name in ("_m", "_step", "_sign", "_ticks"):
        np.testing.assert_array_equal(bits(getattr(fleets[0], name)),
                                      bits(getattr(fleets[1], name)),
                                      err_msg=name)


@pytest.mark.cuda
def test_card_fleet_event_rounds_match_cpu_fleet(card):
    spec = FleetSpec(num_groups=3000, quantiles=(0.5, 0.9, 0.99),
                     program=tprogram.make_program("2u-window", window=96))
    cpu = QuantileFleet.create(spec, seed=3, per_lane_clock=True,
                               device="cpu")
    dev = QuantileFleet.create(spec, seed=3, per_lane_clock=True,
                               device=card)
    before = tkernel.scatter_launch_count
    for lanes, vals, _ in event_rounds(spec.num_lanes, 5, 8):
        cpu = cpu.tick_lanes_sparse(lanes, vals, donate=True)
        dev = dev.tick_lanes_sparse(lanes, vals, donate=True)
    assert tkernel.scatter_launch_count - before == 5
    np.testing.assert_array_equal(bits(cpu.estimate()),
                                  bits(dev.estimate()))
    assert torch.equal(cpu.cursor.t_offset, dev.cursor.t_offset.cpu())
