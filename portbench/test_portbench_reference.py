"""The benchmark's plain reference, traffic generator and frozen roofline,
held against the system's CPU path at small sizes."""
import numpy as np
import pytest
import torch

from portbench import reference, roofline, traffic
from repro_torch.api import FleetSpec, QuantileFleet
from repro_torch.core import packing, rng

PROGRAMS = {"1u": (0.5,), "2u": (0.5, 0.9, 0.99)}


@pytest.mark.parametrize("seed", [0, -7, 2 ** 31 - 1, -2 ** 31])
def test_uniform_equals_the_systems_counter_hash(seed):
    gen = np.random.default_rng(abs(seed) + 1)
    ticks = torch.from_numpy(gen.integers(-2 ** 31, 2 ** 31, 64))
    lanes = torch.from_numpy(gen.integers(0, 2 ** 31, 64))
    got = reference.uniform(reference.tick_hash(seed, ticks),
                            reference.lane_key(lanes))
    want = rng.counter_uniform(seed, ticks.to(torch.int32),
                               lanes.to(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    got_t = reference.uniform(reference.tick_hash(seed, 12345),
                              reference.lane_key(lanes))
    want_t = rng.counter_uniform(seed, 12345, lanes.to(torch.int32))
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))


def test_canonical_step_equals_the_two_word_round_trip():
    prog = reference.load_program("2u")
    step = torch.tensor([0.0, -0.0, 1.0, -3.5, 2.0 ** -70, -2.0 ** -64,
                         2.0 ** -63, float("nan"), float("inf"), -1e20,
                         4294967296.0, 7.25], dtype=torch.float32)
    sign = torch.tensor([1.0, -1.0] * 6, dtype=torch.float32)
    m = torch.zeros_like(step)
    _, got_step, got_sign = prog.canonical((m, step, sign))
    want_step, want_sign = packing.unpack_step_sign(
        packing.pack_step_sign(step, sign))
    assert torch.equal(got_step.view(torch.int32), want_step.view(torch.int32))
    assert torch.equal(got_sign, want_sign)


def _dense_items(groups, rows, seed, x0=3.0, gamma=2.0):
    gen = torch.Generator().manual_seed(seed)
    mix = {"rows": rows, "ring": 3,
           "value": {"dist": "cauchy", "x0": x0, "gamma": gamma}}
    return traffic.dense_ring(mix, groups, gen, torch.device("cpu"))


def test_dense_items_are_the_seeds_cauchy_stream():
    ring = _dense_items(1000, 64, 77, x0=10000.0, gamma=1250.0)
    again = _dense_items(1000, 64, 77, x0=10000.0, gamma=1250.0)
    assert all(torch.equal(a, b) for a, b in zip(ring, again))
    assert not torch.equal(ring[0], _dense_items(1000, 64, 78)[0])
    x = torch.cat(ring).reshape(-1)
    assert x.dtype == torch.float32 and bool(x.isfinite().all())
    q1, q2, q3 = torch.quantile(x.double(), torch.tensor(
        [0.25, 0.5, 0.75], dtype=torch.float64))
    # Cauchy(x0, gamma): median x0, quartiles x0 -/+ gamma
    assert abs(q2 - 10000.0) < 20.0
    assert abs(q3 - q1 - 2500.0) < 50.0


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_dense_reference_equals_the_fleet(program):
    """Three 8-row calls from the paper's start, each against the
    reference over all lanes from the fleet's state before it."""
    qs, groups, rows, seed = PROGRAMS[program], 29, 8, 1234567
    prog = reference.load_program(program)
    spec = FleetSpec(num_groups=groups, quantiles=qs, program=program)
    fleet = QuantileFleet.create(spec, seed=seed, device="cpu")
    planes = prog.init(torch.empty(groups * len(qs)), 0.0)
    for n, block in enumerate(_dense_items(groups, rows, 5)):
        fleet = fleet.ingest_stream((block,), chunk_t=rows)
        planes = reference.dense(prog, planes, block, n * rows, seed, qs)
        got = tuple(getattr(fleet.state, f) for f in prog.PLANES)
        assert reference.lanes_differ(got, planes) == 0
    est = fleet.estimate().reshape(-1)
    assert reference.lanes_differ((est,), (prog.query(planes),)) == 0
    low = reference.dense(prog, planes, block, 3 * rows, seed, qs,
                          dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in low)


def test_frozen_roofline_at_the_dense_cells():
    two, one = reference.load_program("2u"), reference.load_program("1u")
    g = 2 ** 22
    # 44 issue slots a 2U lane-tick: the 8.4733 ms the system published
    assert roofline.dense_call_s(two, 512, g, 3) == pytest.approx(8.4733e-3,
                                                                 rel=1e-4)
    # 1U is bound by its bytes: items, targets, one word in and out
    nbytes = 512 * g * 4 + g * 4 + 2 * g * 4
    assert roofline.dense_call_s(one, 512, g, 1) == pytest.approx(
        nbytes / 3.35e12)
