"""The port's fault plans and lane health against the JAX package.

* CPU: kill-anywhere resume for all six lane programs (the same seeded
  kill points as the JAX package's plans; the JAX fleets on their jnp
  path, never a Pallas interpret kernel), a bit flip caught and healed
  under each health policy, the invariant masks of crafted planes
  (unpackable, NaN and -0.0 steps, out-of-domain signs), the SLO fleet's
  quarantine counters, the registry lint, and the hooks' no-op rule.
* Card (marker ``cuda``, skipped without a CUDA device): kill and resume,
  and flip and quarantine, through the dense kernel, against the same run
  on the CPU.

Tolerance everywhere: bit-exact (float32 compared as int32 bit patterns).
JAX is imported inside the CPU tests: the card tests run where JAX is not
installed (``--noconftest``, see README.md).
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from repro_torch.api import FleetSpec, QuantileFleet, StreamCursor
from repro_torch.core import program as tprogram
from repro_torch.resilience import (CheckpointKilled, Fault, FaultPlan,
                                    LaneCorruptionError, StreamInterrupted,
                                    chaos, health)
from repro_torch.serve import SLOFleet

PROGS = tprogram.test_instances()
IDS = [p.family for p in PROGS]
PAIR_PROGS = [p for p in PROGS if p.algo == "2u"]
G, QS, T, CHUNK, SEED = 4, (0.5, 0.9), 200, 32, 3
N_CHUNKS = -(-T // CHUNK)


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def data(seed=4):
    return np.random.default_rng(seed).normal(5.0, 2.0, (T, G)).astype(
        np.float32)


def blocks(items):
    # Ragged: a kill lands on a re-chunked boundary, not a source block's.
    return [items[0:37], items[37:81], items[81:]]


def jax_program(family):
    from repro.core import program

    return {p.family: p for p in program.test_instances()}[family]


def jax_spec(family, **kw):
    from repro.api import FleetSpec as JFleetSpec

    return JFleetSpec(num_groups=G, quantiles=QS, backend="jnp",
                      chunk_t=CHUNK, program=jax_program(family), **kw)


def tspec(prog, **kw):
    return FleetSpec(num_groups=G, quantiles=QS, chunk_t=CHUNK, program=prog,
                     **kw)


def planes_of(fleet):
    """A fleet's planes as numpy arrays, from either package."""
    sk = fleet.state if isinstance(fleet, QuantileFleet) \
        else fleet._lane_sketch()
    return [bits(p) for p in sk.planes()]


def assert_same(a, b, what=""):
    """Two fleets (either package) hold the same planes and cursor."""
    for i, (x, y) in enumerate(zip(planes_of(a), planes_of(b))):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: plane {i}")
    assert int(a.cursor.t_offset) == int(b.cursor.t_offset), what
    assert int(a.cursor.seed) == int(b.cursor.seed), what


def kill_and_resume(create, plan, items):
    fleet = create()
    with plan_armed(plan):
        with pytest.raises(Exception) as ei:
            fleet.ingest_stream(iter(blocks(items)))
    err = ei.value
    resumed = err.fleet.ingest_stream(iter(blocks(items)),
                                      skip_items=err.items_applied)
    return err, resumed


def plan_armed(plan):
    """Arm ``plan`` in the package it belongs to."""
    if isinstance(plan, FaultPlan):
        return chaos.armed(plan)
    from repro.resilience import chaos as jchaos

    return jchaos.armed(plan)


# --------------------------------------------------------------- kill matrix
@pytest.mark.parametrize("chaos_seed", [0, 1])
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_kill_anywhere_resume_matches_jax(prog, chaos_seed):
    """The JAX package's kill matrix: a seeded kill at a chunk boundary,
    then a resume with skip_items. The port's plan draws the same kill
    point; both packages stop at the same item and end bit-identical to
    each other and to the uninterrupted run."""
    from repro.api import QuantileFleet as JQuantileFleet
    from repro.resilience import FaultPlan as JFaultPlan

    plan_seed = chaos_seed * 1009 + zlib.crc32(prog.family.encode()) % 997
    tplan = FaultPlan.seeded_kill(plan_seed, N_CHUNKS)
    jplan = JFaultPlan.seeded_kill(plan_seed, N_CHUNKS)
    assert dataclasses.astuple(tplan.faults[0]) == \
        dataclasses.astuple(jplan.faults[0])
    kill_after = tplan.faults[0].at
    items = data()

    terr, tres = kill_and_resume(
        lambda: QuantileFleet.create(tspec(prog), seed=SEED, device="cpu"),
        tplan, items)
    jerr, jres = kill_and_resume(
        lambda: JQuantileFleet.create(jax_spec(prog.family), seed=SEED),
        jplan, items)
    assert isinstance(terr, StreamInterrupted)
    assert terr.items_applied == jerr.items_applied \
        == min(kill_after * CHUNK, T)
    assert terr.fleet.cursor.t_offset == terr.items_applied
    assert_same(terr.fleet, jerr.fleet, f"{prog.family} at the kill")
    assert_same(tres, jres, f"{prog.family} resumed")
    whole = QuantileFleet.create(tspec(prog), seed=SEED,
                                 device="cpu").ingest_stream(blocks(items))
    assert_same(tres, whole, f"{prog.family} vs uninterrupted")
    np.testing.assert_array_equal(bits(tres.estimate()),
                                  bits(jres.estimate()))


def test_seeded_plans_draw_as_jax():
    from repro.resilience import FaultPlan as JFaultPlan

    for seed in range(40):
        for n in (1, 7, 10):
            for make in ("seeded_kill", "seeded_query_stall"):
                a = getattr(FaultPlan, make)(seed, n)
                b = getattr(JFaultPlan, make)(seed, n)
                assert [dataclasses.astuple(f) for f in a.faults] == \
                    [dataclasses.astuple(f) for f in b.faults]
                assert 1 <= a.faults[0].at <= n and a.seed == seed


def test_source_exception_discards_staged_partial():
    items = data()
    spec = tspec("2u")

    def dying():
        yield items[:40]                 # 32 applied + 8 staged
        raise OSError("socket reset")

    with pytest.raises(StreamInterrupted) as ei:
        QuantileFleet.create(spec, seed=SEED,
                             device="cpu").ingest_stream(dying())
    assert ei.value.items_applied == CHUNK
    resumed = ei.value.fleet.ingest_stream(blocks(items),
                                           skip_items=CHUNK)
    whole = QuantileFleet.create(spec, seed=SEED,
                                 device="cpu").ingest_stream(blocks(items))
    assert_same(resumed, whole)


# ---------------------------------------------------------- self-healing lanes
def flip_plan(plane=2, lane=3, bit=22, at=70):
    return [Fault(kind="flip", at=at, plane=plane, lane=lane, bit=bit)]


@pytest.mark.parametrize("prog", PAIR_PROGS, ids=[p.family for p in
                                                  PAIR_PROGS])
def test_bitflip_quarantine_matches_jax(prog):
    """A flip of sign-plane bit 22 (±1.0 -> ±1.5) in the last chunk before
    the scan: both packages flag the same lane, quarantine heals it, and
    both continue bit-identically. The healed lane equals a lane created
    at the cursor; every other lane equals the uninterrupted run."""
    from repro.api import QuantileFleet as JQuantileFleet
    from repro.resilience import Fault as JFault
    from repro.resilience import FaultPlan as JFaultPlan

    items, t1 = data(), 96
    spec = tspec(prog, health="quarantine")
    tplan = FaultPlan(faults=flip_plan())
    jplan = JFaultPlan(faults=[JFault(**dataclasses.asdict(f))
                               for f in flip_plan()])
    fleet = QuantileFleet.create(spec, seed=SEED, device="cpu")
    with chaos.armed(tplan):
        fleet = fleet.ingest_stream([items[:t1]])
    jfleet = JQuantileFleet.create(jax_spec(prog.family,
                                            health="quarantine"), seed=SEED)
    with plan_armed(jplan):
        jfleet = jfleet.ingest_stream([items[:t1]])
    assert tplan.fired() == jplan.fired() == 1
    assert_same(fleet, jfleet, "flipped")
    rep, jrep = fleet.health(), jfleet.health()
    assert rep.lane_ids == jrep.lane_ids == (3,)
    assert str(rep) == str(jrep)

    fleet, rep = fleet.check_health()
    jfleet, jrep = jfleet.check_health()
    assert dataclasses.astuple(rep) == dataclasses.astuple(jrep)
    assert rep.quarantined == 1
    assert fleet.health().healthy
    assert_same(fleet, jfleet, "healed")
    fleet = fleet.ingest_stream([items[t1:]])
    assert_same(fleet, jfleet.ingest_stream([items[t1:]]), "continued")

    fresh = QuantileFleet.create(
        spec, seed=SEED, device="cpu",
        cursor=StreamCursor.create(seed=SEED, t_offset=t1)
    ).ingest_stream([items[t1:]])
    whole = QuantileFleet.create(spec, seed=SEED,
                                 device="cpu").ingest_stream([items])
    keep = np.arange(spec.num_lanes) != 3
    for p, f, w in zip(planes_of(fleet), planes_of(fresh),
                       planes_of(whole)):
        assert p[3] == f[3]
        np.testing.assert_array_equal(p[keep], w[keep])


@pytest.mark.parametrize("bit", [0, 22, 30, 31])
@pytest.mark.parametrize("plane", [0, 1, 2])
def test_flip_bits_match_jax(plane, bit):
    """Every bit of every 2u plane flips as the JAX package flips it (bit
    31 is the int32 -2**31), in a clone of the plane."""
    from repro.api import QuantileFleet as JQuantileFleet
    from repro.resilience import Fault as JFault
    from repro.resilience import FaultPlan as JFaultPlan

    items = data()[:CHUNK]
    fault = dict(kind="flip", at=5, plane=plane, lane=6, bit=bit)
    src = QuantileFleet.create(tspec("2u", health="ignore"), seed=SEED,
                               device="cpu").ingest(items)
    jsrc = JQuantileFleet.create(jax_spec("2u", health="ignore"),
                                 seed=SEED).ingest(items)
    kept = planes_of(src)
    with chaos.armed(FaultPlan(faults=[Fault(**fault)])):
        sk = chaos.corrupt_sketch(src.state, 0, CHUNK)
    with plan_armed(JFaultPlan(faults=[JFault(**fault)])):
        from repro.resilience import chaos as jchaos
        jsk = jchaos.corrupt_sketch(jsrc._lane_sketch(), 0, CHUNK)
    for i, (a, b) in enumerate(zip(sk.planes(), jsk.planes())):
        np.testing.assert_array_equal(bits(a), bits(b))
        want = kept[i].copy()
        if i == plane:
            want[6] ^= np.int32(np.uint32(1 << bit).view(np.int32))
        np.testing.assert_array_equal(bits(a), want)
    for a, b in zip(kept, planes_of(src)):
        np.testing.assert_array_equal(a, b)


def corrupted(fleet, plane, lane, value):
    planes = [p.clone() for p in fleet.state.planes()]
    planes[plane][lane] = value
    return dataclasses.replace(fleet, state=fleet.state.with_planes(planes))


def test_health_policy_raise():
    fleet = QuantileFleet.create(FleetSpec(num_groups=G, health="raise"),
                                 seed=0, device="cpu").ingest(data())
    bad = corrupted(fleet, plane=2, lane=1, value=-1.5)
    with pytest.raises(LaneCorruptionError, match="1/4 lanes"):
        bad.check_health()
    assert bad.health().corrupt_lanes == 1     # the scan never raises


def test_health_policy_ignore_reports_without_mutating():
    fleet = QuantileFleet.create(FleetSpec(num_groups=G, health="ignore"),
                                 seed=0, device="cpu").ingest(data())
    bad = corrupted(fleet, plane=0, lane=2, value=float("nan"))
    out, rep = bad.check_health()
    assert out is bad
    assert rep.corrupt_lanes == 1 and rep.quarantined == 0


def test_healthy_fleet_check_is_identity():
    fleet = QuantileFleet.create(
        FleetSpec(num_groups=G, health="quarantine"), seed=0,
        device="cpu").ingest(data())
    out, rep = fleet.check_health()
    assert out is fleet and rep.healthy and rep.quarantined == 0


def test_fleet_spec_health_policy():
    assert FleetSpec(num_groups=4).health == "raise"
    assert health.HEALTH_POLICIES == ("raise", "quarantine", "ignore")
    with pytest.raises(ValueError, match="health"):
        FleetSpec(num_groups=4, health="retry-forever")


SPECIALS = (0.0, -0.0, 1.0, -1.0, 1.5, -1.5, 3.0, -7.25, 1e38, -1e38,
            2.0 ** 32, 2.0 ** 31, 2.0 ** -70, np.inf, -np.inf, np.nan, 5.0)


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_invariant_masks_match_jax(prog):
    """Every plane of every program takes each special value at its own
    lane (unpackable steps above the 2^32 clip or below 2^-63, NaN and
    infinite values, -0.0 steps, out-of-domain signs): the port's mask is
    the JAX package's, and heal_planes writes the same fresh state."""
    import jax.numpy as jnp
    from repro.resilience import health as jhealth

    layout = prog.layout
    n = len(SPECIALS) * len(layout.plane_fields)
    base = {f: (0.25 if f in layout.heads else 1.0)
            for f in layout.plane_fields}
    planes = [np.full(n, base[f], np.float32) for f in layout.plane_fields]
    for i in range(len(layout.plane_fields)):
        for j, v in enumerate(SPECIALS):
            planes[i][i * len(SPECIALS) + j] = v
    planes[1 % len(planes)][-1] = -0.0                 # -0.0 passes
    tp = tuple(torch.from_numpy(p.copy()) for p in planes)
    jp = tuple(jnp.asarray(p) for p in planes)
    mask = health.validate_planes(prog, tp)
    jmask = np.asarray(jhealth.validate_planes(jax_program(prog.family), jp))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert jmask.any() and not jmask.all()
    healed = health.heal_planes(prog, tp, mask)
    jhealed = jhealth.heal_planes(jax_program(prog.family), jp, jmask)
    for a, b in zip(healed, jhealed):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert not health.validate_planes(prog, healed).any()
    for a, p in zip(tp, planes):                       # inputs untouched
        np.testing.assert_array_equal(bits(a), bits(p))
    rep = health.report_for(prog, tp, "ignore")
    jrep = jhealth.report_for(jax_program(prog.family), jp, "ignore")
    assert dataclasses.astuple(rep) == dataclasses.astuple(jrep)


def test_unpackable_step_flagged():
    """A finite step the packed word cannot hold (1e38, beyond the 2^32
    clip) flags through the round trip, as in the JAX package."""
    fleet = QuantileFleet.create(FleetSpec(num_groups=G, health="ignore"),
                                 seed=0, device="cpu").ingest(data())
    assert fleet.health().healthy
    assert corrupted(fleet, plane=1, lane=0, value=1e38).health().lane_ids \
        == (0,)
    assert corrupted(fleet, plane=1, lane=2, value=-0.0).health().healthy


def test_slo_fleet_quarantine_matches_jax():
    from repro.serve import SLOFleet as JSLOFleet

    class Counter:
        def __init__(self):
            self.counts = {}

        def count(self, name, n=1):
            self.counts[name] = self.counts.get(name, 0) + n

    tel = Counter()
    fl = SLOFleet(seed=1, capacity=4, telemetry=tel, device="cpu")
    jfl = JSLOFleet(seed=1, capacity=4)
    assert fl.health_policy == jfl.health_policy == "quarantine"
    for f in (fl, jfl):
        for i in range(40):
            f.observe("api", "ttft_q99_ms", 100.0 + i)
            f.observe("api", "tok_q50_ms", 10.0 + 0.1 * i)
        assert f.check_health().healthy and f.quarantined_total == 0
    fl._fleet = corrupted(fl._fleet, plane=2, lane=0, value=5.0)
    sk = jfl._fleet._lane_sketch()
    planes = [np.asarray(p).copy() for p in sk.planes()]
    planes[2][0] = 5.0
    import jax.numpy as jnp
    jfl._fleet = dataclasses.replace(jfl._fleet, state=sk.with_planes(
        tuple(jnp.asarray(p) for p in planes)))
    rep, jrep = fl.check_health(), jfl.check_health()
    assert dataclasses.astuple(rep) == dataclasses.astuple(jrep)
    assert rep.quarantined == 1
    assert fl.quarantined_total == jfl.quarantined_total == 1
    assert fl.last_health is rep
    assert tel.counts["quarantined_lanes"] == 1
    for f in (fl, jfl):
        f.observe("api", "ttft_q99_ms", 170.0)
    assert fl.summaries() == jfl.summaries()
    for name in ("_m", "_step", "_sign", "_ticks"):
        np.testing.assert_array_equal(bits(getattr(fl, name)),
                                      bits(getattr(jfl, name)))
    assert fl.check_health().healthy


def test_slo_fleet_raise_policy():
    fl = SLOFleet(seed=1, capacity=4, health_policy="raise", device="cpu")
    fl.observe("api", "len_q50", 3.0)
    fl._fleet = corrupted(fl._fleet, plane=0, lane=0, value=float("inf"))
    with pytest.raises(LaneCorruptionError):
        fl.check_health()


# ------------------------------------------------------------ registry lint
def test_validate_registry_covers_the_families():
    from repro.core import program as jprogram

    assert tprogram.validate_registry() == jprogram.validate_registry() \
        == tprogram.registered_families()
    for tp, jp in zip(PROGS, jprogram.test_instances()):
        assert tp.layout.invariants == jp.layout.invariants
        tprogram.validate_program(tp)


@pytest.mark.parametrize("invariants, match", [
    ((("m", "finite"), ("zz", "finite")), "unknown plane field"),
    ((("m", "positive"),), "not one of"),
    ((("m", "finite"), ("m", "finite")), "duplicate"),
])
def test_state_layout_refuses_bad_invariants(invariants, match):
    with pytest.raises(ValueError, match=match):
        tprogram.StateLayout(plane_fields=("m",), packing=(("m", None),),
                             invariants=invariants)


def test_validate_program_refuses_missing_or_wrong_invariants():
    two = tprogram.make_program("2u")
    no_sign = dataclasses.replace(two, layout=dataclasses.replace(
        two.layout, invariants=(("m", "finite"), ("step", "step"))))
    with pytest.raises(AssertionError, match="sign"):
        tprogram.validate_program(no_sign)
    bad_head = dataclasses.replace(two, layout=dataclasses.replace(
        two.layout, invariants=(("m", "step"), ("step", "step"),
                                ("sign", "sign"))))
    with pytest.raises(AssertionError, match="finite"):
        tprogram.validate_program(bad_head)


# --------------------------------------------------------------------- hooks
def test_hooks_are_noops_when_disarmed(tmp_path):
    assert chaos.active() is None
    chaos.count_event("ingest")
    chaos.on_query_event("query")
    chaos.on_checkpoint_phase("after_leaves")
    chaos.on_checkpoint_committed(str(tmp_path))
    chaos.on_restore_shard(str(tmp_path / "x.npz"))
    sk = QuantileFleet.create(tspec("2u"), device="cpu").state
    assert chaos.corrupt_sketch(sk, 0, 10**6) is sk


def test_armed_restores_previous_plan_and_fires_once():
    outer = FaultPlan.stream_kill(2)
    inner = FaultPlan(faults=[Fault(kind="ckpt_kill", phase="before_marker")])
    with chaos.armed(outer):
        with chaos.armed(inner):
            assert chaos.active() is inner
            chaos.on_checkpoint_phase("after_leaves")
            with pytest.raises(CheckpointKilled):
                chaos.on_checkpoint_phase("before_marker")
            chaos.on_checkpoint_phase("before_marker")    # fired once
        assert chaos.active() is outer
        chaos.count_event()
        with pytest.raises(chaos.StreamFault, match="event 2"):
            chaos.count_event()
    assert chaos.active() is None
    stall = FaultPlan.query_stall(2)
    with chaos.armed(stall):
        chaos.on_query_event()
        with pytest.raises(chaos.QueryStalled):
            chaos.on_query_event()
        chaos.count_event("query")    # the stream counter is its own
    assert stall.fired() == 1


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_resilience.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_kill_resume_matches_cpu(card, prog):
    """Kill and resume through the dense kernel: bit-identical to the same
    kill and resume on the CPU."""
    plan_seed = zlib.crc32(prog.family.encode()) % 997
    items = data()
    out = []
    for dev in (card, "cpu"):
        err, resumed = kill_and_resume(
            lambda: QuantileFleet.create(tspec(prog), seed=SEED, device=dev),
            FaultPlan.seeded_kill(plan_seed, N_CHUNKS), items)
        assert isinstance(err, StreamInterrupted)
        out.append(resumed)
    assert out[0].device.type == "cuda"
    assert_same(out[0], out[1], prog.family)


@pytest.mark.cuda
def test_card_flip_quarantine_matches_cpu(card):
    items, t1 = data(), 96
    spec = tspec("2u", health="quarantine")
    out = []
    for dev in (card, "cpu"):
        fleet = QuantileFleet.create(spec, seed=SEED, device=dev)
        with chaos.armed(FaultPlan(faults=flip_plan())):
            fleet = fleet.ingest_stream([items[:t1]])
        assert fleet.health().lane_ids == (3,)
        fleet, rep = fleet.check_health()
        assert rep.quarantined == 1
        out.append(fleet.ingest_stream([items[t1:]]))
    assert_same(out[0], out[1])
