"""The port's streaming service against the JAX package.

* CPU: ``StreamingService`` answers (trusted and DP tenant reads) at
  every chunk boundary for ``2u``, ``2u-decay``, ``2u-window`` and
  ``2u-dp`` equal to the JAX service's on its ``jnp`` and ``fused``
  backends; threaded queries under background ingest equal to a JAX
  replay at their cursors; a snapshot that survives donated sparse
  rounds; a query stall that leaves ingest unperturbed and a retry that
  answers exactly; tenant gating; a ``2u-dp`` fleet not noised twice;
  the ingest pipeline's counters, gauge and histogram; telemetry
  counters under threads and the latency histogram equal to the JAX
  ``Telemetry``; ``SLOFleet.snapshot()`` equal to the JAX one;
  ``runtime_metadata``; construction and ``join`` errors; and the
  service and telemetry goldens of ``tests/data/torch_port_golden.npz``
  (the plain path on the CPU).
* Card (marker ``cuda``, skipped without a CUDA device): the service on
  the card (staging on a side stream, the dense kernel, the telemetry
  fleet) equal to the service on the CPU, synchronously and with a
  reader thread, and the goldens on the card.

Tolerance everywhere: bit-exact (float32 compared as int32 bit
patterns). Every thread join and queue wait takes a timeout. JAX is
imported inside the tests that use it: the card tests run where JAX is
not installed (``--noconftest``).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import FleetSpec, QuantileFleet
from repro_torch.core.program import make_program
from repro_torch.kernels import frugal_update as tkernel
from repro_torch.resilience import FaultPlan, QueryStalled, chaos
from repro_torch.serve import SLOFleet
from repro_torch.service import (IngestPipeline, Snapshot, StreamingService,
                                 Telemetry, TenantPolicy, runtime_metadata)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

G, CHUNK_T, N_CHUNKS = 8, 16, 6
PROGRAMS = {"2u": {}, "2u-decay": {"half_life": 8},
            "2u-window": {"window": 24}, "2u-dp": {"epsilon": 0.7}}
PARTNER_EPS = 0.5
JOIN_S = 60.0            # every join and wait here is bounded


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits_equal(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def make_chunks(seed=0, n=N_CHUNKS, t=CHUNK_T, g=G):
    rng = np.random.default_rng(seed)
    return [rng.normal(3.0, 2.0, size=(t, g)).astype(np.float32)
            for _ in range(n)]


def spec(program="2u", g=G, **kw):
    return FleetSpec(num_groups=g, quantiles=(0.5, 0.9), chunk_t=CHUNK_T,
                     program=make_program(program, **PROGRAMS[program]),
                     **kw)


def jax_spec(program="2u", backend="jnp", g=G):
    from repro.api import FleetSpec as JFleetSpec
    from repro.core.program import make_program as jmake

    return JFleetSpec(num_groups=g, quantiles=(0.5, 0.9), chunk_t=CHUNK_T,
                      backend=backend,
                      program=jmake(program, **PROGRAMS[program]))


def service(program="2u", seed=0, g=G, device="cpu", **kw):
    return StreamingService(spec(program, g=g), seed=seed, device=device,
                            tenants=[TenantPolicy("partner",
                                                  epsilon=PARTNER_EPS)],
                            **kw)


def jax_service(program="2u", backend="jnp", seed=0, g=G):
    from repro.service import StreamingService as JService
    from repro.service import TenantPolicy as JTenant

    return JService(jax_spec(program, backend, g), seed=seed,
                    tenants=[JTenant("partner", epsilon=PARTNER_EPS)])


def boundary_answers(svc, chunks):
    """[(trusted, partner)] before each chunk and after the last."""
    out = []
    for c in chunks + [None]:
        out.append((svc.query(), svc.query(tenant="partner")))
        if c is not None:
            svc.ingest(c)
    return out


def jax_replay(program, seed, chunks, backend="jnp", g=G):
    """{cursor: JAX trusted answer} of a single-threaded JAX replay."""
    from repro.api import QuantileFleet as JFleet

    fleet = JFleet.create(jax_spec(program, backend, g), seed=seed)
    out = {0: fleet.estimate()}
    for c in chunks:
        fleet = fleet.ingest(c)
        out[int(fleet.cursor.t_offset)] = fleet.estimate()
    return out


# ------------------------------------------------------ snapshot consistency
@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_snapshot_at_every_boundary_matches_jax(program, backend):
    chunks = make_chunks(seed=2)
    got = boundary_answers(service(program, seed=11), chunks)
    want = boundary_answers(jax_service(program, backend, seed=11), chunks)
    for i, ((raw, dp), (jraw, jdp)) in enumerate(zip(got, want)):
        assert raw.shape == (G, 2) and dp.shape == (G, 2)
        assert_bits_equal(raw, jraw, f"trusted read at boundary {i}")
        assert_bits_equal(dp, jdp, f"partner read at boundary {i}")
    # and the port's own single-threaded replay at every cursor
    ref = QuantileFleet.create(spec(program), seed=11, device="cpu")
    for i, c in enumerate(chunks):
        ref = ref.ingest(c)
        assert_bits_equal(got[i + 1][0], Snapshot.capture(ref).estimate())


def test_threaded_queries_under_ingest_match_replay():
    chunks = make_chunks(seed=7, n=10, g=32)
    svc = service(seed=3, g=32)

    def slow():
        for c in chunks:
            time.sleep(0.002)
            yield c

    svc.start(slow())
    seen = {}
    deadline = time.monotonic() + JOIN_S
    while svc.ingest_running and time.monotonic() < deadline:
        s = svc.snapshot()
        seen[s.items_ingested] = (s.estimate(), s.estimate_dp(PARTNER_EPS))
    svc.join(timeout=JOIN_S)
    final = svc.snapshot()
    seen[final.items_ingested] = (final.estimate(),
                                  final.estimate_dp(PARTNER_EPS))
    assert final.items_ingested == 10 * CHUNK_T
    want = jax_replay("2u", 3, chunks, g=32)
    ref = QuantileFleet.create(spec(g=32), seed=3, device="cpu")
    for c in [None] + chunks:
        ref = ref if c is None else ref.ingest(c)
        cursor = int(ref.cursor.t_offset)
        if cursor in seen:
            raw, dp = seen[cursor]
            assert_bits_equal(raw, want[cursor], f"cursor {cursor}")
            assert_bits_equal(dp, Snapshot.capture(ref).estimate_dp(
                PARTNER_EPS), f"partner at cursor {cursor}")


def test_snapshot_survives_donated_sparse_rounds():
    from repro.api import FleetSpec as JFleetSpec
    from repro.api import QuantileFleet as JFleet
    from repro.service import Snapshot as JSnapshot

    rng = np.random.default_rng(0)
    first = rng.normal(size=64).astype(np.float32)
    fleet = QuantileFleet.create(FleetSpec(num_groups=64, quantiles=(0.5,)),
                                 seed=5, per_lane_clock=True, device="cpu")
    fleet = fleet.tick_lanes(first)
    jfleet = JFleet.create(JFleetSpec(num_groups=64, quantiles=(0.5,),
                                      backend="jnp"),
                           seed=5, per_lane_clock=True).tick_lanes(first)
    snap = Snapshot.capture(fleet)
    before = snap.estimate().copy()
    assert_bits_equal(before, JSnapshot.capture(jfleet).estimate())
    assert all(isinstance(p, np.ndarray) for p in snap.m_planes)
    with pytest.raises(ValueError, match="per-lane"):
        snap.items_ingested
    for _ in range(20):
        lanes = rng.choice(64, size=8, replace=False).astype(np.int32)
        vals = rng.normal(size=8).astype(np.float32)
        fleet = fleet.tick_lanes_sparse(lanes, vals, donate=True)
    assert not np.array_equal(fleet.estimate(), before)
    assert_bits_equal(snap.estimate(), before)


# ------------------------------------------------------------- chaos: stall
@pytest.mark.parametrize("chaos_seed", [0, 5])
def test_query_stall_leaves_ingest_unperturbed_and_retry_exact(chaos_seed):
    chunks = make_chunks(seed=3)
    plan = FaultPlan.seeded_query_stall(chaos_seed, N_CHUNKS + 1)
    want = jax_replay("2u", 9, chunks)
    svc = service(seed=9)
    stalled_at = []
    with chaos.armed(plan):
        for i, c in enumerate(chunks):
            try:
                svc.query()
            except QueryStalled:
                stalled_at.append(i)
                got = svc.query()               # immediate retry
                assert_bits_equal(got, want[i * CHUNK_T])
            svc.ingest(c)
    assert plan.fired() == 1 and len(stalled_at) == 1
    assert svc.stats()["counters"]["queries_stalled"] == 1
    ref = QuantileFleet.create(spec(), seed=9, device="cpu")
    for c in chunks:
        ref = ref.ingest(c)
    for a, b in zip(svc.fleet.state.planes(), ref.state.planes()):
        assert_bits_equal(a.numpy(), b.numpy())
    assert_bits_equal(svc.query(), want[N_CHUNKS * CHUNK_T])


def test_query_stall_fires_inside_threaded_service():
    svc = service(seed=1)
    svc.ingest(make_chunks(n=1)[0])
    with chaos.armed(FaultPlan.query_stall(at=1)):
        with pytest.raises(QueryStalled):
            svc.query()
        after = svc.query()
    assert_bits_equal(after, svc.query())
    assert svc.stats()["counters"]["queries_stalled"] == 1


# --------------------------------------------------------------- DP tenants
def test_tenant_gating_trusted_vs_dp_vs_unknown():
    chunks = make_chunks(seed=5, n=3)
    svc, jsvc = service(seed=4), jax_service(seed=4)
    for c in chunks:
        svc.ingest(c)
        jsvc.ingest(c)
    raw, noised = svc.query(), svc.query(tenant="partner")
    assert raw.shape == noised.shape and not np.array_equal(raw, noised)
    assert_bits_equal(raw, jsvc.query())
    assert_bits_equal(noised, jsvc.query(tenant="partner"))
    assert_bits_equal(noised, svc.query(tenant="partner"))
    assert_bits_equal(noised, svc.snapshot().estimate_dp(PARTNER_EPS))
    assert_bits_equal(svc.query(quantile=0.9), raw[:, 1])
    svc.register_tenant(TenantPolicy("auditor", trusted=True))
    assert_bits_equal(svc.query(tenant="auditor"), raw)
    with pytest.raises(KeyError):
        svc.query(tenant="nobody")
    with pytest.raises(ValueError, match="epsilon"):
        TenantPolicy("bad", epsilon=0.0)


def test_dp_program_fleet_is_not_double_noised():
    svc = service("2u-dp", seed=2)
    svc.ingest(make_chunks(n=1)[0])
    assert_bits_equal(svc.query(), svc.query(tenant="partner"))
    jsvc = jax_service("2u-dp", seed=2)
    jsvc.ingest(make_chunks(n=1)[0])
    assert_bits_equal(svc.query(tenant="partner"),
                      jsvc.query(tenant="partner"))


# ------------------------------------------------------------- put-ahead
@pytest.mark.parametrize("depth,transfer", [(1, "default"), (0, "default"),
                                            (2, None)])
def test_pipeline_counts_gauge_and_histograms(depth, transfer):
    tel = Telemetry(device="cpu")
    kw = {} if transfer == "default" else {"transfer": transfer}
    pipe = IngestPipeline(depth=depth, telemetry=tel, **kw)
    fleet = QuantileFleet.create(spec(), seed=0, device="cpu")
    chunks = make_chunks(n=4)
    versions = []
    out = pipe.run(fleet, chunks,
                   on_chunk=lambda f, n: versions.append((f, n)))
    assert [n for _, n in versions] == [CHUNK_T] * 4 and out is versions[-1][0]
    c = tel.counters()
    assert c["items_ingested"] == 4 * CHUNK_T and c["chunks_ingested"] == 4
    assert ("chunks_in_flight" in tel.gauges()) == (transfer is not None)
    if transfer is not None:
        assert tel.gauges()["chunks_in_flight"] == 0.0
    lat = tel.latency_quantiles()
    assert lat["ingest_chunk_ms"]["p50"] >= 0.0
    assert np.isfinite(lat["ingest_chunk_ms"]["p99"])
    ref = fleet.ingest(np.concatenate(chunks))
    for a, b in zip(out.state.planes(), ref.state.planes()):
        assert_bits_equal(a.numpy(), b.numpy())


# -------------------------------------------------------------- telemetry
def test_telemetry_counters_are_monotonic_and_thread_safe():
    tel = Telemetry(device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [tel.count("x") for _ in range(500)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert tel.counters()["x"] == 4000
    tel.gauge("g", 3)
    assert tel.gauges() == {"g": 3.0}
    with pytest.raises(ValueError):
        tel.count("x", -1)
    with pytest.raises(KeyError):
        tel.observe_ms("nope", 1.0)
    with pytest.raises(ValueError, match="duplicate"):
        Telemetry(metrics=("a", "a"), device="cpu")


def telemetry_planes(tel):
    tel.flush()
    sk = tel._fleet.state
    return [sk.m, sk.step, sk.sign]


def test_telemetry_histogram_equals_jax():
    from repro.service import Telemetry as JTelemetry

    tel, jtel = Telemetry(seed=golden.TELEMETRY_SEED, device="cpu"), \
        JTelemetry(seed=golden.TELEMETRY_SEED)
    assert_bits_equal(golden.feed_telemetry(tel), golden.feed_telemetry(jtel))
    jsk = jtel._fleet._lane_sketch()
    for a, f in zip(telemetry_planes(tel), ("m", "step", "sign")):
        assert_bits_equal(a.numpy(), np.asarray(getattr(jsk, f)), f)
    assert tel.snapshot()["latency_ms"] == jtel.snapshot()["latency_ms"]


@pytest.mark.parametrize("windowed", [False, True], ids=["2u", "2u-decay"])
@pytest.mark.parametrize("capacity", [64, 2048], ids=["rounds", "runs"])
def test_slo_snapshot_equals_jax(windowed, capacity):
    from repro.serve.slo import SLOFleet as JSLOFleet
    from repro.service import Telemetry as JTelemetry

    kw = dict(seed=3, capacity=capacity, windowed=windowed,
              decay_half_life=64)
    tel = Telemetry(device="cpu")
    slo, jslo = SLOFleet(telemetry=tel, device="cpu", **kw), \
        JSLOFleet(telemetry=JTelemetry(), **kw)
    rng = np.random.default_rng(1)
    metrics = [m for m, _ in slo.metrics]
    obs = [(f"route-{r}", metrics[m], float(v)) for r, m, v in zip(
        rng.zipf(1.3, 600) % 40, rng.integers(0, 3, 600),
        rng.lognormal(3.0, 1.0, 600))]
    for fl in (slo, jslo):
        for o in obs:
            fl.observe(*o)
    snap, jsnap = slo.snapshot(), jslo.snapshot()
    assert_bits_equal(snap.estimate(), jsnap.estimate())
    assert_bits_equal(snap.t_next, np.asarray(jsnap.t_next))
    assert tel.counters() == jslo.telemetry.counters()
    plane = snap.estimate()
    for r, idx in slo._routes.items():
        assert plane[idx, 1] == slo.estimate(r, "tok_q50_ms")
    # host copies: later flushes (donated in place on the runs branch)
    # leave the snapshot as it was
    before = plane.copy()
    for o in obs[:200]:
        slo.observe(*o)
    slo.flush()
    assert not np.array_equal(slo.snapshot().estimate(), before)
    assert_bits_equal(snap.estimate(), before)


def test_runtime_metadata_is_self_describing():
    meta = runtime_metadata()
    for key in ("unix_time", "wall_clock_utc", "device_count", "backend",
                "torch_version", "python_version", "cpu_count"):
        assert key in meta
    assert meta["device_count"] >= 1
    assert meta["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert meta["torch_version"] == torch.__version__


# ------------------------------------------------------------------ misc api
def test_service_rejects_ambiguous_construction_and_double_start():
    with pytest.raises(ValueError, match="exactly one"):
        StreamingService()
    s = spec()
    fleet = QuantileFleet.create(s, seed=0, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        StreamingService(s, fleet=fleet)
    with pytest.raises(ValueError, match="own device"):
        StreamingService(fleet=fleet, device="cpu")
    svc = StreamingService(fleet=fleet)
    assert svc.telemetry._fleet.device.type == "cpu"
    svc.start(iter([]))
    with pytest.raises(RuntimeError, match="join"):
        svc.start(iter([]))
    svc.join(timeout=JOIN_S)
    assert not svc.ingest_running


def test_join_reraises_ingest_errors():
    svc = service(seed=0)

    def dying():
        yield make_chunks(n=1)[0]
        raise RuntimeError("source died")

    svc.start(dying())
    with pytest.raises(RuntimeError, match="source died"):
        svc.join(timeout=JOIN_S)
    assert svc.snapshot().items_ingested == CHUNK_T
    svc.join(timeout=JOIN_S)            # the error is raised once


def test_check_health_quarantines_and_publishes():
    svc = StreamingService(spec(health="quarantine"), seed=0, device="cpu")
    svc.ingest(make_chunks(n=1)[0])
    assert svc.check_health().healthy
    fleet = svc.fleet
    sign = fleet.state.sign.clone()
    sign[3] = 0.5                               # not a sign
    svc._publish(type(fleet)(state=fleet.state.with_planes(
        (fleet.state.m, fleet.state.step, sign)), cursor=fleet.cursor,
        spec=fleet.spec), 0)
    rep = svc.check_health()
    assert rep.quarantined == 1 and svc.fleet.health().healthy
    assert svc.stats()["counters"]["quarantined_lanes"] == 1


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert StreamingService(spec(), device=None).fleet.device.type \
            == "cuda"
        assert Telemetry()._fleet.device.type == "cuda"
    else:
        for make in (lambda: StreamingService(spec()), Telemetry):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make()


# ------------------------------------------------------------------ golden
def golden_service(device):
    spec_ = FleetSpec(num_groups=golden.SERVICE_G, quantiles=(0.5,),
                      chunk_t=golden.SERVICE_CHUNK_T,
                      program=make_program(
                          "2u-decay", half_life=golden.SERVICE_HALF_LIFE))
    return StreamingService(spec_, seed=golden.SERVICE_SEED, device=device,
                            tenants=[TenantPolicy(
                                "partner", epsilon=golden.SERVICE_EPSILON)])


def assert_golden_service(device):
    data = np.load(golden.GOLDEN)
    svc = golden_service(device)
    for k in range(golden.SERVICE_CHUNKS + 1):
        assert_bits_equal(svc.query(), data["service/raw"][k], f"raw {k}")
        assert_bits_equal(svc.query(tenant="partner"), data["service/dp"][k],
                          f"dp {k}")
        if k < golden.SERVICE_CHUNKS:
            chunk = golden.service_chunk(k)
            assert golden.chunk_crc32(chunk) == data["service/chunk_crc32"][k]
            svc.ingest(chunk)
    tel = Telemetry(seed=golden.TELEMETRY_SEED, device=device)
    assert_bits_equal(golden.feed_telemetry(tel), data["telemetry/latency"])
    for a, f in zip(telemetry_planes(tel), ("m", "step", "sign")):
        assert_bits_equal(a.cpu().numpy(), data[f"telemetry/{f}"], f)
    assert list(tel._fleet.cursor) == data["telemetry/cursor"].tolist()


def test_plain_path_reproduces_the_service_golden():
    assert_golden_service("cpu")


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_service.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["2u-decay", "2u-window", "2u-dp"])
def test_card_service_equals_cpu_service(card, program):
    chunks = make_chunks(seed=4, g=512)
    before = tkernel.launch_count
    got = boundary_answers(service(program, seed=6, g=512, device=card),
                           chunks)
    assert tkernel.launch_count - before >= N_CHUNKS
    want = boundary_answers(service(program, seed=6, g=512), chunks)
    for i, ((raw, dp), (wraw, wdp)) in enumerate(zip(got, want)):
        assert_bits_equal(raw, wraw, f"trusted read at boundary {i}")
        assert_bits_equal(dp, wdp, f"partner read at boundary {i}")


@pytest.mark.cuda
def test_card_threaded_service_equals_cpu_replay(card):
    chunks = make_chunks(seed=8, n=12, g=4096)
    svc = service("2u-decay", seed=2, g=4096, device=card)
    seen = {}
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            s = svc.snapshot()
            seen[s.items_ingested] = (s.estimate(),
                                      s.estimate_dp(PARTNER_EPS))

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    svc.start(iter(chunks))
    svc.join(timeout=JOIN_S)
    stop.set()
    rt.join(timeout=JOIN_S)
    assert not rt.is_alive()
    assert svc.snapshot().items_ingested == 12 * CHUNK_T and seen
    ref = QuantileFleet.create(spec("2u-decay", g=4096), seed=2,
                               device="cpu")
    for c in [None] + chunks:
        ref = ref if c is None else ref.ingest(c)
        cursor = int(ref.cursor.t_offset)
        if cursor in seen:
            snap = Snapshot.capture(ref)
            assert_bits_equal(seen[cursor][0], snap.estimate())
            assert_bits_equal(seen[cursor][1], snap.estimate_dp(PARTNER_EPS))
    assert svc.stats()["counters"]["chunks_ingested"] == 12


@pytest.mark.cuda
def test_card_reproduces_the_service_golden(card):
    assert_golden_service(card)
