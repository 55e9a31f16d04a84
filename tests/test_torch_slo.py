"""The port's ``serve.SLOFleet`` against the JAX package's, on the CPU.

The same Zipf(1.2)-routed observations (repeated lanes, so a flush splits
into many rounds) go into both packages, with route growth through
``ensure_routes`` between flushes, on both flush branches: the dense one
(``tick_lanes`` over the whole fleet per round, at most 4096 lanes) and
the sparse one (one ``tick_lanes_sparse`` call per flush, each lane's
events one run, 2048 routes x 3 metrics = 6144 lanes), vanilla and
windowed (``2u-decay``). The JAX fleet applies the sparse branch round by
round, so the two agree only if a run equals its rounds. State carries
across the two packages both ways (the meta blob equal to the JAX
package's, health policy included) and both continue bit-for-bit.

Tolerance: bit-exact (float32 compared as int32 bit patterns, clocks
compared exactly).
"""
import numpy as np
import pytest
import torch

from repro.serve import SLOFleet as JSLOFleet
from repro_torch.serve import DEFAULT_METRICS, SLOFleet

METRICS = [m for m, _ in DEFAULT_METRICS]


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def observations(n_routes, n, seed):
    """n (route, metric, value) triples: Zipf(1.2) routes over
    ``n_routes``, a random metric, lognormal values."""
    rng = np.random.default_rng(seed)
    routes = (rng.zipf(1.2, n) - 1) % n_routes
    metrics = rng.integers(0, len(METRICS), n)
    vals = rng.lognormal(3.0, 1.0, n)
    return [(f"r{r}", METRICS[m], float(v))
            for r, m, v in zip(routes, metrics, vals)]


def feed(fleet, obs):
    for route, metric, value in obs:
        fleet.observe(route, metric, value)
    fleet.flush()


def assert_same(jfl, tfl, what):
    js, ts = jfl.summaries(), tfl.summaries()
    assert list(js) == list(ts), what
    for route in js:
        for metric in METRICS:
            assert np.float32(js[route][metric]).view(np.int32) == \
                np.float32(ts[route][metric]).view(np.int32), \
                f"{what}: {route} {metric}"
    assert jfl._cap_routes == tfl._cap_routes, what
    for name in ("_m", "_step", "_sign", "_ticks"):
        np.testing.assert_array_equal(bits(getattr(jfl, name)),
                                      bits(getattr(tfl, name)),
                                      err_msg=f"{what}: {name}")


class Counter:
    def __init__(self):
        self.counts = {}

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


# (capacity, routes registered before the first flush, routes in all):
# dense stays at or under DENSE_LANES_MAX lanes, sparse goes above it.
BRANCHES = {"dense": (64, 200, 1024), "sparse": (1024, 600, 2048)}


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["2u", "2u-decay"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_summaries_match_jax(branch, windowed):
    cap, first, total = BRANCHES[branch]
    kw = dict(seed=7, capacity=cap, windowed=windowed, decay_half_life=64)
    jfl = JSLOFleet(**kw)
    tel = Counter()
    tfl = SLOFleet(telemetry=tel, device="cpu", **kw)
    lanes_max = SLOFleet.DENSE_LANES_MAX
    for fl in (jfl, tfl):
        fl.ensure_routes(f"r{i}" for i in range(first))
    feed(jfl, observations(first, 700, 1))
    feed(tfl, observations(first, 700, 1))
    assert_same(jfl, tfl, "first flush")
    for fl in (jfl, tfl):
        fl.ensure_routes(f"r{i}" for i in range(total))
    lanes = tfl._cap_routes * tfl.n_metrics
    assert (lanes <= lanes_max) == (branch == "dense")
    for f in range(2):
        obs = observations(total, 900, 2 + f)
        feed(jfl, obs)
        feed(tfl, obs)
        assert_same(jfl, tfl, f"flush {f + 2}")
    assert tel.counts == {"slo_events_flushed": 2500, "slo_flushes": 3}
    assert int(tfl._ticks.sum()) == 2500
    route = "r0"
    assert tfl.summary(route) == jfl.summary(route)
    assert tfl.estimate(route, "len_q50") == jfl.estimate(route, "len_q50")
    assert tfl.memory_words() == jfl.memory_words() == 2
    assert tfl.state_words() == jfl.state_words()
    assert tfl.num_lanes == jfl.num_lanes and tfl.routes() == jfl.routes()


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["2u", "2u-decay"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_hot_route_and_nan_values_match_jax(branch, windowed):
    """A third of the events on one route (runs of about a hundred per
    lane) and NaN values, which advance their lane's clock in both
    packages; the sparse branch makes one launch-sized call per flush."""
    cap, _, total = BRANCHES[branch]
    kw = dict(seed=11, capacity=cap, windowed=windowed, decay_half_life=64)
    jfl, tfl = JSLOFleet(**kw), SLOFleet(device="cpu", **kw)
    for fl in (jfl, tfl):
        fl.ensure_routes(f"r{i}" for i in range(total))
    rng = np.random.default_rng(21)
    for f in range(2):
        obs = observations(total, 900, 30 + f)
        for i in np.flatnonzero(rng.random(len(obs)) < 0.33):
            obs[i] = ("r5",) + obs[i][1:]
        for i in np.flatnonzero(rng.random(len(obs)) < 0.05):
            obs[i] = obs[i][:2] + (float("nan"),)
        feed(jfl, obs)
        feed(tfl, obs)
        assert_same(jfl, tfl, f"flush {f}")
    assert int(tfl._ticks.sum()) == 1800


def test_observe_on_new_routes_grows_capacity():
    jfl, tfl = JSLOFleet(capacity=2), SLOFleet(capacity=2, device="cpu")
    obs = observations(50, 300, 5)
    feed(jfl, obs)
    feed(tfl, obs)
    assert tfl._cap_routes == 64
    assert_same(jfl, tfl, "grown by observe")


def test_reads_and_names_refuse_unknown_keys():
    fl = SLOFleet(capacity=4, device="cpu")
    with pytest.raises(KeyError):
        fl.estimate("nope", "len_q50")
    with pytest.raises(KeyError):
        fl.observe("r0", "no_such_metric", 1.0)
    assert fl.num_routes == 0          # the typo registered nothing
    with pytest.raises(ValueError, match="duplicate"):
        SLOFleet(metrics=[("a", 0.5), ("a", 0.9)], device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert SLOFleet().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SLOFleet()


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["2u", "2u-decay"])
def test_state_carries_across_both_ways(windowed):
    kw = dict(seed=3, capacity=2048, windowed=windowed, decay_half_life=64,
              health_policy="ignore")
    jfl = JSLOFleet(**kw)
    jfl.ensure_routes(f"r{i}" for i in range(1500))
    feed(jfl, observations(1500, 800, 11))
    tfl = SLOFleet.from_checkpoint_state(jfl.checkpoint_state(),
                                       device="cpu")
    assert tfl.windowed == windowed and tfl.health_policy == "ignore"
    assert_same(jfl, tfl, "carried in")
    obs = observations(1500, 800, 12)
    feed(jfl, obs)
    feed(tfl, obs)
    assert_same(jfl, tfl, "continued")

    state = tfl.to_numpy_state()
    assert isinstance(state["ticks"], np.ndarray)
    # The meta blob is the JAX package's, health policy included.
    np.testing.assert_array_equal(state["meta_blob"],
                                  jfl.checkpoint_state()["meta_blob"])
    back = JSLOFleet.from_checkpoint_state(state)
    assert back.health_policy == "ignore"
    assert_same(back, tfl, "carried out")
    obs = observations(1500, 800, 13)
    feed(back, obs)
    feed(tfl, obs)
    assert_same(back, tfl, "continued after carrying out")
