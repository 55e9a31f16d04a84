"""The port's copies of the paper's §6 comparison algorithms
(``repro_torch.core.baselines``) against the JAX package's: on the same
numpy-seeded streams every summary gives equal answers, internal state
and ``memory_words``, and the seeded ones (Selection, Reservoir) draw the
same Python ``random`` sequence."""
import numpy as np
import pytest

from repro.core import baselines as jb
from repro_torch.core import baselines as tb
from repro_torch.core.baselines import QuantileEstimator
from repro_torch.core.reference import relative_mass_error


def streams():
    rng = np.random.default_rng(0)
    return {
        "uniform": rng.integers(0, 1000, size=6000).astype(np.float64),
        "lognormal": np.round(rng.lognormal(5.0, 1.5, 5000), 3),
        "ascending": np.arange(3000, dtype=np.float64),
        "short": rng.integers(0, 50, size=7).astype(np.float64),
    }


STREAMS = streams()
MAKERS = {
    "gk20": lambda m, s: m.GKSummary(eps=0.001, max_tuples=20),
    "gk_ample": lambda m, s: m.GKSummary(eps=0.01, max_tuples=500),
    "qdigest20": lambda m, s: m.QDigest(sigma=int(max(np.max(s), 2)) + 1,
                                        b=20),
    "selection": lambda m, s: m.Selection(quantile=0.5, seed=3),
    "selection90": lambda m, s: m.Selection(quantile=0.9, seed=0,
                                            base_len=64),
    "reservoir20": lambda m, s: m.Reservoir(k=20, seed=5),
    "exact": lambda m, s: m.ExactQuantile(),
}
STATE = {"gk20": ("n", "eps", "tuples"), "gk_ample": ("n", "eps", "tuples"),
         "qdigest20": ("n", "counts"),
         "selection": ("a", "b", "u", "iteration", "phase_len", "n"),
         "selection90": ("a", "b", "u", "iteration", "phase_len", "n"),
         "reservoir20": ("n", "sample"), "exact": ("sorted",)}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("algo", sorted(MAKERS))
def test_baseline_matches_jax(algo, stream):
    s = STREAMS[stream]
    j, t = MAKERS[algo](jb, s), MAKERS[algo](tb, s)
    half = len(s) // 2
    j.extend(s[:half])
    t.extend(s[:half])
    for v in s[half:half + 5]:
        j.insert(float(v))
        t.insert(float(v))
    j.extend(s[half + 5:])
    t.extend(s[half + 5:])
    for q in (0.1, 0.5, 0.9, 0.99):
        assert t.query(q) == j.query(q), q
    assert t.memory_words() == j.memory_words()
    for attr in STATE[algo]:
        assert getattr(t, attr) == getattr(j, attr), attr
    assert isinstance(t, QuantileEstimator)


def test_empty_summaries_answer_zero():
    for algo, make in MAKERS.items():
        assert make(tb, np.ones(2)).query(0.5) == 0.0, algo


def test_gk_budget_enforced():
    gk = tb.GKSummary(eps=0.001, max_tuples=20)
    gk.extend(STREAMS["uniform"])
    assert len(gk.tuples) <= 20 and gk.memory_words() <= 60
    assert gk.eps > 0.001               # paper §6.1: epsilon inflated


def test_qdigest_memory_bounded():
    qd = tb.QDigest(sigma=1024, b=20)
    qd.extend(STREAMS["uniform"])
    assert len(qd.counts) <= 3 * 20     # paper §6.2: under 3b


def test_exact_and_ample_gk_are_accurate():
    s = STREAMS["uniform"]
    ss = sorted(s.tolist())
    ex, gk = tb.ExactQuantile(), tb.GKSummary(eps=0.01, max_tuples=500)
    ex.extend(s)
    gk.extend(s)
    for q in (0.25, 0.5, 0.9):
        assert abs(ex.query(q) - np.quantile(s, q)) < 2.0
        assert abs(relative_mass_error(gk.query(q), ss, q)) < 0.05
