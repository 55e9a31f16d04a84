"""``repro_torch.api.FrugalEstimator`` against the JAX package's: a G = 1
fleet behind the baselines' QuantileEstimator protocol. On the CPU both
of the port's engines ("jnp", the plain loop, and "fused", the dense path)
give the JAX estimator's answers bit for bit (float32 compared as int32)
through any mix of insert / extend / query; an untracked target raises.
On the card (marker ``cuda``) the dense kernel at G = 1 gives the plain
version's answers there.

JAX is imported inside the tests that use it: the card tests run where
JAX is not installed (``--noconftest``, see README.md).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import FrugalEstimator, QuantileEstimator


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def stream(n=2500, seed=0):
    rng = np.random.default_rng(seed)
    return np.round(rng.lognormal(6.0, 1.3, n), 1)


def drive(est, xs, qs):
    """Queries after a third by extend, seven single inserts, an empty
    extend and the rest by extend."""
    a = len(xs) // 3
    out = []
    est.extend(xs[:a])
    out.append([est.query(q) for q in qs])
    for v in xs[a:a + 7]:
        est.insert(v)
    est.extend([])
    out.append([est.query(q) for q in qs])
    est.extend(xs[a + 7:])
    out.append([est.query(q) for q in qs])
    out.append([est.query(q) for q in qs])     # nothing new buffered
    return out


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("qs", [(0.5,), (0.5, 0.9), (0.99, 0.1, 0.5)],
                         ids=["q50", "q50-q90", "three"])
@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_estimator_matches_jax(algo, qs, backend):
    from repro.api import FrugalEstimator as JFrugalEstimator

    xs = stream(seed=len(qs))
    j = JFrugalEstimator(quantiles=qs, algo=algo, seed=13)
    t = FrugalEstimator(quantiles=qs, algo=algo, seed=13, backend=backend,
                        device="cpu")
    np.testing.assert_array_equal(bits(drive(t, xs, qs)),
                                  bits(drive(j, xs, qs)))
    assert t.memory_words() == j.memory_words() == \
        len(qs) * (1 if algo == "1u" else 2)
    assert t.quantiles == j.quantiles


def test_estimator_protocol_and_untracked_target():
    est = FrugalEstimator(quantiles=(0.5, 0.9), device="cpu")
    assert isinstance(est, QuantileEstimator)
    assert est.query(0.5) == 0.0           # nothing ingested: m at 0
    est.extend([3.0, 5.0])
    with pytest.raises(ValueError, match="not tracked"):
        est.query(0.75)
    assert FrugalEstimator(device="cpu")._fleet.spec.backend == "fused"


def test_estimator_without_device_needs_the_card():
    if torch.cuda.is_available():
        assert FrugalEstimator()._fleet.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            FrugalEstimator()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["1u", "2u"])
def test_card_estimator_matches_plain(algo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda tests/test_torch_estimators.py)")
    from repro_torch.kernels import frugal_update as fk

    xs, qs = stream(n=9000, seed=4), (0.5, 0.9)
    before = fk.launch_count
    card = drive(FrugalEstimator(quantiles=qs, algo=algo, seed=3), xs, qs)
    assert fk.launch_count > before
    plain = drive(FrugalEstimator(quantiles=qs, algo=algo, seed=3,
                                  backend="jnp", device="cuda"), xs, qs)
    host = drive(FrugalEstimator(quantiles=qs, algo=algo, seed=3,
                                 device="cpu"), xs, qs)
    np.testing.assert_array_equal(bits(card), bits(plain))
    np.testing.assert_array_equal(bits(card), bits(host))
