"""The paper's evaluation in the port against the JAX package: the E3
(``benchmarks/bench_groupby_tcp.py``, Figures 6-7) and E5
(``bench_groupby_twitter.py``, Figures 10-11) GROUPBY workloads, their
NaN-padded ragged streams through ``FleetSpec`` / ``QuantileFleet``, the
§7 metric (``relative_mass_error``, the fraction of streams within 0.1),
the baselines and ``FrugalEstimator``.

* CPU: the workloads at the benchmarks' quick size through both packages
  (the port's fused engine, which is its plain version on the CPU),
  estimates bit-identical (float32 compared as int32), mass errors equal;
  one full-size E3 size fleet ([11996, 532], 2u, q = 0.5) through both;
  the port's baselines and ``FrugalEstimator`` against the JAX answers in
  tests/data/torch_port_golden.npz; the golden file's keys from before
  the evaluation keys unchanged.
* Card (marker ``cuda``): the full-size E3 size fleet on the card, the
  dense kernel against the plain version there and the golden file.

JAX is imported inside the tests that use it: the card tests run where
JAX is not installed (``--noconftest``, see README.md).
"""
import functools
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import FleetSpec, FrugalEstimator, QuantileFleet
from repro_torch.core import baselines as tbaselines
from repro_torch.core import reference as tref
from repro_torch.data import streams as tstreams

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

# sha256 over (name, dtype, shape, bytes) of every key the golden file
# held before the evaluation keys (and the later placement keys) were
# added, in sorted order.
EARLIER_KEYS, EARLIER_SHA256 = 136, (
    "b741af043a5094165bbf5b7742080eb7f7fde1a40d42c7730fe8f764c9a7dd4c")
CASES = [(name, algo, q) for name in golden.EVAL_DATASETS
         for algo in golden.EVAL_ALGOS for q in golden.EVAL_QS]
CASE_IDS = [f"{n}-{a}-q{int(q * 100)}" for n, a, q in CASES]


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def golden_file():
    return dict(np.load(golden.GOLDEN))


@functools.lru_cache(maxsize=None)
def port_streams(name, quick):
    return golden.eval_streams(tstreams, name, quick)


@functools.lru_cache(maxsize=None)
def jax_streams(name, quick):
    from repro.data import streams

    return golden.eval_streams(streams, name, quick)


def port_estimates(items, algo, q, key, backend="fused", device="cpu"):
    spec = FleetSpec(num_groups=items.shape[1], quantiles=(q,), algo=algo,
                     chunk_t=golden.EVAL_CHUNK_T, backend=backend)
    fleet = QuantileFleet.create(spec, key=key, device=device)
    return fleet.ingest(items).estimate(q)


def jax_estimates(items, algo, q):
    import jax
    from repro.api import FleetSpec as JFleetSpec
    from repro.api import QuantileFleet as JQuantileFleet

    spec = JFleetSpec(num_groups=items.shape[1], quantiles=(q,), algo=algo,
                      chunk_t=golden.EVAL_CHUNK_T, backend="jnp")
    fleet = JQuantileFleet.create(spec,
                                  key=jax.random.PRNGKey(golden.EVAL_KEY))
    return np.asarray(fleet.ingest(items).estimate(q))


def test_earlier_golden_keys_unchanged(golden_file):
    earlier = sorted(k for k in golden_file
                     if not k.startswith(("eval/", "place/", "serve/",
                                          "train/", "moe/", "ssm/",
                                          "encdec/")))
    h = hashlib.sha256()
    for k in earlier:
        v = np.ascontiguousarray(golden_file[k])
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    assert (len(earlier), h.hexdigest()) == (EARLIER_KEYS, EARLIER_SHA256)


@pytest.mark.parametrize("name", golden.EVAL_DATASETS)
def test_quick_streams_match_jax(name):
    from repro.data import streams

    got, want = port_streams(name, True), jax_streams(name, True)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bits(tstreams.pad_ragged(got)),
                                  bits(streams.pad_ragged(want)))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_quick_workload_matches_jax(case, golden_file):
    """One (workload, algo, q) fleet of the benchmark at quick size:
    estimates, mass errors and the fraction within 0.1."""
    from repro.core import reference as jref

    name, algo, q = case
    streams = port_streams(name, True)
    items = tstreams.pad_ragged(streams)
    got = port_estimates(items, algo, q, golden_file["eval/key_words"])
    want = jax_estimates(items, algo, q)
    np.testing.assert_array_equal(bits(got), bits(want))
    ss = [sorted(s.tolist()) for s in streams]
    terr = [tref.relative_mass_error(float(e), s, q) for e, s in zip(got, ss)]
    jerr = [jref.relative_mass_error(float(e), s, q)
            for e, s in zip(want, ss)]
    assert terr == jerr
    assert 0.0 <= np.mean([abs(e) <= 0.1 for e in terr]) <= 1.0


def test_full_size_e3_fleet_matches_jax(golden_file):
    streams = port_streams("e3_size", False)
    items = tstreams.pad_ragged(streams)
    assert items.shape == (11996, 532)
    assert golden.chunk_crc32(items) == int(
        golden_file["eval/e3_size/items_crc32"])
    got = port_estimates(items, "2u", 0.5, golden_file["eval/key_words"])
    np.testing.assert_array_equal(bits(got), bits(jax_estimates(items, "2u",
                                                                0.5)))
    np.testing.assert_array_equal(bits(got),
                                  bits(golden_file["eval/e3_size/2u_q50"]))


@pytest.mark.parametrize("name", golden.EVAL_DATASETS)
def test_full_size_streams_match_golden(name, golden_file):
    items = tstreams.pad_ragged(port_streams(name, False))
    assert list(items.shape) == golden_file[f"eval/{name}/shape"].tolist()
    assert golden.chunk_crc32(items) == int(
        golden_file[f"eval/{name}/items_crc32"])


def test_baselines_match_golden(golden_file):
    size = port_streams("e3_size", False)[:golden.EVAL_BASELINE_STREAMS]
    q = golden.EVAL_BASELINE_Q
    for i, algo in enumerate(golden.EVAL_BASELINES):
        est, words = [], []
        for s in size:
            b = golden.make_baseline(tbaselines, algo, s, q)
            b.extend(s)
            est.append(b.query(q))
            words.append(b.memory_words())
        assert est == golden_file["eval/baselines/estimates"][i].tolist()
        assert words == golden_file["eval/baselines/memory_words"][
            i].tolist()


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("algo", golden.EVAL_ALGOS)
def test_estimator_matches_golden(algo, backend, golden_file):
    est = FrugalEstimator(quantiles=golden.EVAL_QS, algo=algo, seed=0,
                          backend=backend, device="cpu")
    got = golden.estimator_feed(est, port_streams("e3_size", False)[0])
    np.testing.assert_array_equal(bits(got),
                                  bits(golden_file[f"eval/estimator/{algo}"]))


@pytest.mark.cuda
def test_card_e3_fleet_matches_plain_and_golden(golden_file):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda tests/test_torch_eval.py)")
    from repro_torch.kernels import frugal_update as fk

    items = tstreams.pad_ragged(port_streams("e3_size", False))
    key = golden_file["eval/key_words"]
    before = fk.launch_count
    card = port_estimates(items, "2u", 0.5, key, device="cuda")
    assert fk.launch_count - before == -(-items.shape[0] //
                                         golden.EVAL_CHUNK_T)
    plain = port_estimates(items, "2u", 0.5, key, backend="jnp",
                           device="cuda")
    np.testing.assert_array_equal(bits(card), bits(plain))
    np.testing.assert_array_equal(bits(card),
                                  bits(golden_file["eval/e3_size/2u_q50"]))
