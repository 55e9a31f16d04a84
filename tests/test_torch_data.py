"""The port's data substrate against the JAX package.

* CPU: every stream generator of ``repro_torch.data.streams`` and
  ``pad_ragged`` equal to the JAX package's for the same numpy seed;
  ``SyntheticCorpus`` batches for several (seed, host_id, step); retry
  with backoff (a bit-identical batch), exhaustion, the deadline and no
  retry without a policy; ``prefetch_to_device`` on the CPU: same values
  (dict batches and bare arrays, put-ahead and synchronous), overlap shown
  by event ordering (not by the clock), source errors relayed with their
  type, and the worker stopped when the consumer closes the stream; the
  entry points' default device (the card, raising without one).
* Card (marker ``cuda``, skipped without a CUDA device): 50 chunks staged
  by ``prefetch_to_device`` (pinned copies on a side stream), each
  consumed by a launch of the dense kernel, equal to the same chunks
  copied synchronously: without the event wait or ``record_stream``, the
  allocator could hand a chunk's memory to the next copy while the kernel
  still reads it.

Tolerance everywhere: bit-exact. JAX is imported inside the tests that
use it: the card tests run where JAX is not installed (``--noconftest``).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.data import pipeline as tpipe
from repro_torch.data import streams as tstreams
from repro_torch.resilience import Fault, FaultPlan, chaos

JOIN_S = 10.0            # every join and queue wait here is bounded


def rng_of(seed):
    return lambda: np.random.default_rng(seed)


# ------------------------------------------------------------ generators
GENERATORS = {
    "cauchy": lambda m, r: m.cauchy_stream(n=500, rng=r()),
    "dynamic_cauchy": lambda m, r: m.dynamic_cauchy_stream(n_per=300,
                                                           rng=r()),
    "tcp_size": lambda m, r: m.tcp_like_group_streams(
        num_sites=3, num_months=2, min_len=200, max_len=900, rng=r()),
    "tcp_duration": lambda m, r: m.tcp_like_group_streams(
        num_sites=3, num_months=2, min_len=200, max_len=900,
        kind="duration", rng=r()),
    "combined_month": lambda m, r: m.combined_month_stream(n=700, rng=r()),
    "dynamic_combined": lambda m, r: m.dynamic_combined_stream(n=701,
                                                               rng=r()),
    "twitter": lambda m, r: m.twitter_like_interval_streams(
        num_users=6, cap=900, min_len=300, rng=r()),
    "daily": lambda m, r: m.daily_combined_interval_streams(
        num_days=4, min_len=100, max_len=400, rng=r()),
    "ascending": lambda m, r: m.ascending_stream(n=333),
    "pad_ragged": lambda m, r: m.pad_ragged(
        [r().normal(size=n) for n in (5, 1, 9, 3)]),
    "pad_ragged_f64": lambda m, r: m.pad_ragged(
        [np.arange(n, dtype=np.float64) for n in (2, 4)], dtype=np.float64),
}


def flat(x):
    """A generator's output as a list of arrays (tuples and lists of
    streams flattened in order)."""
    if isinstance(x, (list, tuple)):
        return [np.asarray(a) for a in x]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", list(GENERATORS))
def test_stream_generators_equal_jax(name):
    from repro.data import streams as jstreams

    got = flat(GENERATORS[name](tstreams, rng_of(3)))
    want = flat(GENERATORS[name](jstreams, rng_of(3)))
    assert len(got) == len(want) and len(got) >= 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_generator_defaults_draw_jax_streams():
    from repro.data import streams as jstreams

    for fn in ("cauchy_stream", "dynamic_cauchy_stream"):
        for a, b in zip(flat(getattr(tstreams, fn)()),
                        flat(getattr(jstreams, fn)())):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- corpus
@pytest.mark.parametrize("seed,host_id,step,structure", [
    (0, 0, 0, True), (3, 1, 7, True), (11, 2, 123, False)])
def test_corpus_batches_equal_jax(seed, host_id, step, structure):
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticCorpus as JCorpus

    kw = dict(seed=seed, host_id=host_id, num_hosts=3, structure=structure,
              vocab_size=97, seq_len=16, batch_size=4)
    got = tpipe.SyntheticCorpus(tpipe.DataConfig(**kw)).batch(step)
    want = JCorpus(JDataConfig(**kw)).batch(step)
    assert sorted(got) == sorted(want) == ["targets", "tokens"]
    for k in got:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_iterate_yields_the_batches_as_int32_tensors(prefetch):
    corpus = tpipe.SyntheticCorpus(tpipe.DataConfig(seed=3))
    it = corpus.iterate(start_step=2, prefetch=prefetch, device="cpu")
    try:
        for step in range(2, 6):
            got, want = next(it), corpus.batch(step)
            for k in ("tokens", "targets"):
                assert isinstance(got[k], torch.Tensor)
                assert got[k].dtype == torch.int32 \
                    and got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        it.close()
    first = next(tpipe.make_data_iter(tpipe.DataConfig(seed=3),
                                      device="cpu"))
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  corpus.batch(0)["tokens"])


# ------------------------------------------------------------------ retry
def test_retry_backoff_then_bit_identical_batch():
    sleeps = []
    corpus = tpipe.SyntheticCorpus(
        tpipe.DataConfig(), retry=tpipe.RetryPolicy(
            max_retries=3, backoff_s=0.01, backoff_factor=2.0,
            deadline_s=60.0), _sleep=sleeps.append)
    ref = tpipe.SyntheticCorpus(tpipe.DataConfig()).batch(5)
    plan = FaultPlan(faults=[Fault(kind="stream", at=1, scope="pipeline"),
                             Fault(kind="stream", at=2, scope="pipeline")])
    with chaos.armed(plan):
        batch = corpus.batch(5)
    assert sleeps == [0.01, 0.02] and plan.fired() == 2
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(batch[k], ref[k])


def test_retry_exhaustion_reraises():
    sleeps = []
    corpus = tpipe.SyntheticCorpus(
        tpipe.DataConfig(), retry=tpipe.RetryPolicy(max_retries=2,
                                                    backoff_s=0.01),
        _sleep=sleeps.append)
    plan = FaultPlan(faults=[Fault(kind="stream", at=i, scope="pipeline")
                             for i in range(1, 6)])
    with chaos.armed(plan):
        with pytest.raises(chaos.StreamFault):
            corpus.batch(0)
    assert len(sleeps) == 2                    # 3 attempts, 2 backoffs


def test_retry_deadline_cuts_backoff_short():
    clock = [0.0]

    def fn():
        chaos.count_event("pipeline")
        return "ok"

    plan = FaultPlan(faults=[Fault(kind="stream", at=i, scope="pipeline")
                             for i in range(1, 10)])
    with chaos.armed(plan):
        with pytest.raises(chaos.StreamFault):
            tpipe.with_retry(
                fn, tpipe.RetryPolicy(max_retries=8, backoff_s=1.0,
                                      backoff_factor=2.0, deadline_s=3.0),
                sleep=lambda s: clock.__setitem__(0, clock[0] + s),
                clock=lambda: clock[0])
    assert clock[0] == 3.0                     # slept 1 + 2, then gave up


def test_no_retry_policy_means_no_retry():
    corpus = tpipe.SyntheticCorpus(tpipe.DataConfig())     # retry=None
    plan = FaultPlan(faults=[Fault(kind="stream", at=1, scope="pipeline")])
    with chaos.armed(plan):
        with pytest.raises(chaos.StreamFault):
            corpus.batch(0)
    with pytest.raises(ValueError):
        tpipe.RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        tpipe.RetryPolicy(backoff_factor=0.5)


# -------------------------------------------------------------- put-ahead
def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "prefetch_to_device" and t.is_alive()]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_values_equal_the_source(depth):
    rng = np.random.default_rng(0)
    items = [{"x": rng.normal(size=(3, 4)).astype(np.float32),
              "y": (rng.integers(0, 9, 5).astype(np.int32),)}
             for _ in range(5)] + [rng.normal(size=(2, 2))]
    got = list(tpipe.prefetch_to_device(iter(items), depth=depth,
                                        device="cpu"))
    assert len(got) == len(items)
    for g, w in zip(got[:-1], items[:-1]):
        assert isinstance(g["x"], torch.Tensor)
        np.testing.assert_array_equal(g["x"].numpy(), w["x"])
        np.testing.assert_array_equal(g["y"][0].numpy(), w["y"][0])
        assert g["x"].numpy().ctypes.data != w["x"].ctypes.data  # a copy
    np.testing.assert_array_equal(got[-1].numpy(), items[-1])


def test_prefetch_overlaps_source_with_consumer():
    """No clock: with depth=1 the worker must have STARTED drawing item 1
    while the consumer still holds item 0."""
    draws = []

    def source():
        for k in range(5):
            draws.append(k)
            yield np.full((2, 2), k, np.float32)

    it = tpipe.prefetch_to_device(source(), depth=1, device="cpu")
    first = next(it)
    deadline = time.monotonic() + JOIN_S
    while len(draws) < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert len(draws) >= 2, "no put-ahead: item 1 was never drawn while " \
                            "the consumer held item 0"
    np.testing.assert_array_equal(first.numpy(), 0.0)
    assert [int(x[0, 0]) for x in it] == [1, 2, 3, 4]


@pytest.mark.parametrize("depth", [0, 1])
def test_prefetch_relays_source_errors_with_type(depth):
    def source():
        yield np.zeros((1, 2), np.float32)
        raise chaos.StreamFault("boom")

    it = tpipe.prefetch_to_device(source(), depth=depth, device="cpu")
    next(it)
    with pytest.raises(chaos.StreamFault, match="boom"):
        next(it)


def test_closing_the_stream_stops_the_worker():
    # Track this stream's own worker: an earlier test's worker may still
    # be exiting while this one runs, so a bare thread count races.
    before = set(prefetch_threads())

    def endless():
        k = 0
        while True:
            yield np.full(3, k, np.float32)
            k += 1

    it = tpipe.prefetch_to_device(endless(), depth=2, device="cpu")
    assert int(next(it)[0]) == 0
    started = set(prefetch_threads()) - before
    assert len(started) == 1
    (worker,) = started
    it.close()
    worker.join(timeout=JOIN_S)
    assert not worker.is_alive()


def test_custom_transfer_is_applied_in_order():
    it = tpipe.prefetch_to_device(iter(range(6)), depth=1,
                                  transfer=lambda k: k * 10)
    assert list(it) == [0, 10, 20, 30, 40, 50]


# ----------------------------------------------------------------- devices
ENTRY_POINTS = {
    "prefetch_to_device": lambda **kw: tpipe.prefetch_to_device(
        iter([np.zeros(2, np.float32)]), **kw),
    "iterate": lambda **kw: tpipe.SyntheticCorpus(
        tpipe.DataConfig()).iterate(**kw),
    "make_data_iter": lambda **kw: tpipe.make_data_iter(tpipe.DataConfig(),
                                                        **kw),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        it = ENTRY_POINTS[entry]()
        got = next(it)
        leaf = got if isinstance(got, torch.Tensor) else got["tokens"]
        assert leaf.device.type == "cuda"
        it.close()
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ENTRY_POINTS[entry]()


def test_stager_stages_onto_a_card_only():
    with pytest.raises(ValueError, match="CUDA"):
        tpipe.DeviceStager("cpu")
    with pytest.raises(ValueError, match="no transfer"):
        tpipe.device_transfer("meta")


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_data.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_prefetch_feeding_the_kernel_equals_sync_copies(card):
    """50 chunks of [64, 2^16] staged with put-ahead depth 2, each read by
    one launch of the dense kernel and dropped at once, against the same
    chunks copied synchronously: the same words, and each staged chunk's
    bytes equal to its source."""
    from repro_torch.core import program as tprogram
    from repro_torch.kernels import frugal_update as tkernel

    prog = tprogram.make_program("2u")
    g, t, n = 1 << 16, 64, 50
    rng = np.random.default_rng(5)
    chunks = [rng.lognormal(3.0, 1.0, (t, g)).astype(np.float32)
              for _ in range(n)]
    q = torch.full((g,), 0.9, device=card)
    fresh = (torch.zeros(g, device=card), torch.ones(g, device=card),
             torch.ones(g, device=card))

    def run(stream):
        words = prog.layout.pack_planes(fresh)
        sums = []
        for i, x in enumerate(stream):
            assert x.device.type == "cuda"
            words = tkernel.frugal_program_dense(prog, x, words, q, 3,
                                                 t_offset=i * t)
            sums.append(x.sum(dtype=torch.float64))
            del x
        torch.cuda.synchronize()
        return words, torch.stack(sums).cpu().numpy()

    before = tkernel.launch_count
    staged, staged_sums = run(tpipe.prefetch_to_device(iter(chunks), depth=2,
                                                       device=card))
    sync, sync_sums = run(torch.from_numpy(c).to(card) for c in chunks)
    assert tkernel.launch_count - before == 2 * n
    np.testing.assert_array_equal(staged_sums, sync_sums)
    for a, b in zip(staged, sync):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_card_corpus_batches_equal_host_batches(card):
    corpus = tpipe.SyntheticCorpus(tpipe.DataConfig(seed=1))
    it = corpus.iterate(prefetch=1)
    try:
        for step in range(8):
            got, want = next(it), corpus.batch(step)
            for k in ("tokens", "targets"):
                assert got[k].device.type == "cuda"
                np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    finally:
        it.close()
