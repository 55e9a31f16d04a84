"""Put-ahead staging to the card, retry, and the synthetic token corpus.

Port of the JAX package's ``data/pipeline.py``.

``prefetch_to_device`` is the put-ahead stage every ingest loop here
wants: a daemon thread draws the next item and stages it on the device
while the consumer computes on the current one. On a CUDA device the
default transfer (``DeviceStager``) pins each host array, copies it with
``non_blocking=True`` on a side stream that belongs to the stager, and
records an event after the copies; the consumer's stream waits on that
event before its first use, and each staged tensor is recorded on the
consumer's stream (``record_stream``), so the caching allocator cannot
hand its memory to a later copy while a kernel still reads it.

``RetryPolicy`` + ``with_retry`` give any batch source bounded
exponential-backoff retry with a wall-clock deadline. ``SyntheticCorpus``
draws deterministic, host-sharded token batches (Zipf tokens with
injected bigram structure); a batch keys on (seed, host_id, step), so a
retried draw is bit-identical to the first attempt. The chaos harness
injects its 'pipeline'-scoped faults at each draw
(``chaos.count_event("pipeline")``).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.platform import resolve_device
from repro_torch.resilience import chaos


class _PrefetchDone:
    """Queue sentinel: the source is exhausted."""


class _PrefetchError:
    """Queue sentinel: the source raised; re-raise at the consumer's
    matching position (a retryable chaos.StreamFault stays a
    StreamFault)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _tree_map(fn, x):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _host_tensor(x) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are, anything else through a
    C-contiguous numpy array (shared, not copied)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


def _pinned(x) -> torch.Tensor:
    """A leaf in pinned host memory (a CUDA tensor as it is)."""
    t = _host_tensor(x)
    return t if t.is_cuda else t.pin_memory()


class Staged:
    """An item that ``DeviceStager`` copied to the card: its tensors and
    the event recorded after the copies on the staging stream."""

    __slots__ = ("value", "event", "device")

    def __init__(self, value, event, device):
        self.value = value
        self.event = event
        self.device = device

    def ready(self):
        """Make the current stream wait for the copies, mark every staged
        tensor as used by it, and return the tensors."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        _tree_map(lambda t: t.record_stream(stream), self.value)
        return self.value


class DeviceStager:
    """The default transfer onto a CUDA device.

    Each leaf of an item (numpy arrays, CPU tensors, dicts and sequences
    of them) is pinned (``pin_memory()``: a page-locked copy from
    PyTorch's caching host allocator, which reuses a pinned block only
    after the copies recorded on it ran) and copied with
    ``non_blocking=True`` on ``self.stream``, a side stream used by
    nothing else; an event recorded after the copies marks the item
    ready. Returns a ``Staged``: ``prefetch_to_device`` hands the
    consumer ``Staged.ready()``.

    ``log`` (a list, or None) receives per item (pin ms on the host
    clock, copy start event, copy end event), the events timed on the
    side stream.
    """

    def __init__(self, device, log: Optional[list] = None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceStager stages onto a CUDA device, got "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self.log = log

    def __call__(self, item) -> Staged:
        t0 = time.perf_counter()
        pinned = _tree_map(_pinned, item)
        pin_ms = (time.perf_counter() - t0) * 1e3
        timed = self.log is not None
        with torch.cuda.stream(self.stream):
            start = torch.cuda.Event(enable_timing=timed)
            start.record(self.stream)
            value = _tree_map(
                lambda t: t.to(self.device, non_blocking=True), pinned)
            done = torch.cuda.Event(enable_timing=timed)
            done.record(self.stream)
        if timed:
            self.log.append((pin_ms, start, done))
        return Staged(value, done, self.device)


def device_transfer(device=None) -> Callable:
    """The default transfer onto ``device`` (None: the card; raises where
    there is none): a ``DeviceStager`` for a CUDA device; for the CPU, a
    copy of every leaf as a tensor (no staged item aliases the source's
    buffers)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return DeviceStager(device)
    if device.type != "cpu":
        raise ValueError(f"no transfer onto device {device}")
    return lambda item: _tree_map(
        lambda x: _host_tensor(x).to("cpu", copy=True), item)


def _ready(got):
    return got.ready() if isinstance(got, Staged) else got


def prefetch_to_device(it: Iterator, depth: int = 1,
                       transfer: Optional[Callable] = None,
                       device=None) -> Iterator:
    """Device put-ahead: a daemon thread draws the NEXT item from ``it``
    and stages it on the device while the consumer computes on the
    current one.

    ``transfer`` maps one drawn item to its device form (default:
    ``device_transfer(device)``, with ``device=None`` the card; dict
    batches and bare arrays both work). Values and order are
    bit-identical to the undecorated iterator: staging moves the host to
    device copy off the consumer's critical path, never reorders or
    re-draws. ``depth`` bounds the put-ahead queue (1 = double
    buffering); ``depth=0`` stages each item synchronously on the
    consumer's thread.

    Exceptions from the source re-raise at the consumer's matching pull
    (type preserved: a retryable StreamFault is still a StreamFault).
    Closing the returned generator stops the worker; the thread is
    daemonic, so a leaked iterator cannot hang interpreter shutdown.
    """
    if transfer is None:
        transfer = device_transfer(device)
    if depth <= 0:
        return (_ready(transfer(x)) for x in it)

    q: "queue.Queue" = queue.Queue(maxsize=int(depth))
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                staged = transfer(item)
                while not stop.is_set():
                    try:
                        q.put(staged, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    return
            tail = _PrefetchDone()
        except BaseException as e:  # noqa: BLE001 — relayed, not swallowed
            tail = _PrefetchError(e)
        while not stop.is_set():
            try:
                q.put(tail, timeout=0.05)
                return
            except queue.Full:
                continue

    thread = threading.Thread(target=worker, name="prefetch_to_device",
                              daemon=True)

    def consume():
        thread.start()
        try:
            while True:
                got = q.get()
                if isinstance(got, _PrefetchDone):
                    return
                if isinstance(got, _PrefetchError):
                    raise got.exc
                yield _ready(got)
        finally:
            stop.set()

    return consume()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and a hard deadline.

    max_retries    — retries AFTER the first attempt (total attempts =
                     max_retries + 1).
    backoff_s      — sleep before the first retry.
    backoff_factor — multiplier per subsequent retry.
    deadline_s     — wall-clock budget for the whole call, sleeps included;
                     a retry that would overshoot it re-raises instead.
    """

    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    deadline_s: float = 30.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_s must be >= 0 and backoff_factor "
                             ">= 1.0")


def with_retry(fn: Callable, policy: Optional[RetryPolicy], *,
               sleep=time.sleep, clock=time.monotonic):
    """Call ``fn()`` under ``policy``; transient faults (chaos.StreamFault,
    the class deterministic injection raises and the one a real reader
    should raise for retryable I/O) are retried with exponential backoff.
    policy=None means no retry. ``sleep``/``clock`` are injectable for
    tests."""
    if policy is None:
        return fn()
    start = clock()
    delay = policy.backoff_s
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except chaos.StreamFault:
            out_of_budget = (clock() - start) + delay > policy.deadline_s
            if attempt == policy.max_retries or out_of_budget:
                raise
            sleep(delay)
            delay *= policy.backoff_factor
    raise AssertionError("unreachable")  # pragma: no cover


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 64
    batch_size: int = 8
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.2
    structure: bool = True   # inject learnable bigram structure


class SyntheticCorpus:
    """Deterministic, shardable synthetic token stream."""

    def __init__(self, cfg: DataConfig, retry: Optional[RetryPolicy] = None,
                 _sleep=time.sleep):
        self.cfg = cfg
        self.retry = retry
        self._sleep = _sleep
        rng = np.random.default_rng(cfg.seed)
        # fixed bigram table: tok -> likely successor (learnable signal)
        self.succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size)

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, self.cfg.host_id, step))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """One deterministic batch; retried under ``self.retry`` (the draw
        keys on (seed, host, step), so attempt N is bit-identical to
        attempt 1)."""
        return with_retry(lambda: self._batch_once(step), self.retry,
                          sleep=self._sleep)

    def _batch_once(self, step: int) -> Dict[str, np.ndarray]:
        chaos.count_event("pipeline")
        c = self.cfg
        rng = self._batch_rng(step)
        z = rng.zipf(c.zipf_a, size=(c.batch_size, c.seq_len + 1))
        toks = (z - 1) % c.vocab_size
        if c.structure:
            # with p=0.5, token t+1 = succ[token t]: gives the model signal
            follow = rng.random((c.batch_size, c.seq_len)) < 0.5
            for t in range(c.seq_len):
                toks[:, t + 1] = np.where(follow[:, t],
                                          self.succ[toks[:, t]], toks[:, t + 1])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }

    def _raw_iter(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1

    def iterate(self, start_step: int = 0, prefetch: int = 1,
                device=None) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless stream of int32 tensor batches on ``device`` (None: the
        card; raises where there is none) from ``start_step``.

        ``prefetch`` >= 1 stages the next batch (host draw + copy) on a
        background thread while the training step computes;
        ``prefetch=0`` stages synchronously. Both yield bit-identical
        values in the same order: batch RNG keys on (seed, host_id,
        step), never on staging."""
        return prefetch_to_device(self._raw_iter(start_step),
                                  depth=prefetch, device=device)


def make_data_iter(cfg: DataConfig, start_step: int = 0, device=None):
    return SyntheticCorpus(cfg).iterate(start_step, device=device)
