"""Deterministic fault injection, port of the JAX package's
``resilience/chaos.py``.

A ``FaultPlan`` is a seeded, replayable set of faults; ``armed(plan)``
installs it for the duration of a ``with`` block. Streaming ingest
(``core/streaming.py``) and the checkpoint protocol
(``train/checkpoint.py``) call the hook functions below at their injection
points. Every hook starts with ``if _ACTIVE is None: return``, so an
unarmed process pays one module-global read per chunk or protocol phase.

Fault kinds:
  'stream'      — raise StreamFault when the scoped event counter reaches
                  ``at`` (scope 'ingest' counts fully-applied chunks inside
                  ingest_stream).
  'flip'        — XOR bit ``bit`` of plane ``plane``, lane ``lane``, the
                  first time the ingest clock covers tick ``at`` (an
                  in-memory single-event upset; resilience.health detects
                  it).
  'ckpt_kill'   — raise CheckpointKilled at checkpoint-protocol phase
                  ``phase`` ('after_leaves': between leaf write and
                  manifest; 'before_marker': between dir rename and
                  COMMITTED marker).
  'ckpt_garble' — after a step commits, truncate or garble its leaf file on
                  disk (the format-4 CRCs catch it at restore).
  'drop_shard'  — make the next shard read raise FileNotFoundError.
  'query_stall' — raise QueryStalled when the scoped query counter reaches
                  ``at`` (scope 'query').

Each fault fires at most once. Module-level imports are numpy and stdlib
only: ``core/streaming.py`` imports this module while ``repro_torch.core``
initialises; ``corrupt_sketch`` imports torch when a flip is due.
"""
from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Fault", "FaultPlan", "StreamFault", "StreamInterrupted",
    "CheckpointKilled", "QueryStalled", "armed", "active", "count_event",
    "corrupt_sketch", "on_checkpoint_phase", "on_checkpoint_committed",
    "on_restore_shard", "on_query_event", "corrupt_leaf_bytes",
]


class StreamFault(RuntimeError):
    """A transient stream-source failure (injected or real); ingest_stream
    surfaces it wrapped in a resumable StreamInterrupted."""


class CheckpointKilled(RuntimeError):
    """Injected kill inside the checkpoint write protocol (chaos only)."""


class QueryStalled(RuntimeError):
    """Injected death of a reader mid-capture (chaos only): a query holds
    no fleet state, so it must leave ingest unperturbed."""


class StreamInterrupted(RuntimeError):
    """ingest_stream died mid-stream — carries everything needed to resume.

    ``state``         — the sketch with every fully-applied chunk in it.
    ``items_applied`` — leading items of the original stream already
                        committed; re-feed the same stream with
                        ``skip_items=items_applied`` for a bit-exact resume.
    ``fleet``         — set by repro_torch.api.QuantileFleet: the fleet with
                        its cursor advanced past the committed items.
    """

    def __init__(self, message, *, state=None, fleet=None, items_applied=0):
        super().__init__(message)
        self.state = state
        self.fleet = fleet
        self.items_applied = int(items_applied)


@dataclasses.dataclass
class Fault:
    kind: str                      # 'stream'|'flip'|'ckpt_kill'|'ckpt_garble'|'drop_shard'|'query_stall'
    at: int = 1                    # 'stream'/'query_stall': event count; 'flip': absolute tick
    scope: str = "ingest"          # 'stream'/'query_stall': which event counter
    plane: int = 0                 # 'flip': plane-field index
    lane: int = 0                  # 'flip': lane index
    bit: int = 0                   # 'flip': bit 0..31 of the f32 plane word
    mode: str = "garble"           # 'ckpt_garble': 'garble' | 'truncate'
    phase: str = "after_leaves"    # 'ckpt_kill': protocol phase


class FaultPlan:
    """A deterministic set of faults; each fires at most once per arming."""

    def __init__(self, faults=(), seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed)
        self._fired = set()
        self._counts = {}

    # ------------------------------------------------------------ constructors
    @classmethod
    def stream_kill(cls, after_chunks: int, scope: str = "ingest") -> "FaultPlan":
        """Kill the stream after ``after_chunks`` fully-applied chunks."""
        return cls(faults=[Fault(kind="stream", at=int(after_chunks),
                                 scope=scope)])

    @classmethod
    def seeded_kill(cls, seed: int, n_chunks: int,
                    scope: str = "ingest") -> "FaultPlan":
        """One stream kill at a seeded chunk boundary in [1, n_chunks]: the
        same draw as the JAX package's plan for the same seed."""
        rng = np.random.default_rng(seed)
        at = int(rng.integers(1, max(1, int(n_chunks)) + 1))
        return cls(faults=[Fault(kind="stream", at=at, scope=scope)],
                   seed=seed)

    @classmethod
    def query_stall(cls, at: int, scope: str = "query") -> "FaultPlan":
        """Kill the ``at``-th snapshot capture mid-read (QueryStalled)."""
        return cls(faults=[Fault(kind="query_stall", at=int(at),
                                 scope=scope)])

    @classmethod
    def seeded_query_stall(cls, seed: int, n_queries: int,
                           scope: str = "query") -> "FaultPlan":
        """One mid-capture reader death at a seeded query index in
        [1, n_queries]."""
        rng = np.random.default_rng(seed)
        at = int(rng.integers(1, max(1, int(n_queries)) + 1))
        return cls(faults=[Fault(kind="query_stall", at=at, scope=scope)],
                   seed=seed)

    # ----------------------------------------------------------------- matching
    def fired(self) -> int:
        return len(self._fired)

    def _take(self, kind: str, **match) -> Optional[Fault]:
        for i, f in enumerate(self.faults):
            if i in self._fired or f.kind != kind:
                continue
            if any(getattr(f, k) != v for k, v in match.items()):
                continue
            self._fired.add(i)
            return f
        return None

    def _take_stream(self, scope: str) -> Optional[Fault]:
        n = self._counts.get(scope, 0) + 1
        self._counts[scope] = n
        return self._take("stream", scope=scope, at=n)

    def _take_query(self, scope: str) -> Optional[Fault]:
        # A tuple key keeps the query counter apart from the stream
        # counters even if a caller reuses a scope string.
        key = ("query_stall", scope)
        n = self._counts.get(key, 0) + 1
        self._counts[key] = n
        return self._take("query_stall", scope=scope, at=n)

    def _take_flips(self, t_lo: int, t_hi: int):
        out = []
        for i, f in enumerate(self.faults):
            if i not in self._fired and f.kind == "flip" \
                    and t_lo <= f.at < t_hi:
                self._fired.add(i)
                out.append(f)
        return out


_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def armed(plan: FaultPlan):
    """Install ``plan`` for the block (re-entrant: restores the previous)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


# ----------------------------------------------------------------------- hooks
def count_event(scope: str = "ingest") -> None:
    """Tick the armed plan's ``scope`` counter; raise StreamFault when a
    'stream' fault is scheduled at this count. No-op when disarmed."""
    if _ACTIVE is None:
        return
    f = _ACTIVE._take_stream(scope)
    if f is not None:
        raise StreamFault(
            f"injected stream fault: {scope} event {f.at} "
            f"(plan seed {_ACTIVE.seed})")


def on_query_event(scope: str = "query") -> None:
    """Tick the armed plan's query counter; raise QueryStalled when a
    'query_stall' fault is scheduled at this count. No-op when
    disarmed."""
    if _ACTIVE is None:
        return
    f = _ACTIVE._take_query(scope)
    if f is not None:
        raise QueryStalled(
            f"injected query stall: {scope} capture {f.at} "
            f"(plan seed {_ACTIVE.seed})")


def corrupt_sketch(sketch, t_lo: int, t_hi: int):
    """Apply the 'flip' faults whose tick lands in [t_lo, t_hi) to the
    sketch's planes, on the sketch's device: raw float32 bit flips, as a
    memory upset makes them. A flipped plane is cloned first, since
    functional fleets share tensors with the fleets they came from.
    Returns the sketch unchanged when disarmed or no flip is due."""
    if _ACTIVE is None:
        return sketch
    flips = _ACTIVE._take_flips(int(t_lo), int(t_hi))
    if not flips:
        return sketch
    import torch  # lazy: keep module-level imports numpy-only

    planes = list(sketch.planes())
    cloned = set()
    for f in flips:
        pi = f.plane % len(planes)
        if pi not in cloned:
            planes[pi] = planes[pi].clone()
            cloned.add(pi)
        raw = planes[pi].view(torch.int32)
        lane = f.lane % raw.shape[0]
        # The bit as a wrapped int32: bit 31 is -2**31.
        bit = int(np.uint32(1 << (f.bit % 32)).view(np.int32))
        raw[lane:lane + 1].bitwise_xor_(bit)
    return sketch.with_planes(tuple(planes))


def on_checkpoint_phase(phase: str) -> None:
    """Raise CheckpointKilled if a 'ckpt_kill' fault targets this phase."""
    if _ACTIVE is None:
        return
    if _ACTIVE._take("ckpt_kill", phase=phase) is not None:
        raise CheckpointKilled(f"injected kill at checkpoint phase {phase!r}")


def on_checkpoint_committed(step_dir: str) -> None:
    """Post-commit media rot: garble or truncate a leaf file of the
    just-committed step if a 'ckpt_garble' fault is armed."""
    if _ACTIVE is None:
        return
    f = _ACTIVE._take("ckpt_garble")
    if f is not None:
        corrupt_leaf_bytes(step_dir, mode=f.mode)


def on_restore_shard(shard_path: str) -> None:
    """Make the next shard read fail if a 'drop_shard' fault is armed."""
    if _ACTIVE is None:
        return
    if _ACTIVE._take("drop_shard") is not None:
        raise FileNotFoundError(f"injected shard drop: {shard_path}")


def corrupt_leaf_bytes(step_dir: str, mode: str = "garble") -> str:
    """Corrupt a committed step's shard file in place (usable directly from
    tests, without an armed plan). Three kinds of rot:
      'truncate' — halve the file (torn write; the zip container breaks);
      'garble'   — XOR 8 raw bytes ~60% in (the zip member's own CRC
                   breaks on read);
      'rewrite'  — flip one byte of leaf_0's data and re-write a valid npz
                   (only the format-4 manifest CRC32 catches this one).
    Returns the path touched."""
    shards = sorted(fn for fn in os.listdir(step_dir)
                    if fn.startswith("shard_") and fn.endswith(".npz"))
    if not shards:
        raise FileNotFoundError(f"no shard files under {step_dir}")
    path = os.path.join(step_dir, shards[0])
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "garble":
        off = max(0, int(size * 0.6) - 8)
        with open(path, "r+b") as f:
            f.seek(off)
            blob = f.read(8)
            f.seek(off)
            f.write(bytes(b ^ 0xFF for b in blob))
    elif mode == "rewrite":
        with np.load(path) as data:
            arrs = {k: data[k].copy() for k in data.files}
        for k in sorted(arrs):
            flat = arrs[k].reshape(-1).view(np.uint8)
            if flat.size:
                flat[flat.size // 2] ^= np.uint8(0x04)
                break
        with open(path, "wb") as f:
            np.savez(f, **arrs)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path
