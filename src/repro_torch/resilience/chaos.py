"""The fault-injection hooks that streaming ingest calls, and the stream
error types.

In the JAX package these hooks fire faults from an armed ``FaultPlan``.
The port has no fault plans yet, so the hooks are the disarmed no-ops;
``StreamInterrupted`` keeps its resumable meaning: ingest that dies
mid-stream reports how far it got.
"""
from __future__ import annotations


class StreamFault(RuntimeError):
    """A transient stream-source failure; ingest_stream surfaces it
    wrapped in a resumable StreamInterrupted."""


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


def count_event(scope: str = "ingest") -> None:
    """Count one fully-applied chunk (no fault plan to fire: a no-op)."""


def corrupt_sketch(sketch, t_lo: int, t_hi: int):
    """Apply due bit-flip faults to ``sketch`` (none: returns it as is)."""
    return sketch
