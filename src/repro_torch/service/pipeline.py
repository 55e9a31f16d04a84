"""Async host→device ingest: put-ahead chunk staging over the fleet.

Port of the JAX package's ``service/pipeline.py``. Three stages,
overlapped two-deep:

  stage 0  SOURCE  — the caller's chunk iterator draws or receives the
                     next [t, G] host block (network read, RNG draw, ...);
  stage 1  STAGE   — a put-ahead thread (``data.pipeline.
                     prefetch_to_device``, the same primitive the train
                     loop uses) pins the block and copies it to the
                     fleet's device on a side CUDA stream while the
                     previous chunk computes;
  stage 2  APPLY   — the ingest thread runs ``fleet.ingest(chunk)`` (one
                     dense kernel launch per ``chunk_t`` rows) and waits
                     for it, which is the pipeline's backpressure: at most
                     ``depth`` staged chunks + one in compute are alive, so
                     host and device memory stay bounded however fast the
                     source is.

The wait is an event recorded on the current stream after the ingest and
synchronized: it waits for this chunk's apply only (not for the staging
stream, which is already copying the next chunk), and it releases the
GIL, so readers run meanwhile. Each applied chunk yields a NEW fleet
(functional ingest); ``on_chunk`` is where the server publishes that
version for readers. Blocking per chunk gives honest per-chunk latency
numbers and a real publication point: an unbounded launch queue would
publish fleets whose device work has not happened yet.

Telemetry (optional, duck-typed): items/chunks counters, a
chunks-in-flight gauge, and per-chunk apply latency into the
``ingest_chunk_ms`` histogram.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.api.fleet import QuantileFleet
from repro_torch.data.pipeline import device_transfer, prefetch_to_device

# IngestPipeline's default transfer: stage onto the fleet's own device.
_ON_FLEET_DEVICE = object()


def _block_on(fleet: QuantileFleet) -> None:
    """Wait for the fleet's device work issued so far on this thread's
    current stream (publication barrier); nothing to wait for on the
    CPU."""
    if fleet.device.type != "cuda":
        return
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(fleet.device))
    done.synchronize()


class IngestPipeline:
    """Double-buffered host→device chunk ingest over one QuantileFleet.

    ``depth`` is the put-ahead queue bound (1 = double buffering; 0 stages
    each chunk on the ingest thread). ``transfer`` maps a host chunk to
    its device form; by default ``data.pipeline.device_transfer`` onto
    the fleet's device (a pinned copy on a side stream on the card).
    ``transfer=None`` disables staging: chunks pass through as they are
    (useful when the source already yields device tensors).
    """

    def __init__(self, depth: int = 1, telemetry=None,
                 transfer: Optional[Callable] = _ON_FLEET_DEVICE):
        self.depth = int(depth)
        self.telemetry = telemetry
        self._transfer = transfer

    def run(self, fleet: QuantileFleet, chunks: Iterable,
            on_chunk: Optional[Callable] = None) -> QuantileFleet:
        """Drive ``chunks`` ([t, G] blocks) through ``fleet``; returns the
        final fleet. ``on_chunk(new_fleet, n_items)`` fires after each
        chunk's device work completes: the server's publication hook."""
        tel = self.telemetry
        # in-flight = staged but not yet applied; the staging thread
        # increments (inside `transfer`), the apply loop decrements, so
        # the gauge tracks the put-ahead occupancy 0..depth+1.
        in_flight = [0]
        lock = threading.Lock()

        def bump(d: int):
            with lock:
                in_flight[0] += d
                tel.gauge("chunks_in_flight", in_flight[0])

        if self._transfer is None:
            staged = iter(chunks)
        else:
            base = self._transfer
            if base is _ON_FLEET_DEVICE:
                base = device_transfer(fleet.device)

            def transfer(x):
                y = base(x)
                if tel is not None:
                    bump(+1)
                return y

            staged = prefetch_to_device(iter(chunks), depth=self.depth,
                                        transfer=transfer)
        for chunk in staged:
            t0 = time.perf_counter()
            n = int(np.shape(chunk)[0])
            fleet = fleet.ingest(chunk)
            _block_on(fleet)
            if tel is not None:
                tel.observe_ms("ingest_chunk_ms",
                               (time.perf_counter() - t0) * 1e3)
                tel.count("items_ingested", n)
                tel.count("chunks_ingested")
                if self._transfer is not None:
                    bump(-1)
            if on_chunk is not None:
                on_chunk(fleet, n)
        return fleet
