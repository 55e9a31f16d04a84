"""Dense GROUPBY ingest: each batch is one [rows, G] block of items, one
item a group and row, handed to ``QuantileFleet.ingest_stream`` as a
one-block stream in ``rows``-row kernel calls.

The check. The fleet is functional: every call returns a new fleet and
leaves the old one's tensors as they were, so the fleet before the last
batch of the window is kept at no cost. After the window the reference
applies, over all lanes, (a) the first batch of the set-up to the
paper's initial state and (b) the window's last batch to the fleet's own
state before it, each compared bit for bit with what the fleet returned;
the estimates of ``estimate()`` are compared with the reference's query
of (b), and the fleet's stream cursor with the ticks handed in.

What every kind declares beside its ``Driver``, which the harness and its
tests (``test_portbench_harness.py``) take from the cell's kind:
``CPU_SIZE``, the keys of the configuration and mix that a CPU run
overrides, and ``CPU_SIZE_CONTROL``, those the control's run overrides on
top; ``FAULTS``, faults planted under the kind's own timed path as
(module of ``repro_torch``, function, wrapper of the function), each of
which must read ``correct`` false; ``LAUNCHES_PER_BATCH``, the kernel
launches a batch makes; ``COUNTERS``, the program counters (module,
attribute) whose change over a traced run's recorded window the metric
readers get (``harness.Window.counters``). Dense: 37 groups (the
control 2,000: bfloat16 differs from float32 mostly where a coin lands
within its rounding of the target, so it needs some thousands of lanes
to show every time), 8 rows, a ring of 2 and 2 warm-up batches; a chunk
applied as no step, half of each chunk left out, and one estimate
altered where the entry point returns it; one launch a batch; no program
counter beyond the launch counts, which the harness reads for every kind.
"""
from __future__ import annotations

import torch

from portbench import reference, traffic

CPU_SIZE = {"config": {"num_groups": 37},
            "mix": {"rows": 8, "ring": 2, "warmup_batches": 2}}
CPU_SIZE_CONTROL = {"config": {"num_groups": 2000}}
LAUNCHES_PER_BATCH = 1
COUNTERS = ()


def _unchanged(orig):
    return lambda sk, chunk, *a, **k: sk


def _half(orig):
    return lambda sk, chunk, *a, **k: orig(sk, chunk[:chunk.shape[0] // 2],
                                           *a, **k)


def _altered(orig):
    def f(*a, **k):
        planes = orig(*a, **k)
        planes[0][0] += 1.0
        return planes
    return f


FAULTS = {"unchanged": ("core.streaming", "_apply_chunk", _unchanged),
          "half": ("core.streaming", "_apply_chunk", _half),
          "altered": ("kernels.ops", "frugal_update_auto", _altered)}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.config, ctx.mix
        self.groups = int(cfg["num_groups"])
        self.quantiles = tuple(float(q) for q in cfg["quantiles"])
        self.rows = int(mix["rows"])
        self.items_per_batch = self.rows * self.groups
        self.prog = reference.load_program(cfg["program"])
        self.n = 0                      # batches handed to the fleet

    def setup(self):
        from repro_torch.api import FleetSpec, QuantileFleet

        ctx, cfg = self.ctx, self.ctx.config
        spec = FleetSpec(num_groups=self.groups, quantiles=self.quantiles,
                         program=cfg["program"], backend=cfg["backend"])
        self.fleet = QuantileFleet.create(spec, init=float(cfg["init"]),
                                          seed=ctx.fleet_seed,
                                          device=ctx.device)
        self.ring = traffic.dense_ring(ctx.mix, self.groups, ctx.gen,
                                       ctx.device)
        self.prev = self.first = None
        for _ in range(int(ctx.mix["warmup_batches"])):
            self.submit()
            if self.first is None:
                self.first = self.fleet

    def submit(self):
        block = self.ring[self.n % len(self.ring)]
        self.prev = self.fleet
        self.fleet = self.fleet.ingest_stream((block,), chunk_t=self.rows)
        self.n += 1

    def work(self) -> dict:
        """What each batch asks of the kernels: one dense call of
        [rows, G] items into Q lanes a group."""
        return {"dense_call": (self.rows, self.groups, len(self.quantiles))}

    def _planes(self, fleet):
        return tuple(getattr(fleet.state, f) for f in self.prog.PLANES)

    def check(self, control: bool) -> dict:
        ctx, prog = self.ctx, self.prog
        seed, qs = ctx.fleet_seed, self.quantiles
        nq = len(qs)
        ring = self.ring
        init = prog.init(torch.empty(self.groups * nq, device=ctx.device),
                         float(ctx.config["init"]))
        last = self.n - 1
        t_last = last * self.rows
        start = self._planes(self.prev)

        def step(planes, block, t0, dtype=torch.float32):
            return reference.dense(prog, planes, block, t0, seed, qs,
                                   dtype=dtype)

        want_first = step(init, ring[0], 0)
        want_last = step(start, ring[last % len(ring)], t_last)
        if control:
            low = reference.CONTROL_DTYPE
            got_first = step(init, ring[0], 0, low)
            got_last = step(start, ring[last % len(ring)], t_last, low)
            got_est = prog.query(got_last).reshape(self.groups, nq)
            cursor = self.n * self.rows
        else:
            got_first = self._planes(self.first)
            got_last = self._planes(self.fleet)
            got_est = self.fleet.estimate()
            cursor = int(self.fleet.cursor.t_offset)
        want_est = prog.query(want_last).reshape(self.groups, nq)
        est_differ = reference.lanes_differ((got_est.reshape(-1),),
                                            (want_est.reshape(-1),))
        return {
            "first_lanes_differ": (reference.lanes_differ(got_first,
                                                          want_first), 0),
            "last_lanes_differ": (reference.lanes_differ(got_last,
                                                         want_last), 0),
            "estimates_differ": (est_differ, 0),
            "cursor_ticks_gap": (abs(cursor - self.n * self.rows), 0),
        }
