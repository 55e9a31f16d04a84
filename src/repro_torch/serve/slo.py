"""SLOFleet — per-route serving SLO quantiles on the fleet facade.

Port of the JAX package's ``serve/slo.py``. A route table and an event
buffer over one per-lane-clock ``repro_torch.api.QuantileFleet``: routes
are the fleet's groups and the metric column is its quantile lane, so
lane = route_idx · n_metrics + metric_idx. Each lane keeps its own tick
and draws ``counter_uniform(seed, tick, lane)``, so a lane's k-th event
consumes the same uniform however events are batched, and the trajectory
equals the paper's scalar Algorithm 3 run per lane.

Events are buffered on the host (``observe``); ``flush`` sorts them by
lane, stably, and applies them: above ``DENSE_LANES_MAX`` lanes through
one ``tick_lanes_sparse(donate=True)`` call, one launch of the run kernel
per flush, O(events) work; at most that many, as rounds (a lane's r-th
buffered event goes to round r), each through ``tick_lanes`` over the
whole fleet.

Memory: 2 sketch words per (route × metric) lane (m and the packed
(step, sign) word), plus one int32 clock per lane. A 10^6-route
deployment with 3 metrics holds 24 MB of sketch state; the port keeps the
three planes unpacked on the device (36 MB) and the clock (12 MB).
Checkpoints (``checkpoint_state`` through ``train.checkpoint``) store the
two words and the clock, the JAX package's layout leaf for leaf.

``check_health`` scans every lane under ``health_policy``
(``resilience.health``); ``snapshot`` is a ``service.snapshot.Snapshot``
of the route fleet, host copies pinned to one cursor.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.fleet import QuantileFleet
from repro_torch.api.spec import FleetSpec, StreamCursor
from repro_torch.configs.platform import resolve_device
from repro_torch.core.frugal import Frugal2UState
from repro_torch.core.program import make_program
from repro_torch.core.sketch import GroupedQuantileSketch
from repro_torch.train.checkpoint import LeafSpec

# (metric name, target quantile) — the serving SLO trio.
DEFAULT_METRICS: Tuple[Tuple[str, float], ...] = (
    ("ttft_q99_ms", 0.99),
    ("tok_q50_ms", 0.5),
    ("len_q50", 0.5),
)


class SLOFleet:
    """Routes × metrics frugal lanes with buffered vectorized updates.

    ``windowed=True`` runs every lane on the decayed Frugal-2U program
    (``2u-decay``): step inertia decays with half-life ``decay_half_life``
    events, so the sketch tracks recent latency. ``health_policy``
    (default "quarantine") is the lane-corruption policy of
    ``check_health``, which accumulates ``quarantined_total`` and keeps
    ``last_health``. ``telemetry`` is any object with ``.count(name, n)``;
    it receives ``slo_events_flushed``, ``slo_flushes`` and
    ``quarantined_lanes``. The fleet's tensors live on ``device`` (None:
    the card; raises where there is none).
    """

    # Up to this many lanes a flush round ticks the whole [C] state (one
    # vectorized op); above it, a flush gathers and scatters only the event
    # lanes, so a few observations against 10^6 routes never do O(C) work.
    DENSE_LANES_MAX = 4096

    def __init__(self, metrics: Sequence[Tuple[str, float]] = DEFAULT_METRICS,
                 seed: int = 0, capacity: int = 64, windowed: bool = False,
                 decay_half_life: int = 4096,
                 health_policy: str = "quarantine", telemetry=None,
                 device=None):
        if not metrics:
            raise ValueError("need at least one (name, quantile) metric")
        self.telemetry = telemetry
        self.metrics = tuple((str(n), float(q)) for n, q in metrics)
        self.n_metrics = len(self.metrics)
        self._metric_idx = {n: i for i, (n, _) in enumerate(self.metrics)}
        if len(self._metric_idx) != self.n_metrics:
            raise ValueError(f"duplicate metric names in {metrics}")
        self.seed = int(seed)
        self.windowed = bool(windowed)
        self.decay_half_life = int(decay_half_life)
        self.health_policy = str(health_policy)
        self.quarantined_total = 0
        self.last_health = None
        self.device = resolve_device(device)
        self._routes: Dict[str, int] = {}
        self._pending: List[Tuple[int, float]] = []
        self._fleet = QuantileFleet.create(
            self._spec(max(1, int(capacity))), seed=self.seed,
            per_lane_clock=True, device=self.device)

    def _spec(self, cap_routes: int) -> FleetSpec:
        """Fleet spec for ``cap_routes`` route groups, one quantile lane per
        metric (route-major, metric-minor), on the '2u-decay' or '2u'
        program."""
        program = make_program("2u-decay", half_life=self.decay_half_life) \
            if self.windowed else "2u"
        return FleetSpec(num_groups=cap_routes,
                         quantiles=tuple(q for _, q in self.metrics),
                         program=program, health=self.health_policy)

    # ------------------------------------------------ fleet state, projected
    @property
    def _cap_routes(self) -> int:
        return self._fleet.num_groups

    @property
    def _m(self) -> torch.Tensor:
        return self._fleet.state.m

    @property
    def _step(self) -> torch.Tensor:
        return self._fleet.state.step

    @property
    def _sign(self) -> torch.Tensor:
        return self._fleet.state.sign

    @property
    def _ticks(self) -> torch.Tensor:
        return self._fleet.cursor.t_offset

    def _grow(self, min_routes: int):
        """Double route capacity until ``min_routes`` fit. Lane ids do not
        depend on capacity, so growth appends lanes without touching any
        existing lane's state or uniform stream."""
        new_cap = self._cap_routes
        while new_cap < min_routes:
            new_cap *= 2
        self._fleet = self._fleet.grow_groups(new_cap)

    # --------------------------------------------------------------- routes
    @property
    def num_routes(self) -> int:
        return len(self._routes)

    @property
    def num_lanes(self) -> int:
        return self.num_routes * self.n_metrics

    def routes(self) -> List[str]:
        return sorted(self._routes, key=self._routes.get)

    def ensure_route(self, route: str) -> int:
        idx = self._routes.get(route)
        if idx is None:
            idx = len(self._routes)
            self._routes[route] = idx
            if idx + 1 > self._cap_routes:
                self._grow(idx + 1)
        return idx

    def ensure_routes(self, routes: Iterable[str]):
        """Bulk registration (deployments register routes up front; one
        Python-level ensure per route would dominate at 10^6)."""
        seen = self._routes
        new = dict.fromkeys(r for r in routes if r not in seen)
        base = len(seen)
        for i, r in enumerate(new):
            seen[r] = base + i
        if seen and len(seen) > self._cap_routes:
            self._grow(len(seen))

    def lane(self, route: str, metric: str) -> int:
        # The metric first: a mistyped metric raises before the route is
        # registered.
        mi = self._metric_idx[metric]
        return self.ensure_route(route) * self.n_metrics + mi

    # --------------------------------------------------------------- events
    def observe(self, route: str, metric: str, value: float):
        """Buffer one observation; no device work until ``flush``."""
        self._pending.append((self.lane(route, metric), float(value)))

    def flush(self):
        """Apply the buffered events. A stable sort by lane keeps each
        lane's events in arrival order, so each consumes its own tick's
        uniform. Above ``DENSE_LANES_MAX`` lanes the sorted events go to the
        card in one ``tick_lanes_sparse`` call, one launch of the run kernel
        (each lane's events are one run); at most that many, a lane's r-th
        event goes to round r (position minus run start) and each round
        ticks the whole fleet. Every event advances its lane's clock, a NaN
        value too. The two branches give the same trajectory."""
        if not self._pending:
            return
        events, self._pending = self._pending, []
        n = len(events)
        if self.telemetry is not None:
            self.telemetry.count("slo_events_flushed", n)
            self.telemetry.count("slo_flushes")
        lanes = np.fromiter((l for l, _ in events), np.int64, n)
        vals = np.fromiter((v for _, v in events), np.float32, n)
        order = np.argsort(lanes, kind="stable")
        sorted_lanes = lanes[order]
        c = self._cap_routes * self.n_metrics
        if c > self.DENSE_LANES_MAX:
            # In place (donate=True): the pre-flush fleet is dead once the
            # events apply.
            dev = self.device
            self._fleet = self._fleet.tick_lanes_sparse(
                torch.from_numpy(sorted_lanes.astype(np.int32)).to(dev),
                torch.from_numpy(vals[order]).to(dev),
                torch.ones(n, dtype=torch.int32, device=dev), donate=True)
            return
        run_start = np.zeros(n, np.int64)
        if n > 1:
            new_run = np.r_[True, sorted_lanes[1:] != sorted_lanes[:-1]]
            starts = np.flatnonzero(new_run)
            run_start = np.repeat(starts, np.diff(np.r_[starts, n]))
        round_of = np.empty(n, np.int64)
        round_of[order] = np.arange(n) - run_start
        n_rounds = int(round_of.max()) + 1
        items = np.full((n_rounds, c), np.nan, np.float32)
        occ = np.zeros((n_rounds, c), np.int32)
        items[round_of, lanes] = vals
        occ[round_of, lanes] = 1
        items_d = torch.from_numpy(items).to(self.device)
        occ_d = torch.from_numpy(occ).to(self.device)
        for r in range(n_rounds):
            self._fleet = self._fleet.tick_lanes(items_d[r], occ_d[r])

    # ---------------------------------------------------------------- reads
    def estimate(self, route: str, metric: str) -> float:
        """Raises KeyError for an unregistered route (reads never
        register)."""
        self.flush()
        lane = self._routes[route] * self.n_metrics + self._metric_idx[metric]
        return float(self._m[lane])

    def summary(self, route: str) -> Dict[str, float]:
        self.flush()
        base = self._routes[route] * self.n_metrics
        m = self._m[base:base + self.n_metrics].cpu().numpy()
        return {name: float(m[i]) for i, (name, _) in enumerate(self.metrics)}

    def summaries(self) -> Dict[str, Dict[str, float]]:
        self.flush()
        m = self._m.cpu().numpy()
        out = {}
        for route, idx in self._routes.items():
            base = idx * self.n_metrics
            out[route] = {name: float(m[base + i])
                          for i, (name, _) in enumerate(self.metrics)}
        return out

    def snapshot(self):
        """Consistent copy-on-query capture of the whole route fleet, a
        ``repro_torch.service.Snapshot`` (host copies of the query plane
        and the per-lane clock, pending events flushed first): the read
        path dashboards should prefer, because the answer is pinned to one
        cursor and auditable offline, and later (donated) flushes leave it
        as it was. Imported here: service composes serve-side pieces,
        never the reverse at module level."""
        self.flush()
        from repro_torch.service.snapshot import Snapshot
        return Snapshot.capture(self._fleet, telemetry=self.telemetry)

    def check_health(self):
        """Flush pending events, then scan every lane against its program's
        declared invariants under ``health_policy``: "quarantine" resets
        corrupt lanes (bit-exact with a lane created at its current tick),
        "raise" throws LaneCorruptionError, "ignore" only reports. Returns
        the HealthReport."""
        self.flush()
        fleet, rep = self._fleet.check_health()
        self._fleet = fleet
        self.quarantined_total += rep.quarantined
        self.last_health = rep
        if self.telemetry is not None and rep.quarantined:
            self.telemetry.count("quarantined_lanes", rep.quarantined)
        return rep

    def memory_words(self) -> int:
        """Persistent sketch words per (route × metric) lane: 2, as in the
        paper (the per-lane clock word comes on top)."""
        return self._fleet.memory_words()

    def state_words(self) -> int:
        """Persistent sketch words of the registered routes (without the
        per-lane clock)."""
        return self.memory_words() * self.num_lanes

    # -------------------------------------------------------- serialization
    def checkpoint_state(self) -> dict:
        """Tree for ``train.checkpoint.save_checkpoint`` (pending events
        flushed first): ``sketch`` (a Frugal2UState, stored as 2 words per
        lane), ``ticks`` (the per-lane clock) and ``meta_blob`` (the route
        table, metrics and settings as uint8 JSON). The per-lane quantiles
        are not stored: they tile the metrics list. The planes and clock
        are the fleet's own tensors, which the next flush updates in
        place: save (or copy) them before the fleet ingests again."""
        self.flush()
        meta = {"routes": self.routes(), "metrics": list(self.metrics),
                "seed": self.seed, "windowed": self.windowed,
                "decay_half_life": self.decay_half_life,
                "health_policy": self.health_policy}
        blob = np.frombuffer(json.dumps(meta).encode("utf-8"),
                             np.uint8).copy()
        return {"sketch": Frugal2UState(m=self._m, step=self._step,
                                        sign=self._sign),
                "ticks": self._ticks, "meta_blob": blob}

    def checkpoint_template(self) -> dict:
        """Structure-only ``like`` tree for ``restore_checkpoint``: no
        flush, no allocation; stored shapes win, so it restores any
        capacity."""
        c = self._cap_routes * self.n_metrics
        f32 = LeafSpec((c,), np.float32)
        return {"sketch": Frugal2UState(m=f32, step=f32, sign=f32),
                "ticks": LeafSpec((c,), np.int32),
                "meta_blob": LeafSpec((0,), np.uint8)}

    @classmethod
    def from_checkpoint_state(cls, state: dict, telemetry=None,
                              device=None) -> "SLOFleet":
        """A fleet on ``device`` (None: the card; raises where there is
        none) from a ``checkpoint_state()`` tree of either package: a
        restored checkpoint, or numpy leaves (anything ``np.asarray``
        takes). The tensors are copies; the tree is left as it was."""
        meta = json.loads(bytes(_host(state["meta_blob"]).astype(
            np.uint8)).decode("utf-8"))
        fleet = cls(metrics=[tuple(mq) for mq in meta["metrics"]],
                    seed=int(meta["seed"]), capacity=1,
                    windowed=bool(meta.get("windowed", False)),
                    decay_half_life=int(meta.get("decay_half_life", 4096)),
                    health_policy=str(meta.get("health_policy",
                                               "quarantine")),
                    telemetry=telemetry, device=device)
        sk = state["sketch"]
        n, ticks = np.shape(sk.m)[0], state["ticks"]
        if n % fleet.n_metrics or tuple(np.shape(ticks)) != (n,):
            raise ValueError(f"{n} lanes and {tuple(np.shape(ticks))} "
                             f"clocks do not tile {fleet.n_metrics} metrics")
        spec = fleet._spec(n // fleet.n_metrics)

        def owned(x, dtype=torch.float32):
            if isinstance(x, torch.Tensor):
                return x.to(device=fleet.device, dtype=dtype, copy=True)
            return torch.from_numpy(np.array(x)).to(device=fleet.device,
                                                    dtype=dtype)

        lane_sk = GroupedQuantileSketch(
            m=owned(sk.m), step=owned(sk.step), sign=owned(sk.sign),
            quantile=owned(spec.lane_quantiles()), algo="2u",
            drift=spec.drift)
        cursor = StreamCursor.create(seed=meta["seed"],
                                     t_offset=owned(ticks, torch.int32))
        fleet._fleet = QuantileFleet(state=lane_sk, cursor=cursor, spec=spec)
        fleet._routes = {r: i for i, r in enumerate(meta["routes"])}
        return fleet

    # ------------------------------------------------------- carry across
    def to_numpy_state(self) -> dict:
        """``checkpoint_state()`` with numpy leaves, the layout the JAX
        package's ``SLOFleet.from_checkpoint_state`` takes as it is."""
        st = self.checkpoint_state()
        return {"sketch": Frugal2UState(*(_host(p) for p in st["sketch"])),
                "ticks": _host(st["ticks"]), "meta_blob": st["meta_blob"]}


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
