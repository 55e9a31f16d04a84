"""The span recorder (``repro_torch.tracing``) and the spans of the dense
ingest path, on the CPU: off, spans are one shared no-op and nothing is
kept; on, the record's nesting, indices, counts and capacity; an ingest
with spans on gives the same bits as one with them off; and under
``torch.profiler`` each span, recorded or not, has a ``record_function``
twin, on the profiler's clock."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import FleetSpec, QuantileFleet

DENSE_SPANS = ("fleet.ingest_stream", "stream.next_block", "ops.update_auto",
               "ops.blocks", "ops.pack", "kernels.dense_launch",
               "ops.unpack")
G = 37


def fleet(program):
    quantiles = (0.5, 0.9, 0.99) if program == "2u" else (0.5,)
    spec = FleetSpec(num_groups=G, quantiles=quantiles, program=program,
                     backend="fused")
    return QuantileFleet.create(spec, init=0.0, seed=2 ** 31 + 7,
                                device="cpu")


def blocks():
    """Three blocks of 8-row calls: one aligned, one of 5 rows (staged),
    then 19 rows that fill the staged block, make one aligned call and
    leave a NaN-padded tail."""
    gen = torch.Generator().manual_seed(3)
    return [torch.randn(t, G, generator=gen) * 1e3 + 1e4 for t in (8, 5, 19)]


def planes(f):
    return [getattr(f.state, name).clone()
            for name in f.spec.program.layout.plane_fields]


def test_off_span_is_one_shared_no_op_and_keeps_nothing():
    assert tracing._record is None
    first = tracing.span("a")
    assert first is tracing.span("b") is tracing._OFF
    with first as got:
        assert got is None
    with tracing.recording() as rec:
        pass
    with tracing.span("after"):
        fleet("1u").ingest_stream(blocks(), chunk_t=8)
    assert rec.spans == [] and rec.counts == {} and rec.dropped == 0
    assert tracing._record is None


def test_on_spans_nest_with_parent_and_root_indices():
    with tracing.recording() as rec:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("b"):
                pass
        with tracing.span("d"):
            pass
    assert tracing.span("x") is tracing._OFF
    assert [(n, p, r) for n, p, r, _, _ in rec.spans] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("b", 0, 0), ("d", -1, 4)]
    assert rec.counts == {"a": 1, "b": 2, "c": 1, "d": 1}
    assert rec.dropped == 0
    for name, parent, _, t0, t1 in rec.spans:
        assert t0 <= t1
        if parent >= 0:
            assert rec.spans[parent][3] <= t0 and t1 <= rec.spans[parent][4]


def test_past_capacity_spans_count_but_are_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.recording() as rec:
        for _ in range(2):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
    assert [s[:3] for s in rec.spans] == [("outer", -1, 0),
                                          ("inner", 0, 0),
                                          ("outer", -1, 2)]
    assert rec.counts == {"outer": 2, "inner": 2}
    assert rec.dropped == 1


@pytest.mark.parametrize("capacity", range(1, 9))
def test_a_kept_span_keeps_its_parent_and_root(capacity, monkeypatch):
    """Wherever the capacity cuts a tree of spans, every kept span's parent
    and root are kept spans, and only an outermost span has no parent."""
    monkeypatch.setattr(tracing, "CAPACITY", capacity)
    with tracing.recording() as rec:
        for _ in range(2):
            with tracing.span("root"):
                with tracing.span("a"):
                    with tracing.span("b"):
                        pass
                with tracing.span("c"):
                    pass
    assert len(rec.spans) == capacity
    assert len(rec.spans) + rec.dropped == 8
    for i, (name, parent, root, _, _) in enumerate(rec.spans):
        assert (parent == -1) == (name == "root")
        assert parent < i and 0 <= root <= i
        assert rec.spans[root][0] == "root" and rec.spans[root][1] == -1
        if parent >= 0:
            assert rec.spans[parent][2] == root


def test_a_span_left_by_an_exception_is_recorded_and_popped():
    with tracing.recording() as rec:
        with pytest.raises(KeyError):
            with tracing.span("a"):
                with tracing.span("b"):
                    raise KeyError("x")
        with tracing.span("c"):
            pass
    assert [s[:3] for s in rec.spans] == [("a", -1, 0), ("b", 0, 0),
                                          ("c", -1, 2)]


def test_recordings_do_not_nest():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert tracing._record is None


def test_threads_keep_their_own_stacks_and_lose_no_count():
    """More threads than cores, a short switch interval: each thread's
    spans nest under its own outer span, and every entry is counted."""
    threads, rounds = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work(k):
                for _ in range(rounds):
                    with tracing.span(f"t{k}"):
                        with tracing.span(f"t{k}.inner"):
                            pass
            pool = [threading.Thread(target=work, args=(k,))
                    for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert len(rec.spans) == 2 * threads * rounds
    assert sum(rec.counts.values()) == 2 * threads * rounds
    for name, parent, root, _, _ in rec.spans:
        if name.endswith(".inner"):
            assert rec.spans[parent][0] == name[:-len(".inner")]
            assert root == parent
        else:
            assert parent == -1 and rec.spans[root][0] == name


@pytest.mark.parametrize("program", ["2u", "1u"])
def test_an_ingest_gives_the_same_bits_with_spans_on(program):
    start = fleet(program)
    off = start.ingest_stream(blocks(), chunk_t=8)
    with tracing.recording() as rec:
        on = start.ingest_stream(blocks(), chunk_t=8)
    for a, b in zip(planes(off), planes(on)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert off.cursor == on.cursor
    assert int(on.cursor.t_offset) == 32
    calls = 4   # 8 | 5 + 3 | 8 | 8, the last with 4 NaN-padded rows
    assert rec.counts == {"fleet.ingest_stream": 1,
                          "stream.next_block": calls + 1,
                          "ops.update_auto": calls, "ops.blocks": calls,
                          "ops.pack": calls, "kernels.dense_launch": calls,
                          "ops.unpack": calls}
    assert all(s[2] == 0 for s in rec.spans)


def test_the_dense_path_spans_nest_and_their_self_times_add_up():
    with tracing.recording() as rec:
        fleet("2u").ingest_stream(blocks(), chunk_t=8)
    spans = rec.spans
    assert {s[0] for s in spans} == set(DENSE_SPANS)
    parent_of = {"stream.next_block": "fleet.ingest_stream",
                 "ops.update_auto": "fleet.ingest_stream",
                 "ops.blocks": "ops.update_auto",
                 "ops.pack": "ops.update_auto",
                 "kernels.dense_launch": "ops.update_auto",
                 "ops.unpack": "ops.update_auto"}
    child_ns = [0] * len(spans)
    for name, parent, _, t0, t1 in spans:
        if name == "fleet.ingest_stream":
            assert parent == -1
            continue
        assert spans[parent][0] == parent_of[name]
        assert spans[parent][3] <= t0 <= t1 <= spans[parent][4]
        child_ns[parent] += t1 - t0
    self_ns = [t1 - t0 - c for (_, _, _, t0, t1), c in zip(spans, child_ns)]
    assert min(self_ns) >= 0
    root = spans[0]
    assert sum(self_ns) == root[4] - root[3]


def test_each_span_has_a_profiler_twin_on_the_profilers_clock():
    """Both stamp Unix nanoseconds. A process's first
    ``record_function`` sets itself up between its own stamp and the
    span's, which puts that one pair up to a millisecond apart; a first
    profiled ingest warms it."""
    from torch.profiler import ProfilerActivity, profile

    with tracing.recording():
        with profile(activities=[ProfilerActivity.CPU]):
            fleet("1u").ingest_stream(blocks()[:1], chunk_t=8)
    with tracing.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fleet("2u").ingest_stream(blocks(), chunk_t=8)
    twins = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in DENSE_SPANS:
            twins.setdefault(e.name(), []).append(e.start_ns())
    mine = {}
    for name, _, _, t0, _ in rec.spans:
        mine.setdefault(name, []).append(t0)
    assert set(twins) == set(mine) == set(DENSE_SPANS)
    for name, starts in mine.items():
        assert len(twins[name]) == len(starts), name
        gaps = np.abs(np.array(sorted(twins[name])) - np.array(starts))
        assert gaps.max() < 200_000, (name, gaps)


def test_off_spans_still_mark_a_running_profiler():
    """Not recording, each span of the dense path still opens a
    ``record_function`` while a profiler runs, so a profiled window names
    the program's layers; with the profiler stopped, spans are the shared
    no-op again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("a") is not tracing._OFF
        fleet("2u").ingest_stream(blocks(), chunk_t=8)
    assert tracing._record is None and tracing.span("a") is tracing._OFF
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in DENSE_SPANS:
            seen[e.name()] = seen.get(e.name(), 0) + 1
    calls = 4
    assert seen == {"fleet.ingest_stream": 1,
                    "stream.next_block": calls + 1,
                    "ops.update_auto": calls, "ops.blocks": calls,
                    "ops.pack": calls, "kernels.dense_launch": calls,
                    "ops.unpack": calls}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_tracing.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["2u", "1u"])
def test_on_the_card_spans_change_no_bit_and_count_each_launch(program,
                                                                card):
    from repro_torch.kernels import frugal_update as fk

    quantiles = (0.5, 0.9, 0.99) if program == "2u" else (0.5,)
    spec = FleetSpec(num_groups=4099, quantiles=quantiles, program=program,
                     backend="fused")
    start = QuantileFleet.create(spec, init=0.0, seed=2 ** 31 + 7,
                                 device=card)
    gen = torch.Generator(device=card).manual_seed(3)
    chunks = [torch.randn(t, 4099, generator=gen, device=card) * 1e3 + 1e4
              for t in (64, 40, 152)]
    off = start.ingest_stream(chunks, chunk_t=64)
    before = fk.launch_count
    with tracing.recording() as rec:
        on = start.ingest_stream(chunks, chunk_t=64)
    torch.cuda.synchronize()
    assert rec.counts["kernels.dense_launch"] == fk.launch_count - before == 4
    for a, b in zip(planes(off), planes(on)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert off.cursor == on.cursor
