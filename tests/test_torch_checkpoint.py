"""The port's format-4 checkpoints against the JAX package's.

* CPU: the write protocol and restore (a kill at each phase, post-commit
  rot by truncation, garbling and a silent rewrite, a dropped shard, a
  pinned corrupt step, keep-k collection, an idempotent re-save, format-3
  restore, template mismatches); checkpoints crossing the packages both
  ways for all six lane programs, a per-lane-clock fleet and the SLO
  fleet, each continued bit-identically, with manifests equal key by key
  (``treedef`` included) and equal CRC32 lists; the committed JAX checkpoints
  of ``tests/data/jax_checkpoints`` and their golden continuations.
* Card (marker ``cuda``, skipped without a CUDA device): the committed JAX
  checkpoints restored on the card and continued through the dense and run
  kernels, and a port checkpoint written from the card restored on the
  card and continued as the CPU does.

Tolerance everywhere: bit-exact (float32 compared as int32 bit patterns).
JAX is imported inside the CPU tests: the card tests run where JAX is not
installed (``--noconftest``, see README.md).
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import FleetSpec, QuantileFleet
from repro_torch.core import program as tprogram
from repro_torch.resilience import CheckpointKilled, Fault, FaultPlan, chaos
from repro_torch.serve import DEFAULT_METRICS, SLOFleet
from repro_torch.train import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

PROGS = tprogram.test_instances()
IDS = [p.family for p in PROGS]
G, QS, T, SEED = 5, (0.5, 0.9), 160, 9
METRICS = [m for m, _ in DEFAULT_METRICS]


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def data(seed=4, t=T):
    items = np.random.default_rng(seed).lognormal(3.0, 1.0, (t, G))
    return items.astype(np.float32)


def spec(prog="2u", **kw):
    return FleetSpec(num_groups=G, quantiles=QS, chunk_t=64, program=prog,
                     **kw)


def planes_of(fleet):
    sk = fleet.state if isinstance(fleet, QuantileFleet) \
        else fleet._lane_sketch()
    return [bits(p) for p in sk.planes()]


def cursor_of(fleet):
    cur = fleet.cursor
    t = cur.t_offset
    t = bits(t) if np.ndim(t) else int(t)
    return int(cur.seed), t, int(cur.g_offset)


def assert_same(a, b, what=""):
    for i, (x, y) in enumerate(zip(planes_of(a), planes_of(b))):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: plane {i}")
    ca, cb = cursor_of(a), cursor_of(b)
    assert ca[0] == cb[0] and ca[2] == cb[2], what
    np.testing.assert_array_equal(ca[1], cb[1], err_msg=f"{what}: cursor")


def two_steps(tmp_path, sp=None):
    d = str(tmp_path / "ck")
    sp = sp or spec()
    f1 = QuantileFleet.create(sp, seed=1, device="cpu").ingest(data())
    f1.checkpoint(d, step=1)
    f2 = f1.ingest(data(5))
    f2.checkpoint(d, step=2)
    return d, f1, f2


# ---------------------------------------------------------------- protocol
@pytest.mark.parametrize("mode", ("truncate", "garble", "rewrite"))
def test_corrupt_newest_step_falls_back_and_quarantines(tmp_path, mode):
    """Rot on the newest step: restore quarantines it and falls back to
    step 1 ('rewrite' leaves a valid npz container that only the manifest
    CRC32 catches); re-ingesting from the fallback gives step 2 again."""
    d, f1, f2 = two_steps(tmp_path)
    chaos.corrupt_leaf_bytes(os.path.join(d, "step_00000002"), mode)
    restored = QuantileFleet.restore(d, spec(), device="cpu")
    assert_same(restored, f1, mode)
    assert ckpt.committed_steps(d) == [1]
    assert os.path.isdir(os.path.join(d, "step_00000002.corrupt"))
    assert_same(restored.ingest(data(5)), f2, mode)


def test_garble_fault_after_commit_is_caught(tmp_path):
    d, f1, f2 = two_steps(tmp_path)
    with chaos.armed(FaultPlan(faults=[Fault(kind="ckpt_garble",
                                             mode="truncate")])):
        f2.ingest(data(6)).checkpoint(d, step=3)
    assert ckpt.committed_steps(d) == [1, 2, 3]
    assert_same(QuantileFleet.restore(d, spec(), device="cpu"), f2)
    assert ckpt.committed_steps(d) == [1, 2]


def test_pinned_corrupt_step_raises_and_quarantines(tmp_path):
    d, _, _ = two_steps(tmp_path)
    chaos.corrupt_leaf_bytes(os.path.join(d, "step_00000002"), "rewrite")
    with pytest.raises(ckpt.CheckpointCorruptError,
                       match="corrupt or truncated"):
        QuantileFleet.restore(d, spec(), step=2, device="cpu")
    assert ckpt.committed_steps(d) == [1]
    assert os.path.isdir(os.path.join(d, "step_00000002.corrupt"))


def test_every_step_corrupt_raises_named_error(tmp_path):
    d, _, _ = two_steps(tmp_path)
    chaos.corrupt_leaf_bytes(os.path.join(d, "step_00000001"), "garble")
    chaos.corrupt_leaf_bytes(os.path.join(d, "step_00000002"), "truncate")
    with pytest.raises(ckpt.CheckpointCorruptError, match="verifies"):
        QuantileFleet.restore(d, spec(), device="cpu")
    assert ckpt.committed_steps(d) == []
    with pytest.raises(FileNotFoundError):
        QuantileFleet.restore(d, spec(), device="cpu")


def test_broken_manifest_quarantines(tmp_path):
    d, f1, _ = two_steps(tmp_path)
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write('{"step": 2, "num_lea')
    assert_same(QuantileFleet.restore(d, spec(), device="cpu"), f1)
    assert ckpt.committed_steps(d) == [1]


def test_dropped_shard_read_skips_to_older_step(tmp_path):
    """A shard read failing with ENOENT is a skip, not corruption: the
    fallback quarantines nothing."""
    d, f1, _ = two_steps(tmp_path)
    with chaos.armed(FaultPlan(faults=[Fault(kind="drop_shard")])):
        restored = QuantileFleet.restore(d, spec(), device="cpu")
    assert_same(restored, f1)
    assert ckpt.committed_steps(d) == [1, 2]


@pytest.mark.parametrize("phase", ("after_leaves", "before_marker"))
def test_checkpoint_kill_never_exposes_torn_step(tmp_path, phase):
    """A kill between any two protocol phases: the step is not committed,
    step 1 restores, and re-running the save commits step 2."""
    d = str(tmp_path / "ck")
    f1 = QuantileFleet.create(spec(), seed=1, device="cpu").ingest(data())
    f1.checkpoint(d, step=1)
    f2 = f1.ingest(data(5))
    with chaos.armed(FaultPlan(faults=[Fault(kind="ckpt_kill",
                                             phase=phase)])):
        with pytest.raises(CheckpointKilled):
            f2.checkpoint(d, step=2)
    assert ckpt.committed_steps(d) == [1]
    assert_same(QuantileFleet.restore(d, spec(), device="cpu"), f1, phase)
    f2.checkpoint(d, step=2)
    assert ckpt.committed_steps(d) == [1, 2]
    assert_same(QuantileFleet.restore(d, spec(), device="cpu"), f2, phase)


def test_keep_k_collects_old_steps_and_resave_is_idempotent(tmp_path):
    d = str(tmp_path / "ck")
    fleet = QuantileFleet.create(spec(), seed=1, device="cpu")
    fleets = {}
    for step in range(1, 6):
        fleet = fleet.ingest(data(step, 20))
        fleets[step] = fleet
        fleet.checkpoint(d, step=step, keep=2)
    assert ckpt.committed_steps(d) == [4, 5] and ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000004",
                                     "step_00000004.COMMITTED",
                                     "step_00000005",
                                     "step_00000005.COMMITTED"]
    manifest = ckpt.read_manifest(d)
    fleets[1].checkpoint(d, step=5, keep=2)          # committed: a no-op
    assert ckpt.read_manifest(d) == manifest
    assert_same(QuantileFleet.restore(d, spec(), device="cpu"), fleets[5])
    assert_same(QuantileFleet.restore(d, spec(), step=4, device="cpu"),
                fleets[4])


def test_format3_unchecksummed_save_still_restores(tmp_path):
    """A format-3 step (no CRCs), written by the JAX package's writer,
    restores in the port at the same state."""
    from repro.api import QuantileFleet as JQuantileFleet
    from repro.train import checkpoint as jckpt

    d = str(tmp_path / "ck")
    f1 = QuantileFleet.create(spec(), seed=1, device="cpu").ingest(data())
    j1 = JQuantileFleet.create(jax_spec("2u"), seed=1).ingest(data())
    jckpt.save_checkpoint(d, 1, j1.checkpoint_state(), checksum=False)
    manifest = ckpt.read_manifest(d, 1)
    assert manifest["format"] == 3 and "crc32" not in manifest
    assert_same(QuantileFleet.restore(d, spec(), device="cpu"), f1)


def test_template_mismatch_is_not_corruption(tmp_path):
    """A template of another layout raises ValueError and quarantines
    nothing; a windowed checkpoint never restores as a vanilla fleet."""
    d, _, _ = two_steps(tmp_path)
    with pytest.raises(ValueError, match="leaves"):
        QuantileFleet.restore(d, spec("2u-window"), device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        QuantileFleet.restore(d, FleetSpec(num_groups=G + 1, quantiles=QS),
                              device="cpu")
    assert ckpt.committed_steps(d) == [1, 2]


def test_template_of_another_layout_at_equal_leaf_count_is_refused(tmp_path):
    """A 1u-window step and a 2u template both have six leaves (three
    cursor words, then m, m2 / step_sign, quantile): the stored dtypes
    tell them apart, so restore raises ValueError and quarantines
    nothing, instead of casting the quantile plane into step words."""
    d = str(tmp_path / "ck")
    fl = QuantileFleet.create(spec("1u-window"), seed=1,
                              device="cpu").ingest(data())
    fl.checkpoint(d, step=1)
    assert ckpt.read_manifest(d)["num_leaves"] == 6
    with pytest.raises(ValueError, match="stores leaf 4 as float32"):
        QuantileFleet.restore(d, spec("2u"), device="cpu")
    assert ckpt.committed_steps(d) == [1]
    assert_same(QuantileFleet.restore(d, spec("1u-window"), device="cpu"),
                fl)


def test_restore_without_device_needs_the_card(tmp_path):
    d, _, _ = two_steps(tmp_path)
    fl = SLOFleet(device="cpu")
    fl.observe("r", "len_q50", 1.0)
    state = fl.to_numpy_state()
    if torch.cuda.is_available():
        assert QuantileFleet.restore(d, spec()).device.type == "cuda"
        assert SLOFleet.from_checkpoint_state(state).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        QuantileFleet.restore(d, spec())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ckpt.restore_checkpoint(d, QuantileFleet.template_for(spec()))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SLOFleet.from_checkpoint_state(state)
    assert ckpt.committed_steps(d) == [1, 2]


# ----------------------------------------------------- across the packages
def jax_prog(family):
    from repro.core import program

    return {p.family: p for p in program.test_instances()}[family]


def jax_spec(family):
    from repro.api import FleetSpec as JFleetSpec

    return JFleetSpec(num_groups=G, quantiles=QS, chunk_t=64, backend="jnp",
                      program=jax_prog(family))


def assert_manifests_agree(dir_a, dir_b):
    """Equal key by key, the informational ``treedef`` string included."""
    a, b = ckpt.read_manifest(dir_a), ckpt.read_manifest(dir_b)
    assert a == b
    assert len(a["crc32"]) == a["num_leaves"]


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["scalar-clock", "per-lane-clock"])
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_checkpoints_cross_packages_both_ways(tmp_path, prog, per_lane):
    """The same state checkpointed by both packages: equal manifests and
    CRC32s; each package restores the other's file, and both continue
    bit-identically. A per-lane-clock fleet ticks event rounds instead of
    blocks."""
    from repro.api import QuantileFleet as JQuantileFleet
    from repro.train import checkpoint as jckpt

    rng = np.random.default_rng(17)
    rounds = [(rng.permutation(G * len(QS))[:6].astype(np.int32),
               rng.lognormal(3.0, 1.0, 6).astype(np.float32))
              for _ in range(8)]
    items = data()

    def advance(fleet, part):
        if not per_lane:
            return fleet.ingest(items[:90] if part == 0 else items[90:])
        for lanes, vals in rounds[part * 4:(part + 1) * 4]:
            fleet = fleet.tick_lanes_sparse(lanes, vals)
        return fleet

    tfl = advance(QuantileFleet.create(spec(prog), seed=SEED, device="cpu",
                                       per_lane_clock=per_lane), 0)
    jfl = advance(JQuantileFleet.create(jax_spec(prog.family), seed=SEED,
                                        per_lane_clock=per_lane), 0)
    assert_same(tfl, jfl, "before the checkpoints")
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    tfl.checkpoint(tdir, step=3)
    jfl.checkpoint(jdir, step=3)
    assert_manifests_agree(tdir, jdir)

    t_from_j = QuantileFleet.restore(jdir, spec(prog), device="cpu",
                                     per_lane_clock=per_lane)
    j_from_t = JQuantileFleet.restore(tdir, jax_spec(prog.family),
                                      per_lane_clock=per_lane)
    assert t_from_j.cursor.per_lane == per_lane
    assert_same(t_from_j, tfl, "port restores JAX's file")
    assert_same(j_from_t, jfl, "JAX restores the port's file")
    ends = [advance(f, 1) for f in (tfl, jfl, t_from_j, j_from_t)]
    for f in ends[1:]:
        assert_same(ends[0], f, "continued")
    np.testing.assert_array_equal(bits(ends[0].estimate()),
                                  bits(ends[3].estimate()))
    # The port's file also restores through the JAX reader directly, and
    # the JAX file through the port's, at the same CRCs.
    assert ckpt.restore_checkpoint(jdir, tfl.checkpoint_template(),
                                   device="cpu")[1] == 3
    assert jckpt.restore_checkpoint(tdir, jfl.checkpoint_template())[1] == 3


def observations(n_routes, n, seed):
    rng = np.random.default_rng(seed)
    routes = (rng.zipf(1.2, n) - 1) % n_routes
    return [(f"r{r}", METRICS[m], float(v)) for r, m, v in zip(
        routes, rng.integers(0, 3, n), rng.lognormal(3.0, 1.0, n))]


def feed(fleet, obs):
    for route, metric, value in obs:
        fleet.observe(route, metric, value)
    fleet.flush()


def assert_slo_same(a, b, what=""):
    for name in ("_m", "_step", "_sign", "_ticks"):
        np.testing.assert_array_equal(bits(getattr(a, name)),
                                      bits(getattr(b, name)),
                                      err_msg=f"{what}: {name}")
    assert a.routes() == b.routes() and a.summaries() == b.summaries()


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["2u", "2u-decay"])
def test_slo_checkpoints_cross_packages_both_ways(tmp_path, windowed):
    """Checkpoint files of the SLO fleet cross both ways (pending events
    are flushed into the checkpoint, not dropped); the meta blob names the
    health policy as the JAX package's does."""
    from repro.serve import SLOFleet as JSLOFleet
    from repro.train import checkpoint as jckpt

    kw = dict(seed=3, capacity=2048, windowed=windowed, decay_half_life=64,
              health_policy="raise")
    tfl, jfl = SLOFleet(device="cpu", **kw), JSLOFleet(**kw)
    for fl in (tfl, jfl):
        fl.ensure_routes(f"r{i}" for i in range(1500))
        feed(fl, observations(1500, 800, 11))
        for route, metric, value in observations(1500, 50, 12):
            fl.observe(route, metric, value)          # still pending
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")
    ckpt.save_checkpoint(tdir, 1, tfl.checkpoint_state())
    jckpt.save_checkpoint(jdir, 1, jfl.checkpoint_state())
    assert_manifests_agree(tdir, jdir)
    assert_slo_same(tfl, jfl, "flushed by the checkpoint")

    st, _ = ckpt.restore_checkpoint(jdir, tfl.checkpoint_template(),
                                    device="cpu")
    t_from_j = SLOFleet.from_checkpoint_state(st, device="cpu")
    jst, _ = jckpt.restore_checkpoint(tdir, jfl.checkpoint_template())
    j_from_t = JSLOFleet.from_checkpoint_state(jst)
    for fl in (t_from_j, j_from_t):
        assert fl.health_policy == "raise" and fl.windowed == windowed
    obs = observations(1500, 800, 13)
    for fl in (tfl, jfl, t_from_j, j_from_t):
        feed(fl, obs)
    for fl in (jfl, t_from_j, j_from_t):
        assert_slo_same(tfl, fl, "continued")


# ------------------------------------------------- the committed JAX files
def copy_ckpt(tmp_path, name):
    """A copy of a committed JAX checkpoint (restore may quarantine in
    place)."""
    dst = str(tmp_path / name)
    shutil.copytree(os.path.join(golden.CKPT_ROOT, name), dst)
    return dst


def golden_spec(family):
    return FleetSpec(num_groups=golden.CKPT_G, quantiles=golden.QUANTILES,
                     chunk_t=golden.CKPT_CHUNK_T,
                     program=tprogram.make_program(
                         family, **golden.CKPT_PROGRAMS[family]))


@pytest.fixture(scope="module")
def golden_file():
    return dict(np.load(golden.GOLDEN))


def continue_golden_fleet(tmp_path, family, device):
    fleet = QuantileFleet.restore(copy_ckpt(tmp_path, family),
                                  golden_spec(family), device=device)
    return fleet.ingest(golden.ckpt_items(family, 1))


def assert_golden_fleet(fleet, golden_file, family):
    packed = fleet.state.packed()
    for name in packed._fields:
        x = getattr(packed, name)
        key = f"ckpt/{family}/{name}"
        assert (x is None) == (key not in golden_file), key
        if x is not None:
            np.testing.assert_array_equal(bits(x), bits(golden_file[key]),
                                          err_msg=key)
    assert list(fleet.cursor) == golden_file[f"ckpt/{family}/cursor"] \
        .tolist()


def continue_golden_slo(tmp_path, golden_file, device):
    template = SLOFleet(device="cpu").checkpoint_template()
    st, _ = ckpt.restore_checkpoint(copy_ckpt(tmp_path, "slo"), template,
                                    device=device)
    fleet = SLOFleet.from_checkpoint_state(st, device=device)
    golden.feed_slo(fleet, METRICS, golden.slo_continuation(golden_file))
    return fleet


def assert_golden_slo(fleet, golden_file):
    for name in ("m", "step", "sign", "ticks"):
        np.testing.assert_array_equal(bits(getattr(fleet, "_" + name)),
                                      bits(golden_file[f"ckpt/slo/{name}"]),
                                      err_msg=name)


@pytest.mark.parametrize("family", list(golden.CKPT_PROGRAMS))
def test_committed_jax_checkpoint_continues_to_golden(tmp_path, golden_file,
                                                      family):
    assert_golden_fleet(continue_golden_fleet(tmp_path, family, "cpu"),
                        golden_file, family)


def test_committed_jax_slo_checkpoint_continues_to_golden(tmp_path,
                                                          golden_file):
    assert_golden_slo(continue_golden_slo(tmp_path, golden_file, "cpu"),
                      golden_file)


def test_committed_jax_checkpoints_reproduced_by_jax(tmp_path):
    """The JAX package still writes the committed checkpoints: the same
    manifests (CRC32s included) for every fleet."""
    golden.golden_checkpoints(str(tmp_path))
    for name in list(golden.CKPT_PROGRAMS) + ["slo"]:
        assert ckpt.read_manifest(str(tmp_path / name)) == \
            ckpt.read_manifest(os.path.join(golden.CKPT_ROOT, name)), name
        with open(os.path.join(golden.CKPT_ROOT, name, "step_00000001",
                               "manifest.json")) as f:
            assert json.load(f)["format"] == 4


# ---------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_checkpoint.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(golden.CKPT_PROGRAMS))
def test_card_committed_jax_checkpoint_continues_to_golden(
        tmp_path, golden_file, card, family):
    from repro_torch.kernels import frugal_update as fk

    before = fk.launch_count
    fleet = continue_golden_fleet(tmp_path, family, card)
    assert fleet.device.type == "cuda" and fk.launch_count > before
    assert_golden_fleet(fleet, golden_file, family)


@pytest.mark.cuda
def test_card_committed_jax_slo_checkpoint_continues_to_golden(
        tmp_path, golden_file, card):
    from repro_torch.kernels import frugal_update as fk

    before = fk.scatter_launch_count
    fleet = continue_golden_slo(tmp_path, golden_file, card)
    assert fleet.device.type == "cuda"
    assert fk.scatter_launch_count == before + 1
    assert_golden_slo(fleet, golden_file)


@pytest.mark.cuda
@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_card_checkpoint_restore_matches_cpu(tmp_path, card, prog):
    """Written from the card, restored on the card, continued through the
    dense kernel: the same bits and CRC32s as the CPU's run."""
    ends = []
    for dev in (card, "cpu"):
        d = str(tmp_path / str(dev))
        QuantileFleet.create(spec(prog), seed=SEED, device=dev).ingest(
            data()[:90]).checkpoint(d, step=1)
        fleet = QuantileFleet.restore(d, spec(prog), device=dev)
        assert fleet.device.type == torch.device(dev).type
        ends.append((fleet.ingest(data()[90:]), ckpt.read_manifest(d)))
    assert_same(ends[0][0], ends[1][0], prog.family)
    assert ends[0][1] == ends[1][1]
