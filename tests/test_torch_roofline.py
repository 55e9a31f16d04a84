"""The port's roofline layer against the JAX package's, and its model of
the dense kernel against the kernel's own plan.

* Analysis: the HwSpec registry entry by entry, device-kind matching,
  the refusal to price unknown hardware, ``roofline_terms``,
  ``model_flops`` and ``analytic_hbm_bytes`` for every arch — exact (the
  same Python float arithmetic on both sides).
* Kernel model: bytes equal to the JAX model at Q = 1 for every layout and
  block_t, the port's formula at Q = 3 (items read once per group); the
  launch plan and shared memory against a line-by-line transcription of
  ``ft_dense_plan`` and against the plan the host build of the kernel
  header (``tick_host_shim.cpp``) reports; the issue-slot bound of
  PERF.md §6.
* Autotuner: deterministic, cached, feasible, block_t = t, 256 at the
  main path's shapes, fewer threads where blocks would leave SMs idle.
* Facade: planes at tuned, forced and default blocks bit-identical to
  JAX's ``program_process_seeded`` (never the interpret kernels) and to
  the host-built kernel's tile loop at the tuned block size.
* Reporter: the dry-run tables equal the JAX package's.
"""
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import frugal as jfrugal
from repro.roofline import analysis as janalysis
from repro.roofline import kernel_model as jkm
from repro.roofline import report as jreport
from repro_torch import configs as tconfigs
from repro_torch.core import program as tprogram
from repro_torch.core import rng as trng
from repro_torch.kernels import frugal_update as tkernel
from repro_torch.kernels import ops as tops
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import autotune as tautotune
from repro_torch.roofline import kernel_model as tkm
from repro_torch.roofline import report as treport

PROGS = tprogram.test_instances()
IDS = [p.family for p in PROGS]
H100 = tanalysis.hw_for("gpu-h100")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "kernels", "csrc")


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits_equal(a, b, what=""):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(bits(x), bits(y),
                                      err_msg=f"{what} plane {i}")


# ------------------------------------------------------------ HW registry
def test_registry_equal_entry_by_entry():
    assert list(tanalysis.HW_REGISTRY) == list(janalysis.HW_REGISTRY)
    for name, spec in janalysis.HW_REGISTRY.items():
        assert dataclasses.asdict(tanalysis.HW_REGISTRY[name]) == \
            dataclasses.asdict(spec)
        assert tanalysis.HW_REGISTRY[name].known == spec.known
    assert tanalysis._KIND_PATTERNS == janalysis._KIND_PATTERNS
    # the figure the card's byte bounds read (3.35 TB/s, published)
    assert H100.hbm_bw == 3.35e12 and H100.cores == 132


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v4", "TPU v5p",
                                  "TPU v6 lite", "NVIDIA H100 80GB HBM3",
                                  "NVIDIA A100-SXM4-80GB", "cpu",
                                  "Radeon RX 7900", ""])
def test_match_device_kind_agrees(kind):
    assert tanalysis.match_device_kind(kind).name == \
        janalysis.match_device_kind(kind).name


def test_unknown_hardware_refuses_to_predict():
    with pytest.raises(KeyError, match="nope"):
        tanalysis.hw_for("nope")
    unk = tanalysis.hw_for("unknown")
    assert not unk.known
    layout = tprogram.family_base("2u").layout
    with pytest.raises(tanalysis.RooflineUnknownHardware, match="refusing"):
        tkm.predict_kernel(1024, 256, 1, layout, block_g=256, block_t=256,
                           hw=unk)
    with pytest.raises(tanalysis.RooflineUnknownHardware):
        tanalysis.roofline_terms(1e12, 1e9, 0.0, hw=unk)


def test_detect_hw_reads_the_device_kind(monkeypatch):
    assert tanalysis.detect_hw("cpu").name == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hw = tanalysis.detect_hw()
    assert hw.name == "cpu" and hw.nominal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tanalysis.detect_hw().name == "gpu-h100"
    assert tanalysis.detect_hw("cuda:0").name == "gpu-h100"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Future Card")
    assert tanalysis.detect_hw("cuda").name == "unknown"


TERMS_GRID = [(1e12, 1e9, 0.0, {}), (3.3e15, 2.5e11, 4e9, {}),
              (5e13, 8e10, 1e10, dict(model_flops_global=4e15, n_chips=8)),
              (7e12, 1e12, 2e9, dict(links=2, model_flops_global=1e13)),
              (0.0, 1e6, 0.0, dict(model_flops_global=1.0, n_chips=4))]


@pytest.mark.parametrize("hw", [n for n in janalysis.HW_REGISTRY
                                if n != "unknown"])
@pytest.mark.parametrize("case", range(len(TERMS_GRID)))
def test_roofline_terms_equal(hw, case):
    fl, by, coll, kw = TERMS_GRID[case]
    if coll and not janalysis.hw_for(hw).ici_bw_per_link:
        # no interconnect figure (the cpu entry): both packages refuse
        for mod in (tanalysis, janalysis):
            with pytest.raises(ZeroDivisionError):
                mod.roofline_terms(fl, by, coll, hw=mod.hw_for(hw), **kw)
        return
    assert tanalysis.roofline_terms(fl, by, coll, hw=tanalysis.hw_for(hw),
                                    **kw) == \
        janalysis.roofline_terms(fl, by, coll, hw=janalysis.hw_for(hw), **kw)


SHAPES = [(8, 4096, 8, 1), (256, 8192, 16, 16), (1, 32768, 1, 1)]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_flops_and_hbm_bytes_equal(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for kind in ("train", "prefill", "decode"):
        for batch, seq, dp, model in SHAPES:
            tokens = batch * (1 if kind == "decode" else seq)
            assert tanalysis.model_flops(tcfg, tokens, kind) == \
                janalysis.model_flops(jcfg, tokens, kind)
            assert tanalysis.analytic_hbm_bytes(
                tcfg, kind, batch, seq, dp, model) == \
                janalysis.analytic_hbm_bytes(jcfg, kind, batch, seq, dp,
                                             model)
    rf = dataclasses.replace(tcfg, rwkv_factorized=True)
    jf = dataclasses.replace(jcfg, rwkv_factorized=True)
    assert tanalysis.analytic_hbm_bytes(rf, "train", 8, 4096, 8, 1) == \
        janalysis.analytic_hbm_bytes(jf, "train", 8, 4096, 8, 1)


# ---------------------------------------------------------- kernel model
def header_define(name):
    with open(os.path.join(CSRC, "frugal_tick.cuh")) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


def test_model_constants_are_the_headers():
    assert tkm.MAX_LANES_PER_THREAD == header_define("FT_DENSE_MAX_LPT")
    assert tkm.TILE_ROWS == header_define("FT_DENSE_TILE_ROWS")
    assert tkm.TILE_BYTES == header_define("FT_DENSE_TILE_BYTES")
    assert tkm.TMA_BOX_MAX == header_define("FT_TMA_BOX_MAX")
    assert tkm.SMEM_MAX == tkm.TILE_BYTES + 16 * tkm.TILE_ROWS + 16
    assert tautotune.DEFAULT_BLOCK_G == tkernel.DEFAULT_BLOCK_G == 256


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_kernel_family_of_each_layout(prog):
    assert tkm.kernel_family(prog.layout) == prog.kernel_family


BYTES_CASES = [(4096, 256), (4096, 4096), (4096, 1000), (512, 128),
               (11996, 4096), (37, 5), (1, 1), (100, 1000)]


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_bytes_equal_jax_at_q1(prog):
    """At Q = 1 the port's bytes are the JAX formula term for term."""
    from repro.core import program as jprogram

    jlayout = {p.family: p for p in jprogram.test_instances()}[
        prog.family].layout
    assert jlayout.num_words == prog.layout.num_words
    for t, bt in BYTES_CASES:
        for g in (1, 532, 1 << 22):
            assert tkm.kernel_bytes_per_item(prog.layout, 1, block_t=bt,
                                             t=t) == \
                jkm.kernel_bytes_per_item(jlayout, 1, block_t=bt, t=t)
            assert tkm.kernel_bytes_total(g, t, 1, prog.layout,
                                          block_t=bt) == \
                jkm.kernel_bytes_total(g, t, 1, jlayout, block_t=bt)


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_bytes_at_q3_read_items_once(prog):
    """Q = 3: items once per group, 2·L·W words per launch, L estimates
    (shapes where every float is exact); JAX's model charges the items Q
    times (its facade repeats them), the difference by design."""
    from repro.core import program as jprogram

    jlayout = {p.family: p for p in jprogram.test_instances()}[
        prog.family].layout
    w = prog.layout.num_words
    q, g = 3, 1024
    for t, bt in ((4096, 4096), (4096, 512), (4096, 1000), (512, 512)):
        launches = -(-t // bt)
        want = t * g * 4 + 2 * g * q * w * 4 * launches + g * q * 4
        got = tkm.kernel_bytes_total(g, t, q, prog.layout, block_t=bt)
        assert got == want
        assert tkm.kernel_bytes_per_item(prog.layout, q, block_t=bt, t=t) \
            == 4 + q * 2 * w * 4 * launches / t
        assert jkm.kernel_bytes_total(g, t, q, jlayout, block_t=bt) - got \
            == (q - 1) * t * g * 4


def c_dense_plan(T, G, Q, block_g):
    """ft_dense_plan (csrc/frugal_tick.cuh), statement for statement."""
    def round_up(x, m):
        return (x + m - 1) // m * m

    lpt = Q if Q <= 4 else 1
    cols = block_g if lpt == Q else round_up((block_g - 1) // Q + 2 + 31,
                                             32)
    box = cols
    if cols > 256:
        d = 256 // 32
        while (cols // 32) % d != 0:
            d -= 1
        box = 32 * d
    rows = 98304 // (8 * cols)
    if rows > 32:
        rows = 32
    if rows > round_up(T, 4):
        rows = round_up(T, 4)
    rows = rows // 4 * 4
    rows = 4 if rows < 4 else rows
    tiles = (T + rows - 1) // rows
    per_block = block_g * lpt
    blocks = (G * Q + per_block - 1) // per_block
    smem = 8 * rows * cols + 16 * rows + 16
    return dict(lpt=lpt, threads=block_g, rows=rows, cols=cols, box=box,
                tiles=tiles, blocks=blocks, smem_bytes=smem)


PLAN_SWEEP = [(t, g, q, bg)
              for t in (1, 3, 4, 31, 33, 64, 512, 4096, 11996)
              for g in (1, 37, 532, 1000, 1 << 20, (1 << 22) + 3)
              for q in (1, 2, 3, 4, 5, 7)
              for bg in (32, 64, 96, 256, 512, 1024)]


def test_plan_equals_a_transcription_of_ft_dense_plan():
    for t, g, q, bg in PLAN_SWEEP:
        plan = tkm.dense_plan(t, g, q, bg)
        assert plan == c_dense_plan(t, g, q, bg), (t, g, q, bg)
        assert tkm.smem_footprint_bytes(t, g, q, block_g=bg) == \
            plan["smem_bytes"] <= tkm.SMEM_MAX


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "frugal_tick.cuh cannot be compiled")
    out = tmp_path_factory.mktemp("shim") / "libtick.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(out), os.path.join(CSRC, "tick_host_shim.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i64, i32, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, \
        ctypes.c_int
    lib.ft_host_dense.argtypes = ([i, i32] + [p] * 14 + [i64] * 3
                                  + [i32] * 6 + [p])
    lib.ft_host_dense.restype = i
    return lib


def ptr(a):
    return None if a is None else a.ctypes.data


def shim_dense(lib, prog, items, words, quantile, q, seed, t_offset, g_offset,
               block_g):
    """One host-built launch of the kernel (ft_host_dense) over numpy
    operands; returns (words out, plan)."""
    words = [np.ascontiguousarray(w) for w in words]
    outs = [np.empty_like(w) for w in words]
    pin = [ptr(w) for w in words] + [None] * (6 - len(words))
    pout = [ptr(o) for o in outs] + [None] * (6 - len(outs))
    sc = prog.scalar_values() + (0, 0)
    plan = np.zeros(6, np.int64)
    t, g = items.shape
    rc = lib.ft_host_dense(
        tkernel.FAMILY_IDS[prog.kernel_family],
        tkernel.STATE_FORMATS["words"], ptr(items), ptr(quantile),
        *pin, *pout, t, g, q, seed, trng.wrap_i32(t_offset),
        trng.wrap_i32(g_offset), sc[0], sc[1], block_g, ptr(plan))
    assert rc == 0
    return outs, dict(zip(("lpt", "rows", "cols", "box", "tiles", "blocks"),
                          plan.tolist()))


SHIM_PLANS = [(t, g, q, bg) for t in (1, 5, 33, 70)
              for g in (1, 9, 37, 40) for q in (1, 3, 5)
              for bg in (32, 96, 256, 1024)]


def test_plan_equals_the_host_built_kernels_plan(shim):
    prog = tprogram.family_base("1u")
    for t, g, q, bg in SHIM_PLANS:
        items = np.zeros((t, g), np.float32)
        words = [np.zeros(g * q, np.float32)]
        _, got = shim_dense(shim, prog, items, words,
                            np.full(g * q, 0.5, np.float32), q, 0, 0, 0, bg)
        want = tkm.dense_plan(t, g, q, bg)
        assert got == {k: want[k] for k in got}, (t, g, q, bg)


def test_predict_reproduces_the_dense_bound():
    """PERF.md §6's B1 bound at [512, 2^22], Q = 3, 2u: 8.4733 ms of issue
    slots at 132 SMs x 1980 MHz; the bytes 2.6393 ms; the service chunk's
    0.0983 (operations) and 0.0864 (bytes) ms."""
    prog = tprogram.family_base("2u")
    pred = tkm.predict_kernel(1 << 22, 512, 3, prog.layout, block_g=256,
                              block_t=512, hw=H100, sm_clock_hz=1980e6)
    assert f"{pred['operations_s'] * 1e3:.4f}" == "8.4733"
    assert f"{pred['bandwidth_s'] * 1e3:.4f}" == "2.6393"
    assert pred["bound_by"] == "operations"
    assert pred["operations_bound_by"] == "issue"
    assert pred["bound_s"] == pred["operations_s"]
    assert pred["predicted_s"] == pred["bound_s"] + H100.grid_step_s
    assert pred["grid"] == [16384, 1]
    assert pred["smem_bytes"] == 66064
    assert pred["bytes_total"] == (512 * (1 << 22) + 3 * (1 << 22)) * 4 \
        + 2 * 3 * (1 << 22) * 2 * 4
    # the default clock is the part's published maximum
    assert tkm.predict_kernel(1 << 22, 512, 3, prog.layout, block_g=256,
                              block_t=512, hw=H100) == pred
    svc = tprogram.make_program("2u-decay", half_life=1 << 16)
    pred = tkm.predict_kernel(1 << 20, 64, 1, svc.layout, block_g=256,
                              block_t=64, hw=H100)
    assert f"{pred['operations_s'] * 1e3:.4f}" == "0.0983"
    assert f"{pred['bandwidth_s'] * 1e3:.4f}" == "0.0864"


def test_issue_slots_per_lane_tick():
    assert {f: tkm.issue_slots(t) for f, t in tkm.LANE_TICK_OPS.items()} == \
        {"1u": 17, "2u": 44, "2u-decay": 49, "1u-window": 25,
         "2u-window": 79}
    assert tkm.issue_slots(tkm.OPS_TICK) == 9


def test_real_items_price_only_the_operations():
    prog = tprogram.family_base("2u")
    full = tkm.predict_kernel(532, 11996, 1, prog.layout, block_g=32,
                              block_t=11996, hw=H100)
    part = tkm.predict_kernel(532, 11996, 1, prog.layout, block_g=32,
                              block_t=11996, hw=H100, real_items=100000)
    assert part["bandwidth_s"] == full["bandwidth_s"]
    assert part["operations_s"] < full["operations_s"]


def test_bytes_alone_bound_other_hardware():
    prog = tprogram.family_base("2u")
    pred = tkm.predict_kernel(1 << 20, 64, 1, prog.layout, block_g=256,
                              block_t=64, hw=tanalysis.hw_for("tpu-v5e"))
    assert pred["operations_s"] == 0.0 and pred["bound_by"] == "bytes"
    assert pred["operations_bound_by"] is None


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_shorter_block_t_adds_only_launches_and_state(prog):
    g, t, q = 4096, 1024, 3
    kw = dict(block_g=256, hw=H100)
    whole = tkm.predict_kernel(g, t, q, prog.layout, block_t=t, **kw)
    assert whole["grid"][1] == 1
    for bt in (1, 7, 100, 512, t - 1):
        cut = tkm.predict_kernel(g, t, q, prog.layout, block_t=bt, **kw)
        launches = -(-t // bt)
        assert cut["grid"] == [whole["grid"][0], launches]
        extra = 2 * g * q * prog.layout.num_words * 4 * (launches - 1)
        assert cut["bytes_total"] - whole["bytes_total"] == \
            pytest.approx(extra, rel=1e-12)
        assert cut["operations_s"] == whole["operations_s"]
        assert cut["overhead_s"] == launches * H100.grid_step_s
        assert cut["predicted_s"] > whole["predicted_s"]


# ------------------------------------------------------------- autotuner
def test_autotune_cache_hit_miss():
    tautotune.clear_autotune_cache()
    prog = tprogram.family_base("2u")
    a = tautotune.autotune_blocks(prog, 1 << 20, 64, 1, hw=H100)
    info = tautotune.autotune_cache_info()
    assert info.misses == 1 and info.hits == 0
    b = tautotune.autotune_blocks(prog, 1 << 20, 64, 1, hw=H100)
    assert a == b and tautotune.autotune_cache_info().hits == 1
    # a parameter variant of the family shares the entry
    tautotune.autotune_blocks(tprogram.make_program("2u-window", window=96),
                              9, 9, 1, hw=H100)
    tautotune.autotune_blocks(tprogram.make_program("2u-window", window=7),
                              9, 9, 1, hw=H100)
    assert tautotune.autotune_cache_info().hits == 2


TUNE_SHAPES = [(1 << 22, 512, 3), (1 << 20, 64, 1), (532, 11996, 1),
               (548, 4096, 1), (2392, 3198, 1), (905, 4096, 1),
               (1 << 17, 64, 1), (1 << 18, 64, 1), (1000, 64, 2),
               (1 << 22, 4096, 1), (1 << 22, 4096, 3), (1, 4096, 1),
               (37, 45, 5), (50000, 100, 7)]


@pytest.mark.parametrize("prog", PROGS, ids=IDS)
def test_tuned_blocks_feasible_and_deterministic(prog):
    for g, t, q in TUNE_SHAPES:
        tautotune.clear_autotune_cache()
        bg, bt = tautotune.autotune_blocks(prog, g, t, q, hw=H100)
        assert (bg, bt) == tautotune.autotune_blocks(prog, g, t, q, hw=H100)
        assert bt == t
        assert bg % 32 == 0 and 32 <= bg <= 1024
        assert tkm.smem_footprint_bytes(t, g, q, block_g=bg) <= tkm.SMEM_MAX
        blocks = tkm.dense_plan(t, g, q, bg)["blocks"]
        assert blocks >= H100.cores or bg == 32


def test_tuner_keeps_the_main_paths_blocks():
    """256 at the dense cell ([512, 2^22], Q = 3, 2u) and the service
    chunk ([64, 2^20], Q = 1, 2u-decay): those phases launch as before."""
    dense = tprogram.family_base("2u")
    svc = tprogram.make_program("2u-decay", half_life=1 << 16)
    assert tautotune.autotune_blocks(dense, 1 << 22, 512, 3, hw=H100) == \
        (256, 512)
    assert tautotune.autotune_blocks(svc, 1 << 20, 64, 1, hw=H100) == \
        (256, 64)


@pytest.mark.parametrize("g,t", [(532, 11996), (548, 11988), (2392, 3198),
                                 (905, 19990)])
def test_tuner_fills_the_sms_at_the_evaluation_shapes(g, t):
    """E3 and E5: at 256 threads B1 would run 3-10 of 132 SMs; the JAX
    rule (keep enough blocks to occupy every core) takes fewer threads."""
    for fam in ("1u", "2u"):
        bg, bt = tautotune.autotune_blocks(tprogram.family_base(fam), g, t,
                                           1, hw=H100)
        assert bg < 256 and bt == t
        assert tkm.dense_plan(t, g, 1, 256)["blocks"] < H100.cores


def test_unknown_hardware_gets_the_default_blocks():
    prog = tprogram.family_base("2u")
    assert tautotune.autotune_blocks(
        prog, 532, 11996, 1, hw=tanalysis.hw_for("unknown")) == (256, 11996)


# ---------------------------------------------------------------- facade
FACADE_SHAPES = [(37, 3, 45), (40, 1, 70), (9, 5, 33), (70, 2, 31)]


def case(prog, g, q, t, seed):
    rng = np.random.default_rng(seed)
    items = rng.integers(-40, 400, (t, g)).astype(np.float32)
    items[rng.random((t, g)) < 0.05] = np.nan
    quantile = np.tile(rng.uniform(0.05, 0.95, q).astype(np.float32), g)
    planes = []
    for f in prog.layout.plane_fields:
        if f in prog.layout.heads:
            planes.append(rng.normal(0.0, 150.0, g * q).astype(np.float32))
        elif f.startswith("step"):
            planes.append(rng.integers(-6, 7, g * q).astype(np.float32))
        else:
            planes.append(rng.choice([-1.0, 1.0], g * q).astype(np.float32))
    return items, quantile, planes


@pytest.mark.parametrize("shape", FACADE_SHAPES, ids=str)
@pytest.mark.parametrize("tprog", PROGS, ids=IDS)
def test_facade_blocks_change_no_bit(tprog, shape, shim):
    """Tuned, forced and default blocks through ``frugal_update_auto``
    (the plain version's block_t walk on the CPU), JAX's scan, and the
    host-built kernel at the tuned block size (one launch, and a forced
    block_t walk) give the same planes."""
    import jax.numpy as jnp
    from repro.core import program as jprogram

    jprog = {p.family: p for p in jprogram.test_instances()}[tprog.family]
    g, q, t = shape
    items, quantile, planes = case(tprog, g, q, t, 31 * g + t)
    seed, t_off, g_off = 77, 2 ** 31 - 20, 2 ** 31 - 50
    want, _ = jfrugal.program_process_seeded(
        jprog, tuple(jnp.asarray(p) for p in planes), jnp.asarray(items),
        seed, jnp.asarray(quantile), t_offset=t_off, g_offset=g_off,
        lanes_per_group=q)

    def auto():
        return tops.frugal_update_auto(
            torch.from_numpy(items), tuple(map(torch.from_numpy, planes)),
            torch.from_numpy(quantile), seed=seed, program=tprog,
            t_offset=t_off, g_offset=g_off, lanes_per_group=q)

    assert_bits_equal(auto(), want, "default")
    for ov in (dict(block_g=64, block_t=16), dict(block_t=7),
               dict(autotune_hw="gpu-h100"),
               dict(autotune_hw="gpu-h100", kernel="grid"),
               dict(block_g=1024, autotune_hw="tpu-v5e", kernel="gpu")):
        with tops.block_override(**ov):
            assert_bits_equal(auto(), want, f"override {ov}")

    tuned_bg, tuned_bt = tautotune.autotune_blocks(tprog, g, t, q, hw=H100)
    assert tuned_bt == t
    layout = tprog.layout
    words = [np.asarray(w) for w in jprog.layout.pack_planes(
        tuple(jnp.asarray(p) for p in planes))]
    got, plan = shim_dense(shim, tprog, items, words, quantile, q,
                           seed, t_off, g_off, tuned_bg)
    assert plan["blocks"] == tkm.dense_plan(t, g, q, tuned_bg)["blocks"]
    assert_bits_equal(layout.unpack_words(tuple(map(torch.from_numpy, got))),
                      want, f"host kernel at block_g={tuned_bg}")
    w = words
    for r0 in range(0, t, 16):
        w, _ = shim_dense(shim, tprog, np.ascontiguousarray(items[r0:r0 + 16]),
                          w, quantile, q, seed, t_off + r0, g_off, 64)
    assert_bits_equal(layout.unpack_words(tuple(map(torch.from_numpy, w))),
                      want, "host kernel, 16-row launches of 64 threads")


def test_auto_blocks_on_a_card(monkeypatch):
    """On CUDA tensors block_g=None is the tuner's choice for the card; an
    explicit block_g wins; CPU tensors keep the default; the override
    applies on either device."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    prog = tprogram.family_base("2u")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tops._auto_blocks(prog, (11996, 532), cuda, 1, None) == (32, None)
    assert tops._auto_blocks(prog, (512, 1 << 22), cuda, 3, None) == \
        (256, None)
    assert tops._auto_blocks(prog, (11996, 532), cuda, 1, 128) == (128, None)
    assert tops._auto_blocks(prog, (11996, 532), cpu, 1, None) == (256, None)
    with tops.block_override(block_t=512):
        assert tops._auto_blocks(prog, (4096, 1 << 22), cuda, 1, None) == \
            (256, 512)
    with tops.block_override(autotune_hw="gpu-h100"):
        assert tops._auto_blocks(prog, (11996, 532), cpu, 1, None) == \
            (32, 11996)
        assert tops._auto_blocks(prog, (11996, 532), cpu, 1, 64) == \
            (64, 11996)
    with tops.block_override(autotune_hw="unknown"):
        assert tops._auto_blocks(prog, (9, 9), cpu, 1, None) == (256, 9)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Future Card")
    assert tops._auto_blocks(prog, (11996, 532), cuda, 1, None) == (256, None)


def test_block_override_refuses_unknown_kernels_and_nests():
    with pytest.raises(ValueError, match="kernel must be one of"):
        with tops.block_override(kernel="mosaic"):
            pass
    prog = tprogram.family_base("1u")
    cpu = torch.device("cpu")
    with tops.block_override(block_g=64):
        with tops.block_override(block_g=512, block_t=3):
            assert tops._auto_blocks(prog, (9, 9), cpu, 1, None) == (512, 3)
        assert tops._auto_blocks(prog, (9, 9), cpu, 1, None) == (64, None)
    assert tops._BLOCK_OVERRIDE.get() is None


# --------------------------------------------------------------- reporter
def cells():
    base = {"mesh": "single", "variant": "baseline", "ok": True,
            "production": {"compile_s": 12.5, "memory_analysis": {
                "argument_size_in_bytes": 3e9, "temp_size_in_bytes": 1e9},
                "collective_counts": {"all-reduce": 4, "all-gather": 2}},
            "roofline": {"compute_s": 2e-5, "memory_s": 0.05,
                         "collective_s": 0.3, "bound": "collective",
                         "useful_compute_ratio": 0.71,
                         "roofline_mfu": 0.123}}
    return [dict(base, arch="yi_6b", shape="train_4k"),
            dict(base, arch="granite_20b", shape="decode", ok=False,
                 error="out of memory on device 0 while compiling"),
            {"arch": "rwkv6_1p6b", "shape": "prefill", "mesh": "single",
             "skipped": True, "reason": "attention-free family has no "
             "prefill KV cache to price"},
            dict(base, arch="gemma2_9b", shape="train_4k", mesh="multi")]


def test_report_tables_equal(tmp_path):
    for i, c in enumerate(cells()):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(c))
    tc, jc = treport.load_cells(str(tmp_path)), jreport.load_cells(
        str(tmp_path))
    assert tc == jc == cells()
    for mesh in ("single", "multi"):
        assert treport.dryrun_table(tc, mesh) == jreport.dryrun_table(jc,
                                                                      mesh)
        assert treport.roofline_table(tc, mesh) == \
            jreport.roofline_table(jc, mesh)
    for x in (0, 3e-6, 2e-3, 0.5, 12.0):
        assert treport.fmt_s(x) == jreport.fmt_s(x)


def test_report_main_equal(tmp_path, capsys, monkeypatch):
    for i, c in enumerate(cells()):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(c))
    outs = []
    for mod in (treport, jreport):
        monkeypatch.setattr("sys.argv", ["report", "--dir", str(tmp_path)])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "4 total, 2 ok, 1 skipped" in outs[0]
