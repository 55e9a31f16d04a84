"""The port's serving engine (``repro_torch.serve.ServeEngine``) against
the JAX package's, on the CPU.

Both engines serve the same reduced yi-6b (the JAX package's parameters
carried across by ``params_from_numpy``) with both modules' ``time`` read
from one fake clock (``make_torch_port_golden.FakeClock``, a fresh one per
engine), so the SLO observations are the same numbers. Checked: the
outputs token for token, ``stats_summary()`` and the SLO fleet's planes
and clocks bit for bit, and the telemetry counters equal, on both flush
branches of the SLO fleet (the default 64 routes: dense rounds; 1400
routes registered up front, 4200 > 4096 lanes: the sparse branch), each
with a prompt longer than max_len (the cache write clamps). The two MoE
configs (reduced olmoe-1b-7b, GQA and experts; reduced
deepseek-v2-lite-16b, the MLA latent cache, whose write clamps the same
way) on the dense branch, likewise. The recurrent configs (reduced
zamba2-2.7b, mamba2 layers and one shared attention block; reduced
rwkv6-1.6b), every leaf of the JAX tree redrawn
(``make_torch_port_golden.redraw_params``), likewise: their lockstep
prefill advances every row's recurrent state, and a request admitted
while another slot is mid-decode must see the same state the JAX
engine's does. Also: the engine's and the launcher's device checks, and
the launcher serving each MoE and recurrent arch. The golden file's serving
entry and the card's runs are in ``test_torch_serve_card.py``, which
imports no JAX.

Tolerance: tokens and counters equal; float32 SLO state compared as int32
bit patterns.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.service import Telemetry as JTelemetry
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Request, SLOFleet, ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.service import Telemetry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

SLOTS, MAX_LEN = 3, 24


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
SSM_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")


def make_pair(arch):
    """(JAX model, params, port model) of reduced ``arch``."""
    jm = jbuild_model(jreduce(jget_config(arch)))
    params = jm.init(jax.random.PRNGKey(1))
    tm = params_from_numpy(reduce_for_smoke(get_config(arch)),
                           jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return make_pair("yi-6b")


def requests(vocab, n_routes):
    """9 requests from numpy seed 3: prompts of 1-6 tokens (one of 30,
    past MAX_LEN), 2-6 new tokens, Zipf(1.2) routes over n_routes."""
    rng = np.random.default_rng(3)
    out = []
    for rid in range(9):
        n = 30 if rid == 4 else int(rng.integers(1, 7))
        route = int((rng.zipf(1.2) - 1) % n_routes)
        out.append(dict(rid=rid, prompt=rng.integers(0, vocab, n).tolist(),
                        max_new_tokens=int(rng.integers(2, 7)),
                        route=f"route-{route}"))
    return out


def serve(make_engine, module, request_cls, reqs, n_routes, monkeypatch):
    monkeypatch.setattr(module, "time", golden.FakeClock())
    eng = make_engine()
    if n_routes > 64:
        eng.slo.ensure_routes(f"route-{i}" for i in range(n_routes))
    for r in reqs:
        eng.submit(request_cls(**r))
    ticks = eng.run_until_drained()
    return eng, ticks


@pytest.mark.parametrize("n_routes", [5, 1400], ids=["dense", "sparse"])
def test_engine_matches_jax(pair, n_routes, monkeypatch):
    check_engine_against_jax(*pair, n_routes, monkeypatch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_jax(arch, monkeypatch):
    jm, params, tm = make_pair(arch)
    kinds = {layer.kind for layer in tm.layers}
    assert kinds == ({"moe"} if arch == "olmoe-1b-7b" else
                     {"mla", "mla_moe"})
    eng = check_engine_against_jax(jm, params, tm, 5, monkeypatch)
    assert all(set(c) == ({"ckv", "kr"} if "mla" in kinds else {"k", "v"})
               for c in eng.caches)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_recurrent_engine_matches_jax(arch, monkeypatch):
    jm = jbuild_model(jreduce(jget_config(arch)))
    params = golden.redraw_params(
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))), 32)
    tm = params_from_numpy(reduce_for_smoke(get_config(arch)), params,
                           device="cpu")
    eng = check_engine_against_jax(jm, jax.tree.map(jnp.asarray, params),
                                   tm, 5, monkeypatch)
    want = {"mamba": {"ssm", "conv"}, "rwkv": {"wkv", "x_tm", "x_cm"},
            "attn": {"k", "v"}}
    assert all(set(c) == want[layer.kind]
               for layer, c in zip(tm.layers, eng.caches))
    # Hazard of the reference kept: requests were admitted (prefilled
    # through every row) while another slot was mid-decode.
    done = eng.done
    assert any(a.t_first < b.t_first < a.t_done
               for a in done for b in done if a is not b)


def check_engine_against_jax(jm, params, tm, n_routes, monkeypatch):
    reqs = requests(tm.cfg.vocab_size, n_routes)
    jtel, ttel = JTelemetry(seed=0), Telemetry(device="cpu")
    jeng, jticks = serve(
        lambda: jengine.ServeEngine(jm, params, batch_slots=SLOTS,
                                    max_len=MAX_LEN, telemetry=jtel),
        jengine, jengine.Request, reqs, n_routes, monkeypatch)
    teng, tticks = serve(
        lambda: ServeEngine(tm, batch_slots=SLOTS, max_len=MAX_LEN,
                            telemetry=ttel, device="cpu"),
        tengine, Request, reqs, n_routes, monkeypatch)
    big = teng.slo._cap_routes * teng.slo.n_metrics > SLOFleet.DENSE_LANES_MAX
    assert big == (n_routes > 1365)
    assert tticks == jticks
    jdone = {r.rid: r for r in jeng.done}
    tdone = {r.rid: r for r in teng.done}
    assert sorted(tdone) == sorted(jdone) == list(range(len(reqs)))
    for rid, r in tdone.items():
        assert r.output == jdone[rid].output, rid
        assert (r.t_submit, r.t_first, r.t_done) == \
            (jdone[rid].t_submit, jdone[rid].t_first, jdone[rid].t_done)
    # The long prompt ran past the cache and ended after one token.
    assert len(tdone[4].output) == 1
    js, ts = jeng.stats_summary(), teng.stats_summary()
    assert list(ts) == list(js)
    for route in js:
        assert [np.float32(ts[route][m]).view(np.int32) for m in ts[route]] \
            == [np.float32(js[route][m]).view(np.int32) for m in js[route]]
    for name in ("_m", "_step", "_sign", "_ticks"):
        np.testing.assert_array_equal(bits(getattr(teng.slo, name)),
                                      bits(getattr(jeng.slo, name)), name)
    assert ttel.counters() == jtel.counters()
    assert ttel.counters()["requests_completed"] == len(reqs)
    assert ttel.counters()["slo_flushes"] == tticks
    return teng


def test_engine_refuses_a_model_on_another_device(pair, monkeypatch):
    _, _, tm = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(tm)
    with pytest.raises(ValueError, match="lives on cpu"):
        ServeEngine(tm, device="meta")


def test_launcher_serves_on_cpu_and_needs_a_card_by_default(capsys,
                                                            monkeypatch):
    import json

    launch_serve.main(["--device", "cpu", "--requests", "3",
                       "--max-new", "2", "--slots", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["served"] == 3 and out["device"] == "cpu"
    assert set(out["stats"]["default"]) == {"ttft_q99_ms", "tok_q50_ms",
                                            "len_q50"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch_serve.main(["--requests", "1"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_serves_moe_archs_on_cpu(arch, capsys):
    import json

    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--slots", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch and out["served"] == 3


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launcher_serves_recurrent_archs_on_cpu(arch, capsys):
    import json

    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--slots", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch and out["served"] == 3


def test_build_model_serves_through_the_engine():
    """Fresh weights (build_model) through the engine: every request gets
    its tokens; the SLO fleet saw one ttft, one length and one
    per-token event per token."""
    cfg = reduce_for_smoke(get_config("minitron-4b"))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    eng = ServeEngine(model, batch_slots=2, max_len=32, device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[1 + rid, 2, 3],
                           max_new_tokens=3 + rid, route=f"r{rid % 2}"))
    eng.run_until_drained()
    assert sorted(len(r.output) for r in eng.done) == [3, 4, 5]
    assert int(eng.slo._ticks.sum()) == 2 * 3 + (3 + 4 + 5)
