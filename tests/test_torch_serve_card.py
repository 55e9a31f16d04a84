"""The serving slice on the card against the same code on the CPU, and
the golden file's serving entry on both. Imports no JAX, so the card
tests run where JAX is not installed (marker ``cuda``, skipped without a
CUDA device):

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_serve_card.py

* The golden entry (``serve/*`` of ``tests/data/torch_port_golden.npz``):
  the JAX package's reduced yi-6b weights through ``params_from_numpy``
  and the port's engine under the golden maker's fake clock give the JAX
  engine's tokens, first step logits (within 1e-4 absolute), summary and
  SLO state (bit for bit); on the CPU and on the card.
* The golden MoE entries (``moe/<arch>/*``, olmoe-1b-7b and
  deepseek-v2-lite-16b narrowed): the JAX package's weights through
  ``train_state_from_numpy``; a forward's expert loads and drop
  fractions bit for bit (the routing); the engine's tokens, first step
  logits within 1e-4, summary and SLO state bit for bit; four
  ``train_step``s with each loss within 1e-5 relative (1e-4 on the
  card, as phase 14 holds later losses) and the expert-load fleet bit for
  bit after each; on the CPU and on the card.
* The golden recurrent entries (``ssm/<name>/*``: zamba2-2.7b,
  rwkv6-1.6b and its H1 factorized form, narrowed, every parameter
  redrawn): the JAX package's ``TrainState`` through
  ``train_state_from_numpy``; ``forward`` logits within 1e-4; the
  engine's tokens, first step logits within 1e-4, summary and SLO state
  bit for bit (the lockstep prefill advances every row's recurrent
  state, as the JAX engine's does); four ``train_step``s with each loss
  within 1e-5 relative (1e-4 on the card), both activation fleets' sign
  planes and cursors bit for bit and their m and step planes within
  SSM_STATS_REL = 1e-5 x |m| (1e-4 on the card: where the 2U tick sets
  m to the statistic, which the chunked forward computes within float
  rounding of the JAX package's); on the CPU and on the card.
* The golden encoder-decoder entry (``encdec/*``: the reduced
  whisper-large-v3 at attention chunks of 16, every parameter redrawn):
  the JAX package's parameters through ``params_from_numpy``; ``encode``'s
  memory, ``forward``'s logits and the 12 ``serve_step`` calls' logits
  with the memory (``make_serve_step(model, encdec_memory=True)``) each
  within ENCDEC_REL = 1e-4 x its max |value|, the greedy tokens equal,
  the loss within 1e-5 relative; three ``train_step``s from
  ``create_train_state`` (which makes the JAX package's initial state)
  with each loss and grad norm within 1e-5 relative (1e-4 on the card),
  the clip's and both activation fleets' sign planes and the fleets'
  cursors bit for bit, their m and step planes within SSM_STATS_REL x
  |m|; on the CPU and on the card.
* The five attention-only configs, the two MoE configs and the two
  recurrent configs, reduced (float32), fresh weights from a seeded
  generator: ``forward`` and 8
  ``decode_step``s on the card within 1e-4 absolute of the CPU.
* The engine on the card against the engine on the CPU under the fake
  clock, on both flush branches: tokens equal, SLO state bit for bit, one
  run kernel launch per flush on the sparse branch; the launcher on the
  card.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import frugal_update as tkernel
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import engine as tengine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_port_golden as golden  # noqa: E402

ARCHS = ("yi-6b", "gemma2-9b", "granite-20b", "minitron-4b", "qwen2-vl-2b",
         "olmoe-1b-7b", "deepseek-v2-lite-16b", "zamba2-2.7b", "rwkv6-1.6b")
LOGIT_TOL = 1e-4
MOE_LOSS_REL = {"cpu": 1e-5, "cuda": 1e-4}
SSM_STATS_REL = {"cpu": 1e-5, "cuda": 1e-4}
ENCDEC_REL = 1e-4


def bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-q -m cuda --noconftest tests/test_torch_serve_card.py)")
    return torch.device("cuda")


def golden_results(device, monkeypatch):
    data = np.load(golden.GOLDEN)
    cfg = golden.serve_config(reduce_for_smoke(get_config(golden.SERVE_ARCH)))
    model = params_from_numpy(cfg, golden.unflatten_params(data),
                              device=device)
    np.testing.assert_array_equal(
        np.concatenate([p for p, _, _ in golden.serve_requests()]),
        data["serve/prompts"])
    monkeypatch.setattr(tengine, "time", golden.FakeClock())
    eng = ServeEngine(model, batch_slots=golden.SERVE_SLOTS,
                      max_len=golden.SERVE_MAX_LEN, device=device)
    return golden.serve_engine_results(eng, Request), data


def assert_golden(got, data):
    for key in ("serve/outputs", "serve/output_lengths"):
        np.testing.assert_array_equal(got[key], data[key])
    np.testing.assert_allclose(got["serve/first_step_logits"],
                               data["serve/first_step_logits"], rtol=0,
                               atol=LOGIT_TOL)
    for key in ("serve/summary", "serve/slo/m", "serve/slo/step",
                "serve/slo/sign", "serve/slo/ticks"):
        np.testing.assert_array_equal(bits(got[key]), bits(data[key]), key)


def test_golden_serving_entry_on_cpu(monkeypatch):
    assert_golden(*golden_results("cpu", monkeypatch))


@pytest.mark.cuda
def test_golden_serving_entry_on_card(card, monkeypatch):
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert_golden(*golden_results(card, monkeypatch))


def check_golden_moe(arch, device, monkeypatch):
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import make_train_step

    data = np.load(golden.GOLDEN)
    key = f"moe/{arch}"
    cfg = golden.moe_config(reduce_for_smoke(get_config(arch)))
    st = train_state_from_numpy(cfg, golden.train_state_tree(
        data, f"{key}/init"), device=device)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in golden.moe_train_batches(data, arch)]
    with torch.no_grad():
        _, stats = st.params(batches[0]["tokens"])
    for name in ("expert_load", "drop_fraction"):
        np.testing.assert_array_equal(
            bits(stats["stack"][0][name]), bits(data[f"{key}/route/{name}"]))
    monkeypatch.setattr(tengine, "time", golden.FakeClock())
    eng = ServeEngine(st.params, batch_slots=golden.SERVE_SLOTS,
                      max_len=golden.SERVE_MAX_LEN, device=device)
    got = golden.serve_engine_results(eng, Request)
    assert_golden(got, {k: data[f"{key}/{k}"] for k in got})
    step = make_train_step(st.params, Optimizer(
        kind="adamw", lr_fn=warmup_cosine(*golden.TRAIN_LR)))
    rel = MOE_LOSS_REL[torch.device(device).type]
    for i, b in enumerate(batches):
        st, met = step(st, b)
        assert float(met["loss"]) == pytest.approx(
            float(data[f"{key}/train/loss"][i]), rel=rel), i
        fleet = st.monitors.expert_load_q99
        assert fleet.device.type == torch.device(device).type
        for f in ("m", "step", "sign"):
            np.testing.assert_array_equal(
                bits(getattr(fleet.state, f)),
                bits(data[f"{key}/train/{f}"][i]), (i, f))
        assert [int(x) for x in fleet.cursor] == \
            data[f"{key}/train/cursor"][i].tolist()


@pytest.mark.parametrize("arch", golden.MOE_ARCHS)
def test_golden_moe_entry_on_cpu(arch, monkeypatch):
    check_golden_moe(arch, "cpu", monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", golden.MOE_ARCHS)
def test_golden_moe_entry_on_card(card, arch, monkeypatch):
    assert torch.backends.cuda.matmul.allow_tf32 is False
    check_golden_moe(arch, card, monkeypatch)


def check_golden_ssm(name, device, monkeypatch):
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import make_train_step

    data = np.load(golden.GOLDEN)
    key = f"ssm/{name}"
    arch, factorized = golden.SSM_MODELS[name]
    cfg = golden.ssm_config(reduce_for_smoke(get_config(arch)), factorized)
    st = train_state_from_numpy(cfg, golden.train_state_tree(
        data, golden.ssm_init_prefix(name)), device=device)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in golden.ssm_train_batches(data, name)]
    with torch.no_grad():
        logits, _ = st.params(batches[0]["tokens"])
    np.testing.assert_allclose(logits.cpu().numpy(),
                               data[f"{key}/forward/logits"], rtol=0,
                               atol=LOGIT_TOL)
    monkeypatch.setattr(tengine, "time", golden.FakeClock())
    eng = ServeEngine(st.params, batch_slots=golden.SERVE_SLOTS,
                      max_len=golden.SERVE_MAX_LEN, device=device)
    got = golden.serve_engine_results(eng, Request)
    assert_golden(got, {k: data[f"{key}/{k}"] for k in got})
    step = make_train_step(st.params, Optimizer(
        kind="adamw", lr_fn=warmup_cosine(*golden.TRAIN_LR)))
    kind = torch.device(device).type
    for i, b in enumerate(batches):
        st, met = step(st, b)
        assert float(met["loss"]) == pytest.approx(
            float(data[f"{key}/train/loss"][i]), rel=MOE_LOSS_REL[kind]), i
        for mon in golden.TRAIN_MONITORS:
            fleet, pre = getattr(st.monitors, mon), f"{key}/train/{mon}"
            assert fleet.device.type == kind
            np.testing.assert_array_equal(bits(fleet.state.sign),
                                          bits(data[f"{pre}/sign"][i]))
            scale = np.abs(data[f"{pre}/m"][i])
            for f in ("m", "step"):
                err = np.abs(getattr(fleet.state, f).cpu().numpy()
                             - data[f"{pre}/{f}"][i])
                assert (err <= SSM_STATS_REL[kind] * scale).all(), (i, f)
            assert [int(x) for x in fleet.cursor] == \
                data[f"{pre}/cursor"][i].tolist()


@pytest.mark.parametrize("name", sorted(golden.SSM_MODELS))
def test_golden_ssm_entry_on_cpu(name, monkeypatch):
    check_golden_ssm(name, "cpu", monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(golden.SSM_MODELS))
def test_golden_ssm_entry_on_card(card, name, monkeypatch):
    assert torch.backends.cuda.matmul.allow_tf32 is False
    check_golden_ssm(name, card, monkeypatch)


def close_to_max(got, want, rel=ENCDEC_REL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().cpu().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def check_golden_encdec(device):
    from repro_torch.core import rng as crng
    from repro_torch.optim import Optimizer, warmup_cosine
    from repro_torch.train import (create_train_state, make_serve_step,
                                   make_train_step)

    data = np.load(golden.GOLDEN)
    cfg = golden.encdec_config(reduce_for_smoke(get_config(
        golden.ENCDEC_ARCH)))
    model = params_from_numpy(cfg, golden.unflatten_params(
        data, "encdec/params"), device=device)
    batch = {k: torch.from_numpy(data[f"encdec/{k}"]).to(device)
             for k in ("frames", "tokens", "targets")}
    with torch.no_grad():
        memory = model.encode(batch["frames"])
        logits, _ = model(batch["frames"], batch["tokens"])
        loss, _ = model.loss(batch)
    close_to_max(memory, data["encdec/memory"])
    close_to_max(logits, data["encdec/forward/logits"])
    assert float(loss) == pytest.approx(float(data["encdec/forward/loss"]),
                                        rel=1e-5)
    serve = make_serve_step(model, encdec_memory=True)
    caches = model.init_cache(golden.ENCDEC_BATCH, golden.ENCDEC_MAX_LEN)
    tok = torch.from_numpy(data["encdec/serve/start"]).to(device)
    for pos in range(golden.ENCDEC_DECODE_STEPS):
        lg, caches = serve(tok, caches, pos, memory)
        close_to_max(lg[:, 0], data["encdec/serve/logits"][pos])
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(tok[:, 0].cpu().numpy(),
                                      data["encdec/serve/tokens"][pos])
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*golden.TRAIN_LR))
    st = create_train_state(model, opt, crng.prng_key(0),
                            example_batch=batch)
    assert [st.monitors.n_act_groups, st.monitors.n_moe_groups] == \
        data["encdec/train/n_groups"].tolist()
    step = make_train_step(model, opt)
    kind = torch.device(device).type
    rel = SSM_STATS_REL[kind]
    for i in range(golden.ENCDEC_TRAIN_STEPS):
        st, met = step(st, batch)
        for k in ("loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(
                float(data[f"encdec/train/{k}"][i]),
                rel=MOE_LOSS_REL[kind]), (i, k)
        planes = [("qclip", st.qclip.sketch)] + [
            (mon, getattr(st.monitors, mon).state)
            for mon in golden.TRAIN_MONITORS]
        for name, sk in planes:
            pre = f"encdec/train/{name}" + ("_" if name == "qclip" else "/")
            np.testing.assert_array_equal(bits(sk.sign),
                                          bits(data[f"{pre}sign"][i]))
            scale = np.abs(data[f"{pre}m"][i])
            for f in ("m", "step"):
                err = np.abs(getattr(sk, f).cpu().numpy()
                             - data[f"{pre}{f}"][i])
                assert (err <= rel * scale).all(), (i, name, f)
        for mon in golden.TRAIN_MONITORS:
            assert [int(x) for x in getattr(st.monitors, mon).cursor] == \
                data[f"encdec/train/{mon}/cursor"][i].tolist()


def test_golden_encdec_entry_on_cpu():
    check_golden_encdec("cpu")


@pytest.mark.cuda
def test_golden_encdec_entry_on_card(card):
    assert torch.backends.cuda.matmul.allow_tf32 is False
    check_golden_encdec(card)


def cpu_model(arch, seed=0):
    cfg = reduce_for_smoke(get_config(arch))
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_model_equals_cpu(card, arch):
    host = cpu_model(arch)
    dev = copy.deepcopy(host).to(card)
    cfg = host.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    t_host = torch.from_numpy(toks)
    with torch.no_grad():
        want, _ = host(t_host)
        got, _ = dev(t_host.to(card))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    hc, dc = host.init_cache(2, 16), dev.init_cache(2, 16)
    for pos in range(8):
        want, hc = host.decode_step(t_host[:, pos:pos + 1], hc, pos)
        got, dc = dev.decode_step(t_host[:, pos:pos + 1].to(card), dc, pos)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n_routes", [5, 1400], ids=["dense", "sparse"])
def test_card_engine_equals_cpu_engine(card, n_routes, monkeypatch):
    host = cpu_model("yi-6b", seed=2)
    rng = np.random.default_rng(3)
    reqs = [dict(rid=i, prompt=rng.integers(
        0, host.cfg.vocab_size, 30 if i == 4 else int(rng.integers(1, 7))
    ).tolist(), max_new_tokens=int(rng.integers(2, 7)),
        route=f"route-{int((rng.zipf(1.2) - 1) % n_routes)}")
        for i in range(9)]
    engines = []
    for model, device in ((host, "cpu"),
                          (copy.deepcopy(host).to(card), card)):
        monkeypatch.setattr(tengine, "time", golden.FakeClock())
        eng = ServeEngine(model, batch_slots=3, max_len=24, device=device)
        if n_routes > 64:
            eng.slo.ensure_routes(f"route-{i}" for i in range(n_routes))
        for r in reqs:
            eng.submit(Request(**r))
        before = tkernel.scatter_launch_count
        ticks = eng.run_until_drained()
        engines.append((eng, ticks, tkernel.scatter_launch_count - before))
    (want, wticks, _), (got, gticks, launches) = engines
    assert gticks == wticks
    assert launches == (gticks if n_routes > 1365 else 0)
    assert {r.rid: r.output for r in got.done} == \
        {r.rid: r.output for r in want.done}
    for name in ("_m", "_step", "_sign", "_ticks"):
        np.testing.assert_array_equal(bits(getattr(got.slo, name)),
                                      bits(getattr(want.slo, name)), name)


@pytest.mark.cuda
def test_card_launcher_serves(card, capsys):
    import json

    launch_serve.main(["--requests", "3", "--max-new", "2", "--slots", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["served"] == 3 and out["device"] == "cuda"
