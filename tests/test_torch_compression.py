"""Gradient compression (int8 + error feedback): the port's
``parallel/compression.py`` against the JAX package's eager functions, bit
for bit, and the four properties of ``tests/test_compression.py``.

The inputs hold values whose quotient by 127 differs from their product
with the float32 reciprocal of 127 (eager JAX divides; JAX under ``jit``,
and PyTorch on CUDA dividing by a Python number, multiply by the
reciprocal), exact .5 ties after the division (both packages round half
to even), an all-zero tensor (the 1e-12 scale floor) and bf16 gradients.

``compressed_psum`` is held against the JAX function under ``shard_map``
on forced host devices, in a subprocess (the host device count is fixed
when JAX starts), at R = 8, 6, 3 and 1 over two error-feedback rounds.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as jc
from repro_torch.parallel import compression as tc


def recip_differs(a):
    a = np.asarray(a, np.float32)
    return (a / np.float32(127.0)) != (a * (np.float32(1.0)
                                            / np.float32(127.0)))


def inputs():
    rng = np.random.default_rng(0)
    normal = rng.normal(0, 3.0, (256, 128)).astype(np.float32)
    # amax values whose scale differs between a / 127 and a * (1 / 127)
    amaxes = rng.uniform(0.1, 10.0, 4096).astype(np.float32)
    amax = amaxes[recip_differs(amaxes)][0]
    divided = rng.uniform(-1.0, 1.0, (64, 33)).astype(np.float32) * amax
    divided[0, 0] = amax
    # x / scale lands exactly on k + 0.5 (scale = 127 / 127 = 1)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 3.5],
                    np.float32)
    zero = np.zeros((16, 8), np.float32)
    bf16 = torch.from_numpy(rng.normal(0, 0.01, (96, 40)).astype(
        np.float32)).to(torch.bfloat16)
    return {"normal": normal, "divided": divided, "ties": ties,
            "zero": zero, "bf16": bf16}


def to_jax(x):
    if isinstance(x, torch.Tensor):       # bf16: through float32, exact
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x)


def to_torch(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


def bits_equal(t, j):
    t = t.detach().numpy().reshape(-1)
    j = np.asarray(j)
    return t.dtype == j.dtype and t.size == j.size and \
        np.array_equal(t.view(np.uint8), j.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("name", list(inputs()))
def test_quantize_and_dequantize_give_eager_jax_bits(name):
    x = inputs()[name]
    q, s = tc.quantize_int8(to_torch(x))
    jq, js = jc.quantize_int8(to_jax(x))
    assert bits_equal(q, jq) and bits_equal(s, js)
    assert bits_equal(tc.dequantize_int8(q, s), jc.dequantize_int8(jq, js))
    if name == "divided":
        assert recip_differs(np.abs(x).max())
        assert float(s) == np.float32(np.abs(x).max()) / np.float32(127.0)
    if name == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 126, -126, 4]
    if name == "zero":
        assert float(s) == np.float32(1e-12) and not q.any()


def test_compress_grads_and_wire_bytes_give_eager_jax_bits():
    xs = inputs()
    rng = np.random.default_rng(1)
    ef = {k: rng.normal(0, 0.01, np.shape(v)).astype(np.float32)
          for k, v in xs.items()}
    ef["zero"][:] = 0.0
    grads = {k: to_torch(v) for k, v in xs.items()}
    q, s, new_ef = tc.compress_grads(
        grads, {k: torch.from_numpy(v) for k, v in ef.items()})
    jq, js, jef = jc.compress_grads({k: to_jax(v) for k, v in xs.items()},
                                    {k: jnp.asarray(v) for k, v in ef.items()})
    for k in xs:
        assert bits_equal(q[k], jq[k]) and bits_equal(s[k], js[k])
        assert bits_equal(new_ef[k], jef[k]), k
    deq = tc.decompress_grads(q, s)
    jdeq = jc.decompress_grads(jq, js)
    assert all(bits_equal(deq[k], jdeq[k]) for k in xs)
    init = tc.ef_init(grads)
    assert all(v.dtype == torch.float32 and not v.any() and
               v.shape == grads[k].shape for k, v in init.items())
    for compressed in (False, True):
        assert tc.wire_bytes(grads, compressed) == jc.wire_bytes(
            {k: to_jax(v) for k, v in xs.items()}, compressed)


# ------------------------------------- tests/test_compression.py's four
def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 3.0, (256, 128)).astype(np.float32))
    q, s = tc.quantize_int8(x)
    err = torch.abs(tc.dequantize_int8(q, s) - x)
    assert q.dtype == torch.int8
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_telescopes():
    rng = np.random.default_rng(1)
    ef = tc.ef_init({"w": torch.zeros((64, 64))})
    true_sum = np.zeros((64, 64), np.float32)
    sent_sum = np.zeros((64, 64), np.float32)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(0, 1.0, (64, 64)).astype(
            np.float32))}
        true_sum += g["w"].numpy()
        q, s, ef = tc.compress_grads(g, ef)
        sent_sum += tc.decompress_grads(q, s)["w"].numpy()
    resid = np.abs(true_sum - sent_sum)
    assert resid.max() < 0.2, resid.max()


def test_wire_bytes_4x_reduction():
    grads = {"a": torch.zeros((1024, 1024)), "b": torch.zeros((512,))}
    assert tc.wire_bytes(grads, True) < tc.wire_bytes(grads, False) / 3.9


def test_sgd_with_compression_matches_uncompressed():
    rng = np.random.default_rng(2)
    target = torch.from_numpy(rng.normal(0, 1, (32,)).astype(np.float32))

    def run(compressed):
        w = torch.zeros((32,))
        ef = {"w": torch.zeros((32,))}
        for _ in range(300):
            g = {"w": 2 * (w - target)}
            if compressed:
                q, s, ef = tc.compress_grads(g, ef)
                g = tc.decompress_grads(q, s)
            w = w - 0.05 * g["w"]
        return w

    w_full, w_comp = run(False), run(True)
    np.testing.assert_allclose(w_comp.numpy(), target.numpy(), atol=0.05)
    np.testing.assert_allclose(w_comp.numpy(), w_full.numpy(), atol=0.05)


# ------------------------------------------------------- compressed_psum
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
PSUM_REPLICAS = (8, 6, 3, 1)
PSUM_LEAVES = {"big": (4096,), "odd": (7, 33), "zero": (16,)}
PSUM_ROUNDS = 2

JAX_PSUM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.parallel.compression import compressed_psum
from repro.parallel.mesh2d import shard_map_compat

src, dst, replicas, rounds = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
inp = dict(np.load(src))
names = sorted({k.split("/")[-1] for k in inp})
out = {}
for r in map(int, replicas.split(",")):
    mesh = Mesh(np.asarray(jax.devices()[:r]), ("data",))

    def body(g, ef):
        avg, ef2 = compressed_psum({k: g[k][0] for k in g},
                                   {k: ef[k][0] for k in ef}, "data")
        return ({k: v[None] for k, v in avg.items()},
                {k: v[None] for k, v in ef2.items()})

    f = shard_map_compat(body, mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P("data"), P("data")))
    ef = {k: jnp.zeros_like(jnp.asarray(inp[f"0/{k}"][:r])) for k in names}
    for rnd in range(int(rounds)):
        g = {k: jnp.asarray(inp[f"{rnd}/{k}"][:r]) for k in names}
        avg, ef = f(g, ef)
        for k in names:
            out[f"{r}/{rnd}/avg/{k}"] = np.asarray(avg[k])
            out[f"{r}/{rnd}/ef/{k}"] = np.asarray(ef[k])
np.savez(dst, **out)
print("JAX_PSUM_OK")
"""


def psum_inputs():
    """Round rnd's gradients of 8 replicas, stacked on a leading axis:
    ``{f"{rnd}/{leaf}": [8, ...]}`` (the all-zero leaf hits the scale
    floor)."""
    rng = np.random.default_rng(3)
    out = {}
    for rnd in range(PSUM_ROUNDS):
        for k, shape in PSUM_LEAVES.items():
            x = rng.normal(0, 1.0, (8,) + shape) * rng.uniform(
                0.5, 4.0, (8,) + (1,) * len(shape))
            out[f"{rnd}/{k}"] = (x if k != "zero" else 0 * x).astype(
                np.float32)
    return out


@pytest.fixture(scope="module")
def jax_psum(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    np.savez(tmp / "in.npz", **psum_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", JAX_PSUM, str(tmp / "in.npz"),
         str(tmp / "out.npz"), ",".join(map(str, PSUM_REPLICAS)),
         str(PSUM_ROUNDS)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "JAX_PSUM_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("replicas", PSUM_REPLICAS)
def test_compressed_psum_gives_shard_map_bits(jax_psum, replicas):
    """Every replica's average and new ef equal the JAX package's
    ``compressed_psum`` under ``shard_map`` bit for bit, over two rounds,
    the second fed the first's ef. Where 1/R is inexact, a reciprocal
    multiply would give other bits for some values: the IEEE quotient is
    what is held."""
    inp = psum_inputs()
    ef = [tc.ef_init({k: torch.from_numpy(inp[f"0/{k}"][r])
                      for k in PSUM_LEAVES}) for r in range(replicas)]
    n = np.float32(replicas)
    for rnd in range(PSUM_ROUNDS):
        grads = [{k: torch.from_numpy(inp[f"{rnd}/{k}"][r])
                  for k in PSUM_LEAVES} for r in range(replicas)]
        deq = [tc.decompress_grads(*tc.compress_grads(g, e)[:2])
               for g, e in zip(grads, ef)]
        avgs, ef = tc.compressed_psum(grads, ef)
        assert len(avgs) == len(ef) == replicas
        for k in PSUM_LEAVES:
            want_avg = jax_psum[f"{replicas}/{rnd}/avg/{k}"]
            want_ef = jax_psum[f"{replicas}/{rnd}/ef/{k}"]
            for r in range(replicas):
                np.testing.assert_array_equal(avgs[r][k].numpy(),
                                              want_avg[r])
                np.testing.assert_array_equal(ef[r][k].numpy(), want_ef[r])
            # each replica holds its own copy
            assert len({a[k].data_ptr() for a in avgs}) == replicas
        # the float32 left fold in replica order over the IEEE quotient
        fold = deq[0]["big"].numpy()
        for d in deq[1:]:
            fold = fold + d["big"].numpy()
        want = jax_psum[f"{replicas}/{rnd}/avg/big"][0]
        np.testing.assert_array_equal(fold / n, want)
        if replicas in (3, 6):
            assert (fold * (np.float32(1) / n) != want).any()
    assert not any(a["zero"].any() for a in avgs)


def test_compressed_dp_allreduce_8way_within_atol_of_the_mean():
    """tests/test_fault_tolerance.py's 8-way case on the port: the
    average of one round lies within 0.05 of the float32 mean."""
    rng = np.random.default_rng(0)
    g_global = rng.normal(0, 1, (8, 64)).astype(np.float32)
    avgs, _ = tc.compressed_psum(
        [{"g": torch.from_numpy(g)} for g in g_global],
        [{"g": torch.zeros(64)} for _ in range(8)])
    want = np.mean(g_global, axis=0)
    for a in avgs:
        np.testing.assert_allclose(a["g"].numpy(), want, atol=0.05)


def test_compressed_psum_needs_one_ef_per_replica():
    g = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="one ef per replica"):
        tc.compressed_psum([g, g], [tc.ef_init(g)])
    with pytest.raises(ValueError, match="at least one replica"):
        tc.compressed_psum([], [])
