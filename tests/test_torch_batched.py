"""The port's batched binomial update (``repro_torch.core.batched``,
``GroupedQuantileSketch.ingest_tensor``) held to the claims of the JAX
package's ``tests/test_batched.py``, on the CPU.

The contract is distributional, not bitwise: the JAX package draws its
normals with ``jax.random.normal``, the port from a ``torch.Generator``
seeded by the key words. Claims: the fixed point F(m) = q within the
relative-mass-error bands of the JAX tests (median 0.06, tails 0.08), the
drift bound of a burst, ``group_axis``, 1U with a frozen step, the batch
hull; and determinism under one key.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Frugal2UState, GroupedQuantileSketch
from repro_torch.core import rng as trng
from repro_torch.core.batched import batched_frugal2u_update
from repro_torch.core.reference import relative_mass_error


def run(sk, draw, steps, key):
    pooled = []
    for _ in range(steps):
        x = draw()
        pooled.append(x)
        key, sub = trng.split(key)
        sk = sk.ingest_tensor(torch.from_numpy(x), sub, group_axis=-1)
    return sk, np.concatenate(pooled, 0)


def test_batched_fixed_point_median():
    rng = np.random.default_rng(0)
    g, b = 8, 256
    sk = GroupedQuantileSketch.create(g, quantile=0.5, algo="2u", init=0.0,
                                      device="cpu")
    sk, pooled = run(sk, lambda: rng.normal(200.0, 50.0, (b, g))
                     .astype(np.float32), 400, trng.prng_key(0))
    for i in range(g):
        err = relative_mass_error(float(sk.m[i]),
                                  sorted(pooled[:, i].tolist()), 0.5)
        assert abs(err) < 0.06, f"group {i}: batched fixed point off {err}"


@pytest.mark.parametrize("q", [0.1, 0.9])
def test_batched_fixed_point_tail_quantiles(q):
    rng = np.random.default_rng(1)
    g, b = 4, 512
    sk = GroupedQuantileSketch.create(g, quantile=q, algo="2u", init=100.0,
                                      device="cpu")
    sk, pooled = run(sk, lambda: rng.lognormal(5.0, 1.0, (b, g))
                     .astype(np.float32), 500, trng.prng_key(1))
    for i in range(g):
        err = relative_mass_error(float(sk.m[i]),
                                  sorted(pooled[:, i].tolist()), q)
        assert abs(err) < 0.08, f"q={q} group {i}: err {err}"


def test_batched_1u_fixed_point_and_frozen_step():
    rng = np.random.default_rng(2)
    sk = GroupedQuantileSketch.create(4, quantile=0.5, algo="1u", init=0.0,
                                      device="cpu")
    sk, pooled = run(sk, lambda: rng.normal(60.0, 10.0, (256, 4))
                     .astype(np.float32), 300, trng.prng_key(2))
    assert sk.step is None
    for i in range(4):
        err = relative_mass_error(float(sk.m[i]),
                                  sorted(pooled[:, i].tolist()), 0.5)
        assert abs(err) < 0.06


def test_batched_drift_is_bounded():
    """|dm| per mega-tick <= sqrt(B) x unit: no burst flings the
    estimate."""
    g, b = 16, 1024
    st0 = Frugal2UState(m=torch.zeros(g), step=torch.ones(g),
                        sign=torch.ones(g))
    items = torch.full((b, g), 1e9)
    st1 = batched_frugal2u_update(st0, items, trng.prng_key(2), 0.5)
    # the step grew 1 -> 2 on the first same-direction tick: unit 2
    assert float((st1.m - st0.m).abs().max()) <= np.sqrt(b) * 2.0 + 1.0
    assert float(st1.m.min()) > 0


def test_ingest_tensor_group_axis_and_determinism():
    sk = GroupedQuantileSketch.create(8, quantile=0.5, device="cpu")
    x = torch.arange(4 * 16 * 8, dtype=torch.float32).reshape(4, 16, 8)
    key = trng.prng_key(3)
    out = sk.ingest_tensor(x, key, group_axis=-1)
    assert out.m.shape == (8,)
    out2 = sk.ingest_tensor(x.permute(2, 0, 1), key, group_axis=0)
    for f in ("m", "step", "sign"):
        assert torch.equal(getattr(out, f), getattr(out2, f))
    again = sk.ingest_tensor(x, key)
    assert torch.equal(again.m, out.m)


def test_ingest_tensor_refuses_drift_lanes():
    from repro_torch.core import DriftConfig

    sk = GroupedQuantileSketch.create(
        4, quantile=0.5, drift=DriftConfig(mode="decay", half_life=64),
        device="cpu")
    with pytest.raises(ValueError, match="drift"):
        sk.ingest_tensor(torch.ones(3, 4), trng.prng_key(0))


@pytest.mark.parametrize("seed", range(25))
def test_batched_never_escapes_batch_hull(seed):
    """The estimate after a mega-tick stays in [min(batch, m), max(batch,
    m)], for batches of 1, 4 and 64 (the JAX package's property test,
    on 25 fixed seeds)."""
    rng = np.random.default_rng(seed)
    g = 4
    b = (1, 4, 64)[seed % 3]
    st0 = Frugal2UState(
        m=torch.from_numpy(rng.normal(0, 10, g).astype(np.float32)),
        step=torch.from_numpy(rng.uniform(1, 20, g).astype(np.float32)),
        sign=torch.from_numpy(rng.choice([-1.0, 1.0], g).astype(np.float32)))
    items = torch.from_numpy(rng.normal(0, 10, (b, g)).astype(np.float32))
    st1 = batched_frugal2u_update(st0, items, trng.prng_key(seed), 0.5)
    lo = torch.minimum(items.min(0).values, st0.m) - 1e-3
    hi = torch.maximum(items.max(0).values, st0.m) + 1e-3
    assert bool(((st1.m >= lo) & (st1.m <= hi)).all())
