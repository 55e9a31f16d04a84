"""The port's counter hash, uniforms, seeds and (step, sign) packing
against the JAX package, bit-exact, on edge ticks (0, ±2^31, across the
wrap), lanes up to 2^24, and the packing domain map pinned in
tests/test_packing.py (exact, saturate, flush, NaN)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import packing as jpacking
from repro.core import rng as jrng
from repro_torch.core import packing as tpacking
from repro_torch.core import rng as trng

TICKS = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 2 ** 31 - 3,
         123456789]


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 987654])
@pytest.mark.parametrize("t", TICKS)
def test_counter_bits_and_uniform_match(seed, t):
    lanes = np.concatenate([np.arange(64), 2 ** 24 - np.arange(1, 65),
                            np.random.default_rng(0).integers(
                                0, 2 ** 24, 256)]).astype(np.int32)
    want_bits = np.asarray(jrng.counter_bits(seed, t, jnp.asarray(lanes)))
    want_u = np.asarray(jrng.counter_uniform(seed, t, jnp.asarray(lanes)))
    tl = torch.from_numpy(lanes)
    np.testing.assert_array_equal(trng.counter_bits(seed, t, tl).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(
        trng.counter_uniform(seed, t, tl).numpy().view(np.int32),
        want_u.view(np.int32))


def test_counter_uniform_per_lane_ticks_across_the_wrap():
    t = (np.arange(-300, 300) + 2 ** 31).astype(np.int64)
    t32 = np.asarray([jrng.wrap_i32(int(x)) for x in t], np.int32)
    lanes = np.arange(t32.size, dtype=np.int32) * 977
    want = np.asarray(jrng.counter_uniform(5, jnp.asarray(t32),
                                           jnp.asarray(lanes)))
    got = trng.counter_uniform(5, torch.from_numpy(t32),
                               torch.from_numpy(lanes)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("n", [0, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 7,
                               -(2 ** 31) - 1, 3 * 2 ** 40])
def test_wrap_i32_matches(n):
    assert trng.wrap_i32(n) == jrng.wrap_i32(n)


@pytest.mark.parametrize("k", [0, 1, 42, 2 ** 31 - 1])
def test_seed_from_key_words_match(k):
    words = np.asarray(jax.random.key_data(jax.random.PRNGKey(k)))
    assert words.dtype == np.uint32
    want = int(jrng.seed_from_key(jnp.asarray(words)))
    assert trng.seed_from_key(words) == want
    typed = int(jrng.seed_from_key(jax.random.key(k)))
    assert trng.seed_from_key(
        np.asarray(jax.random.key_data(jax.random.key(k)))) == typed


def test_seed_from_key_int_and_range():
    assert trng.seed_from_key(-5) == -5
    with pytest.raises(ValueError, match="outside int32"):
        trng.seed_from_key(2 ** 31)
    with pytest.raises(TypeError):
        trng.seed_from_key(np.asarray([1.5]))


# ------------------------------------------------------------------ packing
_MAX = float(jpacking._MAX_STEP)
IN_DOMAIN = [0.0, -0.0, 1.0, -1.0, 2.0 ** -63, -(2.0 ** -63), 0.75, 1e6,
             _MAX, -_MAX, 3.5, 1234567.0]
SATURATE = [2.0 ** 32, -(2.0 ** 32), 1e38, float("inf"), float("-inf")]
FLUSH = [2.0 ** -64, -(2.0 ** -64), 1e-40, 5e-324, float("nan")]


def _jax_pack(step, sign):
    return np.asarray(jpacking.pack_step_sign(
        jnp.asarray(step, jnp.float32), jnp.asarray(sign, jnp.float32)))


@pytest.mark.parametrize("domain", [IN_DOMAIN, SATURATE, FLUSH],
                         ids=["exact", "saturate", "flush-nan"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_pack_unpack_domain_map(domain, sign):
    step = np.asarray(domain, np.float32)
    sg = np.full_like(step, sign)
    want = _jax_pack(step, sg)
    got = tpacking.pack_step_sign(torch.from_numpy(step),
                                  torch.from_numpy(sg))
    np.testing.assert_array_equal(got.numpy(), want)
    js, jg = jpacking.unpack_step_sign(jnp.asarray(want))
    ts, tg = tpacking.unpack_step_sign(got)
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_word_canonical_predicate_matches_over_the_exponent_field():
    rng = np.random.default_rng(3)
    e = np.repeat(np.arange(256, dtype=np.uint32), 8)
    mant = rng.integers(0, 2 ** 23, e.size).astype(np.uint32)
    mant[::8] = 0
    top = rng.integers(0, 2, e.size).astype(np.uint32)
    words = ((top << 31) | (e << 23) | mant).view(np.int32)
    want = np.asarray(jpacking.step_sign_word_canonical(jnp.asarray(words)))
    got = tpacking.step_sign_word_canonical(torch.from_numpy(words))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_frugal2u_pack_roundtrip_matches():
    from repro.core import frugal as jfrugal
    from repro_torch.core import frugal as tfrugal

    rng = np.random.default_rng(8)
    m = rng.normal(0, 100, 64).astype(np.float32)
    step = rng.integers(-9, 10, 64).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], 64).astype(np.float32)
    jp = jpacking.pack_frugal2u(jfrugal.Frugal2UState(
        jnp.asarray(m), jnp.asarray(step), jnp.asarray(sign)))
    tp = tpacking.pack_frugal2u(tfrugal.Frugal2UState(
        torch.from_numpy(m), torch.from_numpy(step), torch.from_numpy(sign)))
    np.testing.assert_array_equal(tp.step_sign.numpy(),
                                  np.asarray(jp.step_sign))
    back = tpacking.unpack_frugal2u(tp)
    for a, b in zip(back, (m, step, sign)):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.view(np.int32))


# ------------------------------------------------------------- threefry
def _keys(n, seed):
    rng = np.random.default_rng(seed)
    edge = [[0, 0], [0, 1], [2 ** 32 - 1, 2 ** 32 - 1], [2 ** 31, 0],
            [0, 2 ** 31 - 1]]
    return np.concatenate([np.asarray(edge, np.uint32),
                           rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64)
                           .astype(np.uint32)])


@pytest.mark.parametrize("seed", [0, 1, -1, 5, -5, 2 ** 31 - 1, -2 ** 31,
                                  987654])
def test_prng_key_matches(seed):
    np.testing.assert_array_equal(trng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    with pytest.raises(ValueError, match="int32"):
        trng.prng_key(2 ** 31)


@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches_jax_random(num):
    """threefry2x32 split under jax_threefry_partitionable (JAX's default)
    on 69 keys, edge words included: every child's words equal."""
    assert jax.config.jax_threefry_partitionable
    for k in _keys(64, num):
        np.testing.assert_array_equal(
            trng.split(k, num), np.asarray(jax.random.split(k, num)))


def test_fold_in_matches_jax_random():
    rng = np.random.default_rng(7)
    data = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1] + \
        rng.integers(0, 2 ** 32, 20).tolist()
    for k in _keys(16, 3):
        for d in data:
            np.testing.assert_array_equal(
                trng.fold_in(k, d), np.asarray(jax.random.fold_in(k, d)))


def test_split_chain_drives_tick_uniforms_as_jax():
    """The training step's key chain: split the state key every step and
    draw the clip's uniforms from the second child, 50 steps."""
    jkey = jax.random.PRNGKey(3)
    tkey = trng.prng_key(3)
    for _ in range(50):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = trng.split(tkey)
        np.testing.assert_array_equal(tkey, np.asarray(jkey))
        np.testing.assert_array_equal(
            trng.tick_uniforms(tsub, 7, device="cpu").numpy().view(np.int32),
            np.asarray(jrng.tick_uniforms(jsub, 7)).view(np.int32))
