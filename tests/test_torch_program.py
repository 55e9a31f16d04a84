"""The port's lane programs and their plain ingest loop against the JAX
package: ``program_process_seeded`` for every ``test_instances()`` program,
bit-exact, across lanes_per_group, lane offsets, ticks across the int32
wrap (so the window rules see negative ticks), NaN ticks, and negative and
duplicate items; plus the registry and the word layout."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import frugal as jfrugal
from repro.core import program as jprogram
from repro_torch.core import frugal as tfrugal
from repro_torch.core import program as tprogram

PAIRS = list(zip(jprogram.test_instances(), tprogram.test_instances()))
IDS = [p.family for p, _ in PAIRS]


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def case(prog, g, q, t, seed):
    rng = np.random.default_rng(seed)
    lanes = g * q
    items = rng.integers(-300, 300, (t, g)).astype(np.float32)
    items[:, 0] = items[0, 0]                       # one duplicate stream
    items[rng.random((t, g)) < 0.07] = np.nan
    items[t // 2] = np.nan                          # an all-NaN row
    quantile = np.tile(rng.uniform(0.05, 0.95, q).astype(np.float32), g)
    planes = []
    for f in prog.layout.plane_fields:
        if f in prog.layout.heads:
            planes.append(rng.normal(0.0, 50.0, lanes).astype(np.float32))
        elif f.startswith("step"):
            planes.append(rng.integers(-4, 5, lanes).astype(np.float32))
        else:
            planes.append(rng.choice([-1.0, 1.0], lanes).astype(np.float32))
    return items, quantile, planes


@pytest.mark.parametrize("offsets", [(0, 0), (2 ** 31 - 250, 17),
                                     (-2 ** 31 + 3, 2 ** 31 - 40)],
                         ids=["zero", "wrap", "negative"])
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_program_process_seeded_matches_jax(pair, q, offsets):
    jprog, tprog = pair
    g, t = 37, 500
    t_off, g_off = offsets
    items, quantile, planes = case(tprog, g, q, t, seed=q + g_off % 7)
    jp, jtr = jfrugal.program_process_seeded(
        jprog, tuple(jnp.asarray(p) for p in planes), jnp.asarray(items),
        -123, jnp.asarray(quantile), return_trace=True, t_offset=t_off,
        g_offset=g_off, lanes_per_group=q)
    tp, ttr = tfrugal.program_process_seeded(
        tprog, tuple(torch.from_numpy(p) for p in planes),
        torch.from_numpy(items), -123, torch.from_numpy(quantile),
        return_trace=True, t_offset=t_off, g_offset=g_off,
        lanes_per_group=q)
    for f, a, b in zip(tprog.layout.plane_fields, jp, tp):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)
    np.testing.assert_array_equal(bits(jtr), bits(ttr))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_scalar_quantile_and_fresh_state_match(pair):
    """A scalar target (0.9: rounds differently in float64) on the
    default starting state."""
    jprog, tprog = pair
    items, _, _ = case(tprog, 12, 1, 300, seed=9)
    fill = [tprog.layout.pad_fill(f) for f in tprog.layout.plane_fields]
    jp, _ = jfrugal.program_process_seeded(
        jprog, tuple(jnp.full((12,), v, jnp.float32) for v in fill),
        jnp.asarray(items), 4, 0.9)
    tp, _ = tfrugal.program_process_seeded(
        tprog, tuple(torch.full((12,), v) for v in fill),
        torch.from_numpy(items), 4, 0.9)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_registry_matches_jax():
    assert tprogram.registered_families() == jprogram.registered_families()
    for jp, tp in PAIRS:
        assert (jp.family, jp.algo, jp.kernel_family) == \
            (tp.family, tp.algo, tp.kernel_family)
        assert jp.scalar_values() == tp.scalar_values()
        assert jp.layout.plane_fields == tp.layout.plane_fields
        assert jp.layout.packing == tp.layout.packing
        assert jp.layout.scalar_names == tp.layout.scalar_names
        assert jp.layout.query_fields == tp.layout.query_fields
        assert jp.layout.num_words == tp.layout.num_words == \
            tp.memory_words()
        for f in tp.layout.plane_fields:
            assert jp.layout.pad_fill(f) == tp.layout.pad_fill(f)
    assert tprogram.family_base("2u") is tprogram.family_base("2u")
    dec = tprogram.program_for("2u", tprogram.DriftConfig(mode="decay",
                                                          half_life=7))
    assert dec.family == "2u-decay" and dec.drift.half_life == 7
    assert tprogram.program_for("2u", dp_epsilon=2.0).family == "2u-dp"
    with pytest.raises(ValueError, match="unknown lane program"):
        tprogram.make_program("3u")
    with pytest.raises(ValueError, match="takes no"):
        tprogram.make_program("1u", window=3)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_word_layout_matches_jax(pair):
    jprog, tprog = pair
    _, _, planes = case(tprog, 16, 2, 1, seed=3)
    jw = jprog.layout.pack_planes(tuple(jnp.asarray(p) for p in planes))
    tw = tprog.layout.pack_planes(tuple(torch.from_numpy(p) for p in planes))
    assert [w.dtype for w in tw] == list(tprog.layout.word_dtypes)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(bits(a), bits(b))
    back = tprog.layout.unpack_words(tw)
    for a, b in zip(planes, back):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_query_matches_jax(pair):
    """Every family's query: head, older window plane by cursor parity,
    and the DP rule's Laplace release keyed on (seed, t_next, lane)."""
    jprog, tprog = pair
    rng = np.random.default_rng(11)
    m_planes = tuple(rng.normal(0.0, 10.0, 50).astype(np.float32)
                     for _ in tprog.layout.query_fields)
    lanes = 1000 + np.arange(50, dtype=np.int64)
    for t_next in (1, 95, 96, 97, 193, 2 ** 31 - 1):
        want = jprog.run_query(m_planes, t_next=np.int32(t_next), seed=77,
                               lanes=lanes)
        got = tprog.run_query(m_planes, t_next=np.int32(t_next), seed=77,
                              lanes=lanes)
        np.testing.assert_array_equal(bits(want), bits(got))
