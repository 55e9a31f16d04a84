"""Write tests/data/torch_port_golden.npz: JAX-package outputs that hold
the PyTorch port to the reference where JAX is not installed (the CUDA
kernels' checks in chip_smoke.py and the card tests).

Inputs come from numpy seed 0: G = 128 groups x Q = 3 quantiles = 384 lanes,
T = 256 ticks starting at t_offset = 2^31 - 64 (so the run crosses the int32
wrap), lane offset g_offset = 7, 5% NaN ticks, and a non-trivial starting
state per program. For each of the six ``test_instances()`` programs the
file holds the starting words and the words after
``repro.core.frugal.program_process_seeded``.

Sparse event rounds (keys ``sparse/*`` and ``<family>/sparse_*``): L = 1031
lanes with per-lane clocks across the int32 wrap, at negative ticks and at
window-epoch edges, lane offset 2^31 - 500 (so absolute lane ids wrap),
and 4 rounds of K = 256 slots holding distinct event lanes (some with NaN
items), mask-0 slots and a run of pads on one lane with no event. For each
program the file holds the starting planes and the planes and clocks after
the rounds through ``repro.kernels.ops.frugal_update_sparse`` on its jnp
scatter pair.

    PYTHONPATH=src python tests/make_torch_port_golden.py
"""
import os
import sys

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_golden.npz")
G, Q, T = 128, 3, 256
T_OFFSET = 2 ** 31 - 64
G_OFFSET = 7
SEED = 0          # numpy seed of the inputs
COUNTER_SEED = 12345
QUANTILES = (0.5, 0.9, 0.99)
SPARSE_L, SPARSE_K, SPARSE_ROUNDS = 1031, 256, 4
SPARSE_G_OFFSET = 2 ** 31 - 500
WINDOW_EDGES = (2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31, -2 ** 31 + 1, -1, 0,
                -96, -97, 95, 96, -193, 191)


def random_planes(rng, prog, lanes):
    """A non-trivial starting plane tuple of ``prog``'s layout: heads
    normal, steps small integers, signs +-1."""
    ps = []
    for f in prog.layout.plane_fields:
        if f in prog.layout.heads:
            ps.append(rng.normal(0.0, 200.0, lanes).astype(np.float32))
        elif f.startswith("step"):
            ps.append(rng.integers(-8, 9, lanes).astype(np.float32))
        else:
            ps.append(rng.choice([-1.0, 1.0], lanes).astype(np.float32))
    return ps


def sparse_events(seed, lanes_l, k, rounds):
    """(ticks [L], quantile [L], [(lanes, items, mask) per round]) from
    numpy ``seed``. Each round holds k - 40 distinct event lanes (a tenth
    with NaN items), 10 mask-0 slots on lanes of their own and 30 pads on
    one more lane with no event, in shuffled slot order; mask-0 slots
    carry NaN items. Half the clocks sit at the int32 wrap, negative
    ticks and window-epoch edges (minus 0-2), the rest anywhere."""
    rng = np.random.default_rng(seed)
    ticks = rng.integers(-2 ** 31, 2 ** 31, lanes_l).astype(np.int32)
    half = lanes_l // 2
    ticks[:half] = np.resize(np.asarray(WINDOW_EDGES, np.int32), half) \
        - rng.integers(0, 3, half).astype(np.int32)
    quantile = rng.uniform(0.05, 0.95, lanes_l).astype(np.float32)
    out = []
    for _ in range(rounds):
        perm = rng.permutation(lanes_l)
        n_event, n_off, n_pad = k - 40, 10, 30
        lanes = np.concatenate([perm[:n_event + n_off],
                                np.full(n_pad, perm[n_event + n_off])])
        items = np.concatenate([
            rng.integers(-40, 400, n_event).astype(np.float32),
            np.full(n_off + n_pad, np.nan, np.float32)])
        items[: n_event // 10] = np.nan
        mask = np.concatenate([np.ones(n_event, np.int32),
                               np.zeros(n_off + n_pad, np.int32)])
        order = rng.permutation(k)
        out.append((lanes[order].astype(np.int32), items[order],
                    mask[order]))
    return ticks, quantile, out


def sparse_case(prog, lanes_l, k, rounds, seed):
    """(planes, ticks, quantile, rounds) for ``prog`` from ``seed``."""
    planes = random_planes(np.random.default_rng([seed, 1]), prog, lanes_l)
    return (planes, *sparse_events(seed, lanes_l, k, rounds))


def golden_inputs():
    """(items [T, G], quantile [L], {family: starting planes}) from seed 0."""
    from repro.core import program as program_mod

    rng = np.random.default_rng(SEED)
    lanes = G * Q
    scale = rng.uniform(3.0, 8.0, G)
    items = rng.lognormal(scale[None, :], 1.0, (T, G)).astype(np.float32)
    items[rng.random((T, G)) < 0.05] = np.nan
    quantile = np.tile(np.asarray(QUANTILES, np.float32), G)
    planes = {prog.family: random_planes(rng, prog, lanes)
              for prog in program_mod.test_instances()}
    return items, quantile, planes


def golden_outputs(items, quantile, planes):
    """{key: array} of every program's starting and final words."""
    import jax.numpy as jnp
    from repro.core import frugal
    from repro.core import program as program_mod

    out = {}
    for prog in program_mod.test_instances():
        layout = prog.layout
        ps = tuple(jnp.asarray(p) for p in planes[prog.family])
        words_in = layout.pack_planes(ps)
        ps_out, _ = frugal.program_process_seeded(
            prog, layout.unpack_words(words_in), jnp.asarray(items),
            COUNTER_SEED, jnp.asarray(quantile), t_offset=T_OFFSET,
            g_offset=G_OFFSET, lanes_per_group=Q)
        words_out = layout.pack_planes(ps_out)
        for i, (wi, wo) in enumerate(zip(words_in, words_out)):
            out[f"{prog.family}/in{i}"] = np.asarray(wi)
            out[f"{prog.family}/out{i}"] = np.asarray(wo)
        out[f"{prog.family}/scalars"] = np.asarray(prog.scalar_values(),
                                                   np.int32)
    return out


def golden_sparse():
    """{key: array}: the sparse rounds' inputs and, per program, the JAX
    package's planes and clocks after them."""
    import jax.numpy as jnp
    from repro.core import program as program_mod
    from repro.kernels import ops

    ticks, quantile, rounds = sparse_events(SEED, SPARSE_L, SPARSE_K,
                                            SPARSE_ROUNDS)
    out = {"sparse/ticks": ticks, "sparse/quantile": quantile}
    for name, i in (("lanes", 0), ("items", 1), ("mask", 2)):
        out[f"sparse/{name}"] = np.stack([r[i] for r in rounds])
    rng = np.random.default_rng([SEED, 2])
    for prog in program_mod.test_instances():
        planes = random_planes(rng, prog, SPARSE_L)
        ps, tk = tuple(jnp.asarray(p) for p in planes), jnp.asarray(ticks)
        for lanes, items, mask in rounds:
            ps, tk = ops.frugal_update_sparse(
                jnp.asarray(lanes), jnp.asarray(items), jnp.asarray(mask),
                ps, tk, jnp.asarray(quantile), COUNTER_SEED, program=prog,
                g_offset=SPARSE_G_OFFSET)
        for i, (p_in, p_out) in enumerate(zip(planes, ps)):
            out[f"{prog.family}/sparse_in{i}"] = p_in
            out[f"{prog.family}/sparse_out{i}"] = np.asarray(p_out)
        out[f"{prog.family}/sparse_ticks_out"] = np.asarray(tk)
    return out


def sparse_start(data, prog, conv):
    """(planes, ticks) a program's sparse rounds start from, each through
    ``conv`` (e.g. ``torch.from_numpy``); fresh copies."""
    n = len(prog.layout.plane_fields)
    return (tuple(conv(data[f"{prog.family}/sparse_in{i}"].copy())
                  for i in range(n)), conv(data["sparse/ticks"].copy()))


def sparse_rounds(data, conv):
    """[(lanes, items, mask)] of the sparse rounds, each through ``conv``."""
    return [tuple(conv(np.ascontiguousarray(data[f"sparse/{n}"][r]))
                  for n in ("lanes", "items", "mask"))
            for r in range(data["sparse/lanes"].shape[0])]


def sparse_final(data, prog):
    """The JAX package's planes, then clocks, after a program's rounds."""
    n = len(prog.layout.plane_fields)
    return [data[f"{prog.family}/sparse_out{i}"] for i in range(n)] + [
        data[f"{prog.family}/sparse_ticks_out"]]


def build():
    items, quantile, planes = golden_inputs()
    arrays = golden_outputs(items, quantile, planes)
    arrays.update(items=items, quantile=quantile,
                  meta=np.asarray([G, Q, T, T_OFFSET, G_OFFSET,
                                   COUNTER_SEED], np.int64))
    arrays.update(golden_sparse())
    return arrays


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **build())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
