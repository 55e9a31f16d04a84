"""Write tests/data/torch_port_golden.npz: JAX-package outputs that hold
the PyTorch port to the reference where JAX is not installed (the CUDA
kernel's check in chip_smoke.py).

Inputs come from numpy seed 0: G = 128 groups x Q = 3 quantiles = 384 lanes,
T = 256 ticks starting at t_offset = 2^31 - 64 (so the run crosses the int32
wrap), lane offset g_offset = 7, 5% NaN ticks, and a non-trivial starting
state per program. For each of the six ``test_instances()`` programs the
file holds the starting words and the words after
``repro.core.frugal.program_process_seeded``.

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


def golden_inputs():
    """(items [T, G], quantile [L], {family: starting planes}) from seed 0."""
    from repro.core import program as program_mod

    rng = np.random.default_rng(SEED)
    lanes = G * Q
    scale = rng.uniform(3.0, 8.0, G)
    items = rng.lognormal(scale[None, :], 1.0, (T, G)).astype(np.float32)
    items[rng.random((T, G)) < 0.05] = np.nan
    quantile = np.tile(np.asarray(QUANTILES, np.float32), G)
    planes = {}
    for prog in program_mod.test_instances():
        ps = []
        for f in prog.layout.plane_fields:
            if f in prog.layout.heads:
                ps.append(rng.normal(0.0, 200.0, lanes).astype(np.float32))
            elif f.startswith("step"):
                ps.append(rng.integers(-8, 9, lanes).astype(np.float32))
            else:
                ps.append(rng.choice([-1.0, 1.0], lanes).astype(np.float32))
        planes[prog.family] = ps
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


def build():
    items, quantile, planes = golden_inputs()
    arrays = golden_outputs(items, quantile, planes)
    arrays.update(items=items, quantile=quantile,
                  meta=np.asarray([G, Q, T, T_OFFSET, G_OFFSET,
                                   COUNTER_SEED], np.int64))
    return arrays


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **build())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
