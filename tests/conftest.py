# NOTE: do NOT set XLA_FLAGS / host device count here. Smoke tests and
# benchmarks must see the single real CPU device; only launch/dryrun.py
# forces 512 placeholder devices (in its own process).
import os
import sys

# Make `src/` importable without installation (PYTHONPATH=src also works).
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "kernel: Pallas kernel validation tests")
    config.addinivalue_line("markers", "slow: long-running subprocess tests")
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


# --------------------------------------------------------------------------
# Shared LaneProgram bit-exactness harness.
#
# ONE parametrized sweep replaces the copy-pasted backend × chunking × mesh
# loops that used to live in test_drift / test_fleet_api /
# test_group_sharding: the `lane_program` fixture enumerates EVERY family
# registered in core.program (canonical small-parameter instances), so a
# newly registered rule gets its cross-backend coverage for free — no test
# edits. The harness compares the ESTIMATES and the FULL persistent plane
# state (every layout field, gathered/unsharded) bit-for-bit, across:
#   * backend jnp (pure scan), fused (program kernel, two chunk sizes, a
#     split ingest + a re-chunked stream ingest), sharded (each requested
#     mesh size, ragged lane counts included);
#   * a multi-quantile (Q=2) lane plane, so lane fan-out is covered too.
# --------------------------------------------------------------------------
# Enumerating the registry imports repro.core.program (and therefore jax)
# at collection time — the same cost every test module in this suite
# already pays by importing jax at module level; the payoff is that a
# newly registered family appears as a test id with zero test edits.
def _all_program_instances():
    from repro.core import program as program_mod

    return program_mod.test_instances()


@pytest.fixture(params=_all_program_instances(),
                ids=lambda p: p.family)
def lane_program(request):
    """Every registered LaneProgram family, one canonical instance each."""
    return request.param


def run_program_invariance_sweep(program, mesh_sizes=(1,), g=5,
                                 quantiles=(0.5, 0.9), t=400, seed=9,
                                 data_seed=4):
    """Assert `program` is bit-exact across backend × chunking × mesh.

    Builds one fleet per (backend, chunk_t, mesh) configuration, ingests the
    same [t, g] stream split across ingest()/ingest_stream() calls, and
    requires identical estimates AND identical full plane state everywhere.
    Returns the reference estimate plane for optional further checks.
    """
    import jax
    from repro.api import FleetSpec, QuantileFleet, TopologySpec

    items = np.random.default_rng(data_seed).integers(
        0, 800, (t, g)).astype(np.float32)
    n_dev = len(jax.devices())
    configs = [("jnp", 4096, None), ("fused", 64, None), ("fused", 333, None)]
    for n in mesh_sizes:
        if n <= n_dev:
            configs.append(("fused", 100, TopologySpec(lanes=n)))

    plane_fields = program.layout.plane_fields
    ref_est = ref_state = ref_cfg = None
    for backend, chunk, topo in configs:
        spec = FleetSpec(num_groups=g, quantiles=quantiles, backend=backend,
                         chunk_t=chunk, topology=topo, program=program)
        fl = QuantileFleet.create(spec, seed=seed)
        cut = max(1, t // 3)
        fl = fl.ingest(items[:cut]).ingest_stream([items[cut:cut + 51],
                                                   items[cut + 51:]])
        est = fl.estimate()
        sk = fl._lane_sketch()
        state = {f: np.asarray(getattr(sk, f)) for f in plane_fields}
        if ref_est is None:
            ref_est, ref_state, ref_cfg = est, state, (backend, chunk)
            continue
        np.testing.assert_array_equal(
            ref_est, est,
            err_msg=f"{program.family}: estimates diverge between "
                    f"{ref_cfg} and ({backend}, {chunk})")
        for f in plane_fields:
            np.testing.assert_array_equal(
                ref_state[f], state[f],
                err_msg=f"{program.family}: plane {f!r} diverges between "
                        f"{ref_cfg} and ({backend}, {chunk})")

    # ---- cross-topology checkpoint restore phase ----------------------
    # Save under a 2-D (2 × 1) topology, restore under single-device, a
    # different replica count, and (devices allowing) a 1-D lane mesh: the
    # payload is the merged canonical lane state (a checkpoint is a sync
    # point — DESIGN.md §15), so every restored placement must carry
    # identical plane bits, an identical cursor, and replay identical
    # releases — including the 2u-dp family, whose Laplace noise keys
    # deterministically on (seed, cursor, lane).
    import tempfile
    from repro.train import elastic

    save_spec = FleetSpec(num_groups=g, quantiles=quantiles, chunk_t=64,
                          program=program,
                          topology=TopologySpec(data=2))
    fl2 = QuantileFleet.create(save_spec, seed=seed)
    fl2 = fl2.ingest(items[:cut]).ingest(items[cut:])
    canon = fl2._lane_sketch()
    restore_topos = [TopologySpec(), TopologySpec(data=3)]
    restore_topos += [TopologySpec(lanes=n) for n in mesh_sizes
                      if 1 < n <= n_dev]
    if n_dev >= 2:
        restore_topos.append(TopologySpec(data=2, lanes=2))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        fl2.checkpoint(ckpt_dir, step=1)
        for topo in restore_topos:
            rs = elastic.fleet_reshard_restore(ckpt_dir, save_spec, topo)
            rsk = rs._lane_sketch()
            for f in plane_fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(canon, f)),
                    np.asarray(getattr(rsk, f)),
                    err_msg=f"{program.family}: plane {f!r} not "
                            f"bit-identical restored onto {topo}")
            np.testing.assert_array_equal(
                np.asarray(fl2.cursor.t_offset),
                np.asarray(rs.cursor.t_offset),
                err_msg=f"{program.family}: cursor diverges restored "
                        f"onto {topo}")
            np.testing.assert_array_equal(
                fl2.estimate(), rs.estimate(),
                err_msg=f"{program.family}: release replay diverges "
                        f"restored onto {topo}")

    # ---- sparse event-round phase -------------------------------------
    # Event mode must be bit-exact too: dense `tick_lanes` rounds vs the
    # sparse gather→tick→scatter path (jnp, jnp+donation, and the Pallas
    # scatter kernel in interpret mode), same counter uniforms keyed on
    # absolute lane id + per-lane tick. Three fleets are created (NOT
    # aliased) because the donated leg invalidates its own buffers.
    import jax.numpy as jnp
    from repro.kernels import ops as kernel_ops

    ev_spec = FleetSpec(num_groups=g, quantiles=quantiles, backend="fused",
                        program=program)
    L = ev_spec.num_lanes
    fl_dense = QuantileFleet.create(ev_spec, seed=seed, per_lane_clock=True)
    fl_sp = QuantileFleet.create(ev_spec, seed=seed, per_lane_clock=True)
    fl_dn = QuantileFleet.create(ev_spec, seed=seed, per_lane_clock=True)
    sk0 = fl_dense._lane_sketch()
    pal_planes = tuple(jnp.asarray(p) for p in sk0.planes())
    pal_ticks = jnp.zeros((L,), jnp.int32)
    ev_rng = np.random.default_rng(data_seed + 1)
    for r in range(5):
        k = int(ev_rng.integers(1, L + 1))
        lanes = np.sort(ev_rng.choice(L, size=k, replace=False)) \
            .astype(np.int32)
        vals = ev_rng.integers(0, 800, k).astype(np.float32)
        mask = np.ones(k, np.int32)
        if r == 2 and k < L:   # cover a masked-out pad slot
            pad = next(i for i in range(L) if i not in set(lanes.tolist()))
            lanes = np.append(lanes, np.int32(pad))
            vals = np.append(vals, np.float32(np.nan))
            mask = np.append(mask, np.int32(0))
        dense_items = np.full(L, np.nan, np.float32)
        dense_items[lanes[mask == 1]] = vals[mask == 1]
        fl_dense = fl_dense.tick_lanes(dense_items,
                                       (~np.isnan(dense_items)).astype(
                                           np.int32))
        fl_sp = fl_sp.tick_lanes_sparse(lanes, vals, mask)
        fl_dn = fl_dn.tick_lanes_sparse(lanes, vals, mask, donate=True)
        pal_planes, pal_ticks = kernel_ops.frugal_update_sparse(
            lanes, vals, mask, pal_planes, pal_ticks, sk0.quantile,
            fl_dense.cursor.seed, fl_dense._scalars(), program=program,
            interpret=True)
    ref = fl_dense._lane_sketch()
    for tag, fl in (("sparse-jnp", fl_sp), ("sparse-donated", fl_dn)):
        np.testing.assert_array_equal(
            fl_dense.estimate(), fl.estimate(),
            err_msg=f"{program.family}: {tag} estimates diverge from dense")
        sk = fl._lane_sketch()
        for f in plane_fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f)), np.asarray(getattr(sk, f)),
                err_msg=f"{program.family}: {tag} plane {f!r} diverges")
        np.testing.assert_array_equal(
            np.asarray(fl_dense.cursor.t_offset),
            np.asarray(fl.cursor.t_offset),
            err_msg=f"{program.family}: {tag} lane clocks diverge")
    for f, p in zip(plane_fields, pal_planes):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(p),
            err_msg=f"{program.family}: pallas scatter plane {f!r} diverges")
    np.testing.assert_array_equal(
        np.asarray(fl_dense.cursor.t_offset), np.asarray(pal_ticks),
        err_msg=f"{program.family}: pallas scatter lane clocks diverge")
    return ref_est


@pytest.fixture
def program_sweep():
    """The shared harness as a fixture (callable) for test modules."""
    return run_program_invariance_sweep
