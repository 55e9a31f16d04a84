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

A batch of event runs (keys ``runs/*`` and ``<family>/runs_*``): K = 512
slots against the same L = 1031 lanes and starting planes, each lane's
events adjacent in arrival order (``run_events``: Zipf(1.2) lanes, NaN
items and mask-0 slots inside runs, pad-only runs, hot lanes' clocks
before the int32 wrap and window-epoch edges). For each program the file
holds the planes and clocks after the batch is split into rounds
(``run_rounds``) and the rounds go through the same JAX function in
order.

Checkpoints (directory ``tests/data/jax_checkpoints/``, keys ``ckpt/*``):
format-4 checkpoints the JAX package writes, one step each, for a fleet
of 1024 groups x 3 quantiles on ``2u`` and on ``2u-window`` (W = 96),
cursor seed 2024 at t_offset 2^31 - 150 and g_offset 7, after 300 ticks
of lognormal items with 5% NaN (``ckpt_items``), and for an ``SLOFleet``
of 1500 routes (capacity 2048 routes, 6144 lanes) after one flush of 3000
Zipf(1.2)-routed observations (``slo_observations``). The golden file
holds each one's continuation as the JAX package computes it: the fleets'
packed words and cursor after 200 more ticks, the SLO fleet's planes and
clocks after a second flush of 2000 observations, which it also holds
(``ckpt/slo/{routes,metrics,values}``: numpy's Zipf sampler is not the
same in every numpy version, its lognormal sampler is).

The streaming service (keys ``service/*``): the JAX package's
``StreamingService`` over a 4096-group, q50, ``2u-decay`` fleet
(half-life 2^16, chunk_t 64, seed 17, the e14 service deployment at small
size) fed 4 chunks of [64, 4096] items (``service_chunk``: chunk k drawn
from numpy seed (17, k), normal(50, 15), as e14 draws them), with a
trusted and a "partner" tenant read (epsilon 0.8) at every chunk
boundary. The file holds the answers and, for each chunk, its seed and
the CRC32 of its bytes (``service/chunk_crc32``), not the chunk: a reader
remakes the chunks and checks the CRC32s first, since another numpy may
draw another stream from the same seed. The telemetry histogram (keys
``telemetry/*``): the JAX package's ``Telemetry(seed=7)`` after the fixed
observation sequence of ``telemetry_observations`` (arithmetic, no RNG),
its latency quantiles and the lanes' planes and cursor.

The paper's evaluation (keys ``eval/*``): the GROUPBY workloads of
``benchmarks/bench_groupby_tcp.py`` (E3, Figures 6-7: flow sizes and
durations, 100 sites x 6 months) and ``bench_groupby_twitter.py`` (E5,
Figures 10-11: 4554 users, 905 days) at their full sizes, each padded
with NaN into one [T, G] block (``eval_items``). For each the file holds
the CRC32 of the block's bytes and its shape (not the block: another
numpy may draw other streams), and the JAX fleet's estimates at q in
{0.5, 0.9} and algo in {1u, 2u} (``FleetSpec(num_groups=G,
quantiles=(q,), algo=...)`` created with ``key=jax.random.PRNGKey(0)``,
whose key words the file holds too). Beside them: the JAX package's GK
(20 tuples), q-digest (b = 20) and Selection on the first 40 E3 size
streams at q = 0.5 (``make_baseline``, as ``benchmarks/common.py`` builds
them), and a ``FrugalEstimator`` (q50 and q90, seed 0) fed E3 size stream
0 in pieces (``estimator_feed``).

Placement across devices (keys ``place/*``), from the JAX package's
sequential replica loop on one CPU device. E15 at its full size
(``benchmarks/bench_mesh2d.py``: G = 2^20, q50, ``2u``, chunk_t 64, T = 512
items from ``e15_items``, fleet seed 0), as CRC32s of float32 bytes, not
arrays: the items; the single fleet's estimates; a 2 × 4 fleet after the
whole block (each replica's planes, ``plane_crc32s``, and the merged
estimates); and the elastic sequence: rows 0-255 under 2 × 4, a reshard to
4 × 2, rows 256-511, ``sync()``, a reshard back to 2 × 4 and
``grow_groups(2^20 + 2^16)`` (replica planes after each step that changes
them, the merged estimates after the sync, the canonical planes at the
end). Six programs (``test_instances``) at G = 1000, q50/q90, T = 700
(``six_items``, its CRC32 stored), chunk_t 64, fleet seed 11, under
TopologySpec(data=3, lanes=2): each one's replica planes and merged
planes in full.

The serving engine (keys ``serve/*``): a reduced float32 yi-6b
(``serve_config``: ``reduce_for_smoke`` narrowed to d_model 64, 4 heads
over 2 kv heads of 16, d_ff 128, vocab 256; 2 layers) with the JAX
package's parameters from ``jax.random.PRNGKey(0)``, stored leaf by leaf
(``serve/params/<path>``, about 0.4 MB: another numpy may not remake
them), served by the JAX package's ``ServeEngine`` (2 slots, max_len 32,
greedy) under a fake clock (``FakeClock``, read where the engine reads
``time.time``) for the requests of ``serve_requests`` (numpy seed 20, one
prompt longer than max_len). The file holds the prompts, the greedy
outputs, the logits of the first engine step's decode call, the
``stats_summary()`` and the SLO fleet's planes and clocks.

The training path (keys ``train/*``, checkpoint directory
``tests/data/jax_checkpoints/train``): the same narrowed float32 yi-6b
(``serve_config``), its JAX ``TrainState`` from ``create_train_state``
with ``jax.random.PRNGKey(0)`` and AdamW under ``warmup_cosine(1e-3, 10,
30)``, stored leaf by leaf (``train/init/*``: parameters, moments, step,
key words, both monitor fleets' planes and cursors, the clip sketch), and
8 batches of the JAX ``SyntheticCorpus`` (vocab 256, seq 32, batch 4,
seed 0; the tokens themselves, ``train/tokens`` and ``train/targets``).
Per step of the jitted ``train_step``: the loss, ce loss and grad norm
(``train/loss`` ...), and the step-1 gradients (``train/grads1/*``). Beside
it, the frugal parts alone, chained from the initial state: each step's
block norms (from ``value_and_grad`` of the loss at that step's
parameters) and key words, and the clip sketch after ``quantile_clip``
on them; each step's flattened activation stats and both monitor fleets'
planes and cursors after ``update_train_monitors`` on them. The
checkpoint holds the ``TrainState`` after 4 steps (step 4).

The MoE and MLA families (keys ``moe/<arch>/*``, for olmoe-1b-7b and
deepseek-v2-lite-16b): each reduced config narrowed (``moe_config``:
d_model 64, 4 heads over 2 kv heads of 16, d_ff 128 (deepseek's dense
prefix too), vocab 256, 8 experts of d_ff 32, top 2; olmoe 2 MoE layers,
deepseek an MLA prefix and 2 MLA-MoE layers), its JAX ``TrainState``
from ``jax.random.PRNGKey(0)`` (AdamW, the three monitor fleets, the
clip) stored leaf by leaf in ``moe/<arch>/init/*`` as ``train/init`` is. With those
parameters: the JAX ``forward`` over the first training batch's tokens
(each MoE unit's expert load and drop fraction, ``moe/<arch>/route/*``);
the JAX ``ServeEngine`` on ``serve_requests`` as for ``serve/*``
(``moe/<arch>/serve/*``); and MOE_TRAIN_STEPS jitted ``train_step``s on
the JAX ``SyntheticCorpus`` batches (vocab 256, seq 32, batch 4, seed 0):
each step's loss, ce and aux loss and grad norm, and the expert-load
fleet's planes and cursor after it (``moe/<arch>/train/*``).

The recurrent families (keys ``ssm/<name>/*``: ``zamba2-2.7b``,
``rwkv6-1.6b`` and ``rwkv6-1.6b-factorized``, the H1 form at subchunk
8): each reduced config narrowed (``ssm_config``: d_model 64, 4 heads
over 2 kv heads of 16 in zamba2's shared block, d_ff 128, vocab 256;
zamba2 12 layers with a d_inner of 128 in 8 heads, state 16, chunk 32;
rwkv6 2 layers, heads of 16, chunk 32), its JAX ``TrainState`` from
``jax.random.PRNGKey(0)`` with every parameter leaf redrawn by
``redraw_params`` (numpy seed SSM_SEED: the initialiser's constants
would hide ordering bugs), stored as ``moe/*`` stores it (the factorized
variant shares ``ssm/rwkv6-1.6b/init/*``); with it the JAX ``forward``
logits over the first batch's tokens (``ssm/<name>/forward/logits``), the
engine on ``serve_requests`` (``ssm/<name>/serve/*``) and
SSM_TRAIN_STEPS jitted train steps: losses, and both activation fleets'
planes and cursors after each (``ssm/<name>/train/*``).

    PYTHONPATH=src python tests/make_torch_port_golden.py
    PYTHONPATH=src python tests/make_torch_port_golden.py --only-serving
    PYTHONPATH=src python tests/make_torch_port_golden.py --only-training
    PYTHONPATH=src python tests/make_torch_port_golden.py --only-moe
    PYTHONPATH=src python tests/make_torch_port_golden.py --only-ssm

``--only-serving`` (``--only-training``, ``--only-moe``, ``--only-ssm``)
rewrites the ``serve/*`` (``train/*`` and the training checkpoint,
``moe/*``, ``ssm/*``) keys and keeps every other key of the file as it
is.
"""
import os
import shutil
import sys
import tempfile
import zlib

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
RUNS_K = 512
ZIPF_A = 1.2
# Clocks of the four hottest lanes of a run batch: their long runs cross
# the int32 wrap and window-epoch edges (W = 96).
HOT_TICKS = (2 ** 31 - 40, 2 ** 31 - 200, -130, -1)
CKPT_ROOT = os.path.join(os.path.dirname(GOLDEN), "jax_checkpoints")
CKPT_PROGRAMS = {"2u": {}, "2u-window": {"window": 96}}
CKPT_G, CKPT_CHUNK_T, CKPT_T1, CKPT_T2 = 1024, 128, 300, 200
CKPT_SEED, CKPT_T_OFFSET, CKPT_G_OFFSET = 2024, 2 ** 31 - 150, 7
CKPT_SLO_SEED, CKPT_SLO_CAPACITY, CKPT_SLO_ROUTES = 5, 2048, 1500
CKPT_SLO_EVENTS = (3000, 2000)
SERVICE_G, SERVICE_CHUNK_T, SERVICE_CHUNKS = 4096, 64, 4
SERVICE_SEED, SERVICE_EPSILON, SERVICE_HALF_LIFE = 17, 0.8, 1 << 16
TELEMETRY_SEED, TELEMETRY_OBSERVATIONS = 7, 300
EVAL_DATASETS = ("e3_size", "e3_duration", "e5_user", "e5_daily")
EVAL_QS, EVAL_ALGOS, EVAL_CHUNK_T, EVAL_KEY = (0.5, 0.9), ("1u", "2u"), 4096, 0
EVAL_BASELINES = ("gk20", "qdigest20", "selection")
EVAL_BASELINE_STREAMS, EVAL_BASELINE_Q = 40, 0.5
E15_G, E15_T, E15_CHUNK_T, E15_SEED = 2 ** 20, 512, 64, 0
E15_GROW = 2 ** 20 + 2 ** 16
SIX_G, SIX_QS, SIX_T, SIX_CHUNK_T, SIX_SEED = 1000, (0.5, 0.9), 700, 64, 11
SIX_DATA, SIX_LANES = 3, 2
SERVE_ARCH, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_SEED = "yi-6b", 2, 32, 20
SERVE_WIDTHS = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                    d_ff=128, vocab_size=256)
SERVE_ROUTES = ("api", "batch", "chat")
SERVE_REQUESTS, SERVE_LONG_PROMPT = 6, 40
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_SEQ, TRAIN_BATCH = 8, 4, 32, 4
TRAIN_LR = (1e-3, 10, 30)        # warmup_cosine(peak, warmup, total)
TRAIN_MONITORS = ("act_absmax_q99", "act_rms_q50")
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
MOE_WIDTHS = dict(SERVE_WIDTHS, moe_d_ff=32)
MOE_MONITORS = TRAIN_MONITORS + ("expert_load_q99",)
MOE_TRAIN_STEPS = 4
# name -> (arch, factorized)
SSM_MODELS = {"zamba2-2.7b": ("zamba2-2.7b", False),
              "rwkv6-1.6b": ("rwkv6-1.6b", False),
              "rwkv6-1.6b-factorized": ("rwkv6-1.6b", True)}
SSM_WIDTHS = dict(SERVE_WIDTHS, rwkv_head_size=16)
SSM_SUBCHUNK, SSM_SEED, SSM_TRAIN_STEPS = 8, 23, 4


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


def run_events(seed, lanes_l, k):
    """(ticks [L], quantile [L], lanes [K], items [K], mask [K], pad_lane)
    of one batch of event runs from numpy ``seed``.

    Events go to Zipf(1.2)-ranked lanes, so the hottest lane's run is long
    (about a sixth of the events); a tenth carry NaN items and a twentieth
    are mask-0 slots (NaN items) inside runs. Each lane's events form one
    run in arrival order, the runs in random order. Three lanes with no
    event carry pad-only runs (mask 0, NaN items) of 1-4 slots, two runs
    each, never adjacent; ``pad_lane`` is one of them. The four hottest
    lanes' clocks are ``HOT_TICKS``; half the others sit at window-epoch
    edges and the int32 wrap (minus 0-2), the rest anywhere."""
    rng = np.random.default_rng(seed)
    ticks = rng.integers(-2 ** 31, 2 ** 31, lanes_l).astype(np.int32)
    half = lanes_l // 2
    ticks[:half] = np.resize(np.asarray(WINDOW_EDGES, np.int32), half) \
        - rng.integers(0, 3, half).astype(np.int32)
    quantile = rng.uniform(0.05, 0.95, lanes_l).astype(np.float32)
    by_rank = rng.permutation(lanes_l).astype(np.int32)
    ticks[by_rank[:len(HOT_TICKS)]] = HOT_TICKS
    pad_lanes = by_rank[-3:]
    pads = [(int(lane), int(rng.integers(1, 5)))
            for lane in np.repeat(pad_lanes, 2)]
    n_ev = k - sum(n for _, n in pads)
    lanes = by_rank[(rng.zipf(ZIPF_A, n_ev) - 1) % (lanes_l - 3)]
    items = rng.integers(-40, 400, n_ev).astype(np.float32)
    items[rng.random(n_ev) < 0.1] = np.nan
    mask = np.ones(n_ev, np.int32)
    off = rng.random(n_ev) < 0.05
    mask[off] = 0
    items[off] = np.nan
    order = np.argsort(rng.permutation(lanes_l)[lanes], kind="stable")
    lanes, items, mask = lanes[order], items[order], mask[order]
    heads = np.flatnonzero(np.r_[True, lanes[1:] != lanes[:-1]])
    at = np.sort(rng.choice(heads, len(pads), replace=False))
    pads = [pads[i] for i in rng.permutation(len(pads))]
    pos = np.repeat(at, [n for _, n in pads])
    lanes = np.insert(lanes, pos, np.repeat([lane for lane, _ in pads],
                                            [n for _, n in pads]))
    items = np.insert(items, pos, np.float32(np.nan))
    mask = np.insert(mask, pos, 0)
    return (ticks, quantile, lanes.astype(np.int32), items.astype(np.float32),
            mask.astype(np.int32), int(pad_lanes[0]))


def run_case(prog, lanes_l, k, seed):
    """(planes, ticks, quantile, (lanes, items, mask), pad_lane) of a run
    batch for ``prog`` from ``seed``."""
    planes = random_planes(np.random.default_rng([seed, 1]), prog, lanes_l)
    ticks, quantile, lanes, items, mask, pad_lane = run_events(seed, lanes_l,
                                                               k)
    return planes, ticks, quantile, (lanes, items, mask), pad_lane


def run_lengths(lanes):
    """Lengths of the runs of equal adjacent lane ids."""
    heads = np.flatnonzero(np.r_[True, lanes[1:] != lanes[:-1]])
    return np.diff(np.r_[heads, lanes.size])


def run_rounds(lanes, items, mask, pad_lane):
    """A batch of runs as rounds for a round-by-round application: slot j
    goes to round (j minus its run's start), in slot order. Every round is
    padded to the number of runs with mask-0 NaN slots on ``pad_lane`` (a
    lane the batch holds only pads for), so all rounds have one shape."""
    head = np.r_[True, lanes[1:] != lanes[:-1]]
    pos = np.arange(lanes.size)
    rank = pos - np.maximum.accumulate(np.where(head, pos, 0))
    width = int(head.sum())
    out = []
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        n = width - int(sel.sum())
        out.append((
            np.r_[lanes[sel], np.full(n, pad_lane)].astype(np.int32),
            np.r_[items[sel], np.full(n, np.nan)].astype(np.float32),
            np.r_[mask[sel], np.zeros(n)].astype(np.int32)))
    return out


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


def golden_runs(sparse):
    """{key: array}: the run batch's inputs and, per program, the JAX
    package's planes and clocks after its rounds, starting from the sparse
    rounds' planes and targets (``sparse``, as ``golden_sparse`` made
    them)."""
    import jax.numpy as jnp
    from repro.core import program as program_mod
    from repro.kernels import ops

    ticks, _, lanes, items, mask, pad_lane = run_events(SEED + 1, SPARSE_L,
                                                        RUNS_K)
    out = {"runs/ticks": ticks, "runs/lanes": lanes, "runs/items": items,
           "runs/mask": mask}
    quantile = jnp.asarray(sparse["sparse/quantile"])
    for prog in program_mod.test_instances():
        ps, tk = runs_start(sparse | out, prog, jnp.asarray)
        for r_lanes, r_items, r_mask in run_rounds(lanes, items, mask,
                                                   pad_lane):
            ps, tk = ops.frugal_update_sparse(
                jnp.asarray(r_lanes), jnp.asarray(r_items),
                jnp.asarray(r_mask), ps, tk, quantile, COUNTER_SEED,
                program=prog, g_offset=SPARSE_G_OFFSET)
        for i, p_out in enumerate(ps):
            out[f"{prog.family}/runs_out{i}"] = np.asarray(p_out)
        out[f"{prog.family}/runs_ticks_out"] = np.asarray(tk)
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


def runs_start(data, prog, conv):
    """(planes, ticks) the run batch starts from, each through ``conv``;
    fresh copies."""
    n = len(prog.layout.plane_fields)
    return (tuple(conv(data[f"{prog.family}/sparse_in{i}"].copy())
                  for i in range(n)), conv(data["runs/ticks"].copy()))


def runs_batch(data, conv):
    """(lanes, items, mask) of the run batch, each through ``conv``."""
    return tuple(conv(data[f"runs/{n}"].copy())
                 for n in ("lanes", "items", "mask"))


def runs_final(data, prog):
    """The JAX package's planes, then clocks, after the run batch."""
    n = len(prog.layout.plane_fields)
    return [data[f"{prog.family}/runs_out{i}"] for i in range(n)] + [
        data[f"{prog.family}/runs_ticks_out"]]


def ckpt_items(family, part):
    """[T1 or T2, CKPT_G] lognormal items (5% NaN) of a checkpointed
    fleet's first (part 0) or continued (part 1) ingest."""
    rng = np.random.default_rng([SEED, 3, list(CKPT_PROGRAMS).index(family),
                                 part])
    t = (CKPT_T1, CKPT_T2)[part]
    items = rng.lognormal(4.0, 1.0, (t, CKPT_G)).astype(np.float32)
    items[rng.random((t, CKPT_G)) < 0.05] = np.nan
    return items


def slo_observations(part):
    """(route ids, metric ids, values) of the checkpointed SLO fleet's
    first (part 0) or continued (part 1) flush: Zipf(1.2) routes over
    CKPT_SLO_ROUTES, a uniform metric of 3, lognormal values, 2% NaN."""
    rng = np.random.default_rng([SEED, 4, part])
    n = CKPT_SLO_EVENTS[part]
    routes = (rng.zipf(ZIPF_A, n) - 1) % CKPT_SLO_ROUTES
    values = rng.lognormal(3.0, 1.0, n)
    values[rng.random(n) < 0.02] = np.nan
    return routes, rng.integers(0, 3, n), values


def feed_slo(fleet, metrics, observations):
    """Observe (route ids, metric ids, values) on ``fleet`` and flush."""
    for r, m, v in zip(*(np.asarray(x).tolist() for x in observations)):
        fleet.observe(f"r{r}", metrics[m], v)
    fleet.flush()


def slo_continuation(data):
    """The stored (route ids, metric ids, values) of the SLO fleet's
    continued flush."""
    return tuple(data[f"ckpt/slo/{k}"] for k in ("routes", "metrics",
                                                  "values"))


def service_chunk(k, chunk_t=SERVICE_CHUNK_T, groups=SERVICE_G):
    """Chunk k of the service stream, as the JAX package's e14 draws it:
    [chunk_t, groups] float32 from numpy seed (SERVICE_SEED, k)."""
    rng = np.random.default_rng((SERVICE_SEED, k))
    return rng.normal(50.0, 15.0, size=(chunk_t, groups)).astype(np.float32)


def chunk_crc32(chunk) -> int:
    return zlib.crc32(np.ascontiguousarray(chunk).tobytes())


def telemetry_observations():
    """[(metric, ms, flush after it)]: a third of the observations to
    ``ingest_chunk_ms`` (20 ms higher), the rest to ``query_ms``, values
    multiples of 0.25 (exact in float32), a flush after every 16th."""
    out = []
    for i in range(TELEMETRY_OBSERVATIONS):
        ingest = i % 3 == 0
        ms = ((i * 37) % 101) / 4.0 + (20.0 if ingest else 0.0)
        out.append(("ingest_chunk_ms" if ingest else "query_ms", ms,
                    i % 16 == 15))
    return out


def feed_telemetry(tel):
    """``telemetry_observations`` into ``tel``; returns its latency
    quantiles ([metric, (p50, p99)] float32 in the default metric
    order)."""
    for metric, ms, flush in telemetry_observations():
        tel.observe_ms(metric, ms)
        if flush:
            tel.flush()
    lat = tel.latency_quantiles()
    return np.asarray([[lat[m]["p50"], lat[m]["p99"]]
                       for m in ("ingest_chunk_ms", "query_ms")], np.float32)


def golden_service():
    """{key: array} of the JAX service's answers at every chunk boundary
    and of the JAX telemetry histogram."""
    from repro.api import FleetSpec
    from repro.core.program import make_program
    from repro.service import StreamingService, Telemetry, TenantPolicy

    spec = FleetSpec(num_groups=SERVICE_G, quantiles=(0.5,),
                     chunk_t=SERVICE_CHUNK_T, backend="jnp",
                     program=make_program("2u-decay",
                                          half_life=SERVICE_HALF_LIFE))
    svc = StreamingService(spec, seed=SERVICE_SEED, tenants=[
        TenantPolicy("partner", epsilon=SERVICE_EPSILON)])
    raw, dp, crc = [], [], []
    for k in range(SERVICE_CHUNKS + 1):
        raw.append(svc.query())
        dp.append(svc.query(tenant="partner"))
        if k < SERVICE_CHUNKS:
            chunk = service_chunk(k)
            crc.append(chunk_crc32(chunk))
            svc.ingest(chunk)
    tel = Telemetry(seed=TELEMETRY_SEED)
    lat = feed_telemetry(tel)
    lanes = tel._fleet._lane_sketch()
    out = {"service/raw": np.stack(raw), "service/dp": np.stack(dp),
           "service/chunk_crc32": np.asarray(crc, np.int64),
           "service/chunk_seeds": np.asarray(
               [(SERVICE_SEED, k) for k in range(SERVICE_CHUNKS)], np.int64),
           "telemetry/latency": lat,
           "telemetry/cursor": np.asarray([int(x) for x in
                                           tel._fleet.cursor], np.int64)}
    for f in ("m", "step", "sign"):
        out[f"telemetry/{f}"] = np.asarray(getattr(lanes, f))
    return out


def eval_streams(streams_mod, name, quick=False):
    """The streams of one evaluation workload, from ``streams_mod`` (the
    JAX package's ``data.streams`` or the port's copy), drawn as the
    benchmarks draw them at seed 0; ``quick`` is their quick size."""
    if name.startswith("e3_"):
        kind = name[3:]
        return streams_mod.tcp_like_group_streams(
            num_sites=30 if quick else 100, num_months=6, kind=kind,
            rng=np.random.default_rng(zlib.crc32(kind.encode()) % 100))
    if name == "e5_user":
        return streams_mod.twitter_like_interval_streams(
            num_users=600 if quick else 4554, rng=np.random.default_rng(0))
    return streams_mod.daily_combined_interval_streams(
        num_days=150 if quick else 905, rng=np.random.default_rng(1))


def eval_key(name, algo, q):
    return f"eval/{name}/{algo}_q{int(round(q * 100))}"


def make_baseline(baselines_mod, algo, stream, q, seed=0):
    """A baseline summary as ``benchmarks/common.py`` builds it."""
    if algo == "gk20":
        return baselines_mod.GKSummary(eps=0.001, max_tuples=20)
    if algo == "qdigest20":
        return baselines_mod.QDigest(sigma=int(max(np.max(stream), 2)) + 1,
                                     b=20)
    return baselines_mod.Selection(quantile=q, seed=seed)


def estimator_feed(est, stream):
    """Feed ``stream`` to a ``FrugalEstimator`` tracking EVAL_QS: a third
    by ``extend``, five items by ``insert``, the rest by ``extend``, with
    both answers after the first third and at the end ([2, 2] float32)."""
    a = len(stream) // 3
    est.extend(stream[:a])
    out = [[est.query(q) for q in EVAL_QS]]
    for v in stream[a:a + 5]:
        est.insert(float(v))
    est.extend(stream[a + 5:])
    out.append([est.query(q) for q in EVAL_QS])
    return np.asarray(out, np.float32)


def golden_eval():
    """{key: array} of the JAX package's answers on the evaluation
    workloads."""
    import jax
    from repro.api import FleetSpec, FrugalEstimator, QuantileFleet
    from repro.core import baselines
    from repro.data import streams

    key = jax.random.PRNGKey(EVAL_KEY)
    out = {"eval/key_words": np.asarray(jax.random.key_data(key))}
    for name in EVAL_DATASETS:
        items = streams.pad_ragged(eval_streams(streams, name))
        out[f"eval/{name}/items_crc32"] = np.asarray(chunk_crc32(items),
                                                     np.int64)
        out[f"eval/{name}/shape"] = np.asarray(items.shape, np.int64)
        for algo in EVAL_ALGOS:
            for q in EVAL_QS:
                spec = FleetSpec(num_groups=items.shape[1], quantiles=(q,),
                                 algo=algo, chunk_t=EVAL_CHUNK_T,
                                 backend="jnp")
                fleet = QuantileFleet.create(spec, key=key).ingest(items)
                out[eval_key(name, algo, q)] = np.asarray(
                    fleet.estimate(q), np.float32)
    size = eval_streams(streams, "e3_size")
    est, words = [], []
    for algo in EVAL_BASELINES:
        row, mem = [], []
        for s in size[:EVAL_BASELINE_STREAMS]:
            b = make_baseline(baselines, algo, s, EVAL_BASELINE_Q)
            b.extend(s)
            row.append(b.query(EVAL_BASELINE_Q))
            mem.append(b.memory_words())
        est.append(row)
        words.append(mem)
    out["eval/baselines/estimates"] = np.asarray(est, np.float64)
    out["eval/baselines/memory_words"] = np.asarray(words, np.int64)
    for algo in EVAL_ALGOS:
        out[f"eval/estimator/{algo}"] = estimator_feed(
            FrugalEstimator(quantiles=EVAL_QS, algo=algo, seed=0), size[0])
    return out


def e15_items():
    """E15's [512, 2^20] item block, as ``benchmarks/bench_mesh2d.py``
    draws it at seed 0."""
    rng = np.random.default_rng(E15_SEED)
    return rng.integers(0, 1000, (E15_T, E15_G),
                        dtype=np.int32).astype(np.float32)


def six_items():
    rng = np.random.default_rng(SIX_SEED)
    return rng.normal(50.0, 15.0, (SIX_T, SIX_G)).astype(np.float32)


def plane_crc32s(planes):
    """[R, planes] CRC32s of a fleet's replica planes (each [R, L])."""
    return np.asarray([[chunk_crc32(p[r]) for p in planes]
                       for r in range(planes[0].shape[0])], np.int64)


def golden_placement():
    """{key: array} of the JAX package's placements (``place/*``)."""
    from repro.api import FleetSpec, QuantileFleet, TopologySpec
    from repro.core.program import test_instances

    def crc(x):
        return np.asarray(chunk_crc32(np.asarray(x, np.float32)), np.int64)

    def e15(topo):
        spec = FleetSpec(num_groups=E15_G, quantiles=(0.5,),
                         chunk_t=E15_CHUNK_T, topology=topo)
        return QuantileFleet.create(spec, seed=E15_SEED)

    items = e15_items()
    out = {"place/e15/items_crc32": crc(items)}
    out["place/e15/single/estimate_crc32"] = crc(
        e15(None).ingest(items).estimate())
    t24, t42 = TopologySpec(data=2, lanes=4), TopologySpec(data=4, lanes=2)
    full = e15(t24).ingest(items)
    out["place/e15/full/replica_crc32"] = plane_crc32s(
        full.state.replica_planes())
    out["place/e15/full/estimate_crc32"] = crc(full.estimate())
    del full
    half = E15_T // 2
    fl = e15(t24).ingest(items[:half])
    out["place/e15/elastic/half"] = plane_crc32s(fl.state.replica_planes())
    est = np.asarray(fl.estimate())
    fl = fl.reshard(t42)
    assert np.array_equal(np.asarray(fl.estimate()), est)
    fl = fl.ingest(items[half:])
    out["place/e15/elastic/ingested"] = plane_crc32s(
        fl.state.replica_planes())
    fl = fl.sync()
    out["place/e15/elastic/synced"] = plane_crc32s(fl.state.replica_planes())
    est = np.asarray(fl.estimate())
    out["place/e15/elastic/estimate_crc32"] = crc(est)
    fl = fl.reshard(t24)
    assert np.array_equal(np.asarray(fl.estimate()), est)
    fl = fl.grow_groups(E15_GROW)
    out["place/e15/elastic/grown"] = plane_crc32s(fl.state.replica_planes())
    out["place/e15/elastic/canonical"] = plane_crc32s(tuple(
        np.asarray(p)[None] for p in fl._lane_sketch().planes()))
    del fl, items

    six = six_items()
    out["place/six/items_crc32"] = crc(six)
    for prog in test_instances():
        spec = FleetSpec(num_groups=SIX_G, quantiles=SIX_QS,
                         chunk_t=SIX_CHUNK_T, program=prog,
                         topology=TopologySpec(data=SIX_DATA,
                                               lanes=SIX_LANES))
        fl = QuantileFleet.create(spec, seed=SIX_SEED).ingest(six)
        fields = prog.layout.plane_fields
        for f, p in zip(fields, fl.state.replica_planes()):
            out[f"place/six/{prog.family}/replicas/{f}"] = p
        for f, p in zip(fields, fl.state.merged_planes()):
            out[f"place/six/{prog.family}/merged/{f}"] = p
    return out


class FakeClock:
    """A stand-in for the ``time`` module of a serving engine: ``time()``
    starts at 1000 s and advances 1-5 ms per read, the same sequence for
    every engine, so two engines that read the clock at the same call
    sites see the same times."""

    def __init__(self):
        self.reads = 0

    def time(self) -> float:
        t = 1000.0 + 0.003 * self.reads + 0.001 * (self.reads % 5)
        self.reads += 1
        return t


def serve_config(cfg):
    """The golden engine's config from the package's ``yi-6b`` config
    (either package's ``reduce_for_smoke`` result)."""
    import dataclasses

    return dataclasses.replace(cfg, **SERVE_WIDTHS)


def serve_requests():
    """[(prompt, max_new_tokens, route)] of the golden engine: prompts of
    2-8 tokens from numpy seed SERVE_SEED, one of SERVE_LONG_PROMPT tokens
    (past max_len, so the cache write clamps)."""
    rng = np.random.default_rng(SERVE_SEED)
    out = []
    for i in range(SERVE_REQUESTS):
        n = SERVE_LONG_PROMPT if i == 3 else int(rng.integers(2, 9))
        out.append((rng.integers(0, SERVE_WIDTHS["vocab_size"],
                                 n).tolist(),
                    int(rng.integers(3, 7)),
                    SERVE_ROUTES[i % len(SERVE_ROUTES)]))
    return out


def capture_step_logits(eng):
    """Record, in ``eng.step_logits``, the float32 logits of every decode
    call that ``eng.step`` makes (prefill calls from ``_admit`` are not
    recorded). Works on either package's engine."""
    eng.step_logits = []
    decode, admit = eng._decode, eng._admit
    state = {"admitting": False}

    def admit_marked():
        state["admitting"] = True
        try:
            admit()
        finally:
            state["admitting"] = False

    def decode_recorded(*args):
        logits, caches = decode(*args)
        if not state["admitting"]:
            eng.step_logits.append(logits)
        return logits, caches

    eng._admit, eng._decode = admit_marked, decode_recorded
    return eng


def serve_engine_results(eng, request_cls):
    """Submit ``serve_requests`` to ``eng``, run it until drained and
    return {outputs, step0 logits, summary, planes} as golden arrays."""
    capture_step_logits(eng)
    for rid, (prompt, max_new, route) in enumerate(serve_requests()):
        eng.submit(request_cls(rid=rid, prompt=prompt,
                               max_new_tokens=max_new, route=route))
    eng.run_until_drained()
    def host(x):   # a torch tensor or a JAX array
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x)

    done = sorted(eng.done, key=lambda r: r.rid)
    summary = eng.stats_summary()
    out = {"serve/outputs": np.concatenate([r.output for r in done]),
           "serve/output_lengths": np.asarray([len(r.output)
                                               for r in done]),
           "serve/first_step_logits": host(eng.step_logits[0]).astype(
               np.float32),
           "serve/summary": np.asarray(
               [[summary[r][m] for m, _ in eng.slo.metrics]
                for r in SERVE_ROUTES], np.float32)}
    for name in ("_m", "_step", "_sign", "_ticks"):
        out[f"serve/slo/{name[1:]}"] = host(getattr(eng.slo, name))
    return out


def flatten_params(tree, prefix="serve/params"):
    """{"serve/params/<path>": leaf} of a JAX parameter pytree (dicts and
    lists), numpy leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(data, prefix="serve/params"):
    """The JAX parameter pytree (numpy leaves) back from the golden keys:
    path parts that are integers index lists."""
    root = {}
    for key in data:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(data[key])

    def lists(node):
        # A list entry with no leaves (zamba2's {} placeholder in
        # ``stack``) stored no key: it comes back as {}.
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node.get(str(i), {}))
                    for i in range(1 + max(int(k) for k in node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def golden_serving():
    """{key: array} of the JAX serving engine's run (``serve/*``)."""
    import jax
    from repro.configs import get_config, reduce_for_smoke
    from repro.models import build_model
    from repro.serve import engine as engine_mod

    cfg = serve_config(reduce_for_smoke(get_config(SERVE_ARCH)))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    out = flatten_params(jax.tree.map(np.asarray, params))
    reqs = serve_requests()
    out["serve/prompts"] = np.concatenate([p for p, _, _ in reqs])
    out["serve/prompt_lengths"] = np.asarray([len(p) for p, _, _ in reqs])
    real_time = engine_mod.time
    engine_mod.time = FakeClock()
    try:
        eng = engine_mod.ServeEngine(model, params,
                                     batch_slots=SERVE_SLOTS,
                                     max_len=SERVE_MAX_LEN)
        out.update(serve_engine_results(eng, engine_mod.Request))
    finally:
        engine_mod.time = real_time
    return out


def moe_config(cfg):
    """A golden MoE engine's config from the package's reduced
    ``olmoe-1b-7b`` or ``deepseek-v2-lite-16b`` config: MOE_WIDTHS, and
    deepseek's dense prefix at the same d_ff."""
    import dataclasses

    kw = dict(MOE_WIDTHS)
    if cfg.first_dense_d_ff:
        kw["first_dense_d_ff"] = kw["d_ff"]
    return dataclasses.replace(cfg, **kw)


def train_state_arrays(state, prefix="train/init", monitors=TRAIN_MONITORS):
    """{key: array} of a JAX ``TrainState`` (AdamW, the ``monitors``
    fleets, the clip), numpy leaves."""
    import jax

    st = jax.tree.map(np.asarray, state)
    out = flatten_params(st.params, f"{prefix}/params")
    out.update(flatten_params(st.opt_state.mu, f"{prefix}/mu"))
    out.update(flatten_params(st.opt_state.nu, f"{prefix}/nu"))
    out[f"{prefix}/count"] = st.opt_state.count
    out[f"{prefix}/step"] = st.step
    out[f"{prefix}/rng"] = st.rng
    for name in monitors:
        fleet = getattr(st.monitors, name)
        for f in ("m", "step", "sign"):
            out[f"{prefix}/{name}/{f}"] = getattr(fleet.state, f)
        out[f"{prefix}/{name}/cursor"] = np.asarray(
            [int(x) for x in fleet.cursor], np.int32)
    out[f"{prefix}/n_groups"] = np.asarray(
        [st.monitors.n_act_groups, st.monitors.n_moe_groups], np.int32)
    for f in ("m", "step", "sign"):
        out[f"{prefix}/qclip/{f}"] = getattr(st.qclip.sketch, f)
    out[f"{prefix}/qclip/warmup"] = st.qclip.warmup
    return out


def train_state_tree(data, prefix="train/init"):
    """The ``TrainState`` of ``train_state_arrays`` back, as namespaces
    with the JAX package's field names and numpy leaves (what
    ``repro_torch.models.convert.train_state_from_numpy`` reads)."""
    from types import SimpleNamespace as NS

    def fleet(name):
        return NS(state=NS(**{f: data[f"{prefix}/{name}/{f}"]
                              for f in ("m", "step", "sign")}),
                  cursor=tuple(data[f"{prefix}/{name}/cursor"]))

    n_act, n_moe = data[f"{prefix}/n_groups"]
    return NS(
        params=unflatten_params(data, f"{prefix}/params"),
        opt_state=NS(mu=unflatten_params(data, f"{prefix}/mu"),
                     nu=unflatten_params(data, f"{prefix}/nu"),
                     count=data[f"{prefix}/count"]),
        step=data[f"{prefix}/step"], rng=data[f"{prefix}/rng"],
        monitors=NS(act_absmax_q99=fleet("act_absmax_q99"),
                    act_rms_q50=fleet("act_rms_q50"),
                    expert_load_q99=fleet("expert_load_q99")
                    if f"{prefix}/expert_load_q99/m" in data else None,
                    n_act_groups=n_act, n_moe_groups=n_moe),
        qclip=NS(sketch=NS(**{f: data[f"{prefix}/qclip/{f}"]
                              for f in ("m", "step", "sign")}),
                 warmup=data[f"{prefix}/qclip/warmup"]))


def train_batches(data):
    """The golden steps' batches: [{tokens, targets}] int32 numpy."""
    return [{"tokens": data["train/tokens"][i],
             "targets": data["train/targets"][i]}
            for i in range(data["train/tokens"].shape[0])]


def golden_training(root):
    """{key: array} of the JAX training path (``train/*``); the checkpoint
    after TRAIN_CKPT_STEP steps goes to ``root``/train."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.models import build_model
    from repro.monitor import registry as mon
    from repro.optim import Optimizer, warmup_cosine
    from repro.optim.clipping import global_norm, quantile_clip
    from repro.train import checkpoint as ckpt
    from repro.train import create_train_state, make_train_step

    cfg = serve_config(reduce_for_smoke(get_config(SERVE_ARCH)))
    model = build_model(cfg)
    opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*TRAIN_LR))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=TRAIN_SEQ,
                                        batch_size=TRAIN_BATCH))
    batches = [corpus.batch(i) for i in range(TRAIN_STEPS)]
    state = create_train_state(model, opt, jax.random.PRNGKey(0),
                               example_batch=batches[0])
    out = train_state_arrays(state)
    out["train/tokens"] = np.stack([b["tokens"] for b in batches])
    out["train/targets"] = np.stack([b["targets"] for b in batches])
    step = jax.jit(make_train_step(model, opt))
    grad_fn = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    qclip, monitors = state.qclip, state.monitors
    rows = {k: [] for k in ("loss", "ce_loss", "grad_norm", "block_norms",
                            "clip_key", "clip_m", "clip_step", "clip_sign",
                            "stats_absmax", "stats_rms")}
    for name in TRAIN_MONITORS:
        for f in ("m", "step", "sign", "cursor"):
            rows[f"{name}/{f}"] = []
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        _, k_clip = jax.random.split(state.rng)
        (_, aux), grads = grad_fn(state.params, jb)
        if i == 0:
            out.update(flatten_params(jax.tree.map(np.asarray, grads),
                                      "train/grads1"))
        blocks = [grads[k] for k in sorted(grads)]
        _, qclip, norms = quantile_clip(blocks, qclip, k_clip)
        rows["block_norms"].append(np.asarray(norms))
        rows["clip_key"].append(np.asarray(k_clip))
        for f in ("m", "step", "sign"):
            rows[f"clip_{f}"].append(np.asarray(getattr(qclip.sketch, f)))
        a, r, _ = mon._flatten_stats(aux["stats"])
        rows["stats_absmax"].append(np.asarray(a))
        rows["stats_rms"].append(np.asarray(r))
        monitors = mon.update_train_monitors(monitors, aux["stats"])
        for name in TRAIN_MONITORS:
            fleet = getattr(monitors, name)
            for f in ("m", "step", "sign"):
                rows[f"{name}/{f}"].append(np.asarray(getattr(fleet.state,
                                                              f)))
            rows[f"{name}/cursor"].append(np.asarray(
                [int(x) for x in fleet.cursor], np.int32))
        state, met = step(state, jb)
        for k in ("loss", "ce_loss", "grad_norm"):
            rows[k].append(np.float32(met[k]))
        if i + 1 == TRAIN_CKPT_STEP:
            ckpt.save_checkpoint(os.path.join(root, "train"), i + 1, state)
    out.update({f"train/{k}": np.stack(v) for k, v in rows.items()})
    return out


def moe_train_batches(data, arch):
    """A golden MoE arch's training batches: [{tokens, targets}] int32."""
    return [{"tokens": data[f"moe/{arch}/train/tokens"][i],
             "targets": data[f"moe/{arch}/train/targets"][i]}
            for i in range(MOE_TRAIN_STEPS)]


def golden_moe():
    """{key: array} of the JAX package's MoE and MLA families
    (``moe/*``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.models import build_model
    from repro.optim import Optimizer, warmup_cosine
    from repro.serve import engine as engine_mod
    from repro.train import create_train_state, make_train_step

    out = {}
    for arch in MOE_ARCHS:
        key = f"moe/{arch}"
        cfg = moe_config(reduce_for_smoke(get_config(arch)))
        model = build_model(cfg)
        opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*TRAIN_LR))
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=TRAIN_SEQ,
                                            batch_size=TRAIN_BATCH))
        batches = [corpus.batch(i) for i in range(MOE_TRAIN_STEPS)]
        state = create_train_state(model, opt, jax.random.PRNGKey(0),
                                   example_batch=batches[0])
        out.update(train_state_arrays(state, f"{key}/init", MOE_MONITORS))
        out[f"{key}/train/tokens"] = np.stack([b["tokens"] for b in batches])
        out[f"{key}/train/targets"] = np.stack([b["targets"]
                                                for b in batches])
        _, stats = model.forward(state.params,
                                 tokens=jnp.asarray(batches[0]["tokens"]))
        for name in ("expert_load", "drop_fraction"):
            out[f"{key}/route/{name}"] = np.asarray(stats["stack"][0][name])

        real_time = engine_mod.time
        engine_mod.time = FakeClock()
        try:
            eng = engine_mod.ServeEngine(model, state.params,
                                         batch_slots=SERVE_SLOTS,
                                         max_len=SERVE_MAX_LEN)
            served = serve_engine_results(eng, engine_mod.Request)
        finally:
            engine_mod.time = real_time
        out.update({f"{key}/{k}": v for k, v in served.items()})

        step = jax.jit(make_train_step(model, opt))
        rows = {k: [] for k in ("loss", "ce_loss", "aux_loss", "grad_norm",
                                "m", "step", "sign", "cursor")}
        for b in batches:
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
                rows[k].append(np.float32(met[k]))
            fleet = state.monitors.expert_load_q99
            for f in ("m", "step", "sign"):
                rows[f].append(np.asarray(getattr(fleet.state, f)))
            rows["cursor"].append(np.asarray([int(x) for x in fleet.cursor],
                                             np.int32))
        out.update({f"{key}/train/{k}": np.stack(v)
                    for k, v in rows.items()})
    return out


def redraw_params(tree, seed):
    """A JAX parameter tree (dicts and lists of numpy leaves) with every
    leaf redrawn from numpy seed ``seed``, in sorted key order, float32:
    a leaf the initialiser fills with a constant is drawn around it
    (``A_log`` N(-1, 0.3), so A = -exp(A_log) < 0; ``dt_bias`` N(0, 0.3);
    ``D`` N(1, 0.5); ``w0`` N(-2, 0.3), so every decay stays in (0, 1)
    and no masked exponent of a reduced chunk overflows; the ``mix_*``
    lerps U(0, 1); norm scales, biases, ``norm_scale`` and ``ln_scale``
    N(0, 0.1)), every other leaf N(0, its own standard deviation)."""
    rng = np.random.default_rng(seed)
    around = {"A_log": (-1.0, 0.3), "dt_bias": (0.0, 0.3), "D": (1.0, 0.5),
              "w0": (-2.0, 0.3), "scale": (0.0, 0.1), "bias": (0.0, 0.1),
              "norm_scale": (0.0, 0.1), "ln_scale": (0.0, 0.1)}

    def draw(name, a):
        a = np.asarray(a)
        if name.startswith(("mix_", "cmix_")):
            x = rng.uniform(0.0, 1.0, a.shape)
        elif name in around:
            x = rng.normal(*around[name], a.shape)
        else:
            x = rng.normal(0.0, float(a.std()), a.shape)
        return x.astype(np.float32)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return draw(name, node)

    return walk(tree)


def ssm_config(cfg, factorized=False):
    """A golden recurrent model's config from the package's reduced
    ``zamba2-2.7b`` or ``rwkv6-1.6b`` config: SSM_WIDTHS, and the H1
    form at SSM_SUBCHUNK if ``factorized``."""
    import dataclasses

    return dataclasses.replace(cfg, **SSM_WIDTHS,
                               rwkv_factorized=factorized,
                               rwkv_subchunk=SSM_SUBCHUNK)


def ssm_init_prefix(name):
    """The key prefix of a golden recurrent model's initial TrainState
    (the factorized rwkv6 shares the baseline's)."""
    return f"ssm/{SSM_MODELS[name][0]}/init"


def golden_ssm():
    """{key: array} of the JAX package's recurrent families
    (``ssm/*``)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_for_smoke
    from repro.data.pipeline import DataConfig, SyntheticCorpus
    from repro.models import build_model
    from repro.optim import Optimizer, warmup_cosine
    from repro.serve import engine as engine_mod
    from repro.train import create_train_state, make_train_step

    out = {}
    for name, (arch, factorized) in SSM_MODELS.items():
        key = f"ssm/{name}"
        cfg = ssm_config(reduce_for_smoke(get_config(arch)), factorized)
        model = build_model(cfg)
        opt = Optimizer(kind="adamw", lr_fn=warmup_cosine(*TRAIN_LR))
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=TRAIN_SEQ,
                                            batch_size=TRAIN_BATCH))
        batches = [corpus.batch(i) for i in range(SSM_TRAIN_STEPS)]
        state = create_train_state(model, opt, jax.random.PRNGKey(0),
                                   example_batch=batches[0])
        params = redraw_params(jax.tree.map(np.asarray, state.params),
                               SSM_SEED)
        state = state._replace(params=jax.tree.map(jnp.asarray, params))
        if not factorized:
            out.update(train_state_arrays(state, ssm_init_prefix(name)))
            out[f"ssm/{arch}/train/tokens"] = np.stack(
                [b["tokens"] for b in batches])
            out[f"ssm/{arch}/train/targets"] = np.stack(
                [b["targets"] for b in batches])
        logits, _ = model.forward(state.params,
                                  tokens=jnp.asarray(batches[0]["tokens"]))
        out[f"{key}/forward/logits"] = np.asarray(logits, np.float32)

        real_time = engine_mod.time
        engine_mod.time = FakeClock()
        try:
            eng = engine_mod.ServeEngine(model, state.params,
                                         batch_slots=SERVE_SLOTS,
                                         max_len=SERVE_MAX_LEN)
            served = serve_engine_results(eng, engine_mod.Request)
        finally:
            engine_mod.time = real_time
        out.update({f"{key}/{k}": v for k, v in served.items()})

        step = jax.jit(make_train_step(model, opt))
        rows = {k: [] for k in ("loss", "ce_loss", "grad_norm")}
        for mon in TRAIN_MONITORS:
            for f in ("m", "step", "sign", "cursor"):
                rows[f"{mon}/{f}"] = []
        for b in batches:
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
            for k in ("loss", "ce_loss", "grad_norm"):
                rows[k].append(np.float32(met[k]))
            for mon in TRAIN_MONITORS:
                fleet = getattr(state.monitors, mon)
                for f in ("m", "step", "sign"):
                    rows[f"{mon}/{f}"].append(
                        np.asarray(getattr(fleet.state, f)))
                rows[f"{mon}/cursor"].append(np.asarray(
                    [int(x) for x in fleet.cursor], np.int32))
        out.update({f"{key}/train/{k}": np.stack(v)
                    for k, v in rows.items()})
    return out


def ssm_train_batches(data, name):
    """A golden recurrent model's training batches: [{tokens, targets}]
    int32."""
    arch = SSM_MODELS[name][0]
    return [{"tokens": data[f"ssm/{arch}/train/tokens"][i],
             "targets": data[f"ssm/{arch}/train/targets"][i]}
            for i in range(SSM_TRAIN_STEPS)]


def golden_checkpoints(root):
    """Write the JAX package's checkpoints under ``root`` (one directory
    per fleet: ``2u``, ``2u-window``, ``slo``) and return {key: array} of
    their continuations."""
    from repro.api import FleetSpec, QuantileFleet, StreamCursor
    from repro.core.program import make_program
    from repro.serve.slo import DEFAULT_METRICS, SLOFleet
    from repro.train import checkpoint as ckpt

    out = {}
    for family, kw in CKPT_PROGRAMS.items():
        spec = FleetSpec(num_groups=CKPT_G, quantiles=QUANTILES,
                         chunk_t=CKPT_CHUNK_T, backend="jnp",
                         program=make_program(family, **kw))
        fleet = QuantileFleet.create(spec, cursor=StreamCursor.create(
            seed=CKPT_SEED, t_offset=CKPT_T_OFFSET,
            g_offset=CKPT_G_OFFSET)).ingest(ckpt_items(family, 0))
        fleet.checkpoint(os.path.join(root, family), step=1)
        after = fleet.ingest(ckpt_items(family, 1))
        for name, x in after._lane_sketch().packed()._asdict().items():
            if x is not None:
                out[f"ckpt/{family}/{name}"] = np.asarray(x)
        out[f"ckpt/{family}/cursor"] = np.asarray(
            [int(x) for x in after.cursor], np.int64)
    metrics = [m for m, _ in DEFAULT_METRICS]
    fleet = SLOFleet(seed=CKPT_SLO_SEED, capacity=CKPT_SLO_CAPACITY)
    fleet.ensure_routes(f"r{i}" for i in range(CKPT_SLO_ROUTES))
    feed_slo(fleet, metrics, slo_observations(0))
    ckpt.save_checkpoint(os.path.join(root, "slo"), 1,
                         fleet.checkpoint_state())
    more = slo_observations(1)
    feed_slo(fleet, metrics, more)
    for k, x in zip(("routes", "metrics", "values"), more):
        out[f"ckpt/slo/{k}"] = x
    for name in ("_m", "_step", "_sign", "_ticks"):
        out[f"ckpt/slo/{name[1:]}"] = np.asarray(getattr(fleet, name))
    return out


def build(ckpt_root=None):
    """{key: array} of the golden file; the checkpoints go to
    ``ckpt_root`` (None: a temporary directory, removed after)."""
    if ckpt_root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return build(tmp)
    items, quantile, planes = golden_inputs()
    arrays = golden_outputs(items, quantile, planes)
    arrays.update(items=items, quantile=quantile,
                  meta=np.asarray([G, Q, T, T_OFFSET, G_OFFSET,
                                   COUNTER_SEED], np.int64))
    sparse = golden_sparse()
    arrays.update(sparse)
    arrays.update(golden_runs(sparse))
    arrays.update(golden_checkpoints(ckpt_root))
    arrays.update(golden_service())
    arrays.update(golden_eval())
    arrays.update(golden_placement())
    arrays.update(golden_serving())
    arrays.update(golden_training(ckpt_root))
    arrays.update(golden_moe())
    arrays.update(golden_ssm())
    return arrays


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    only = {"--only-serving": "serve/", "--only-training": "train/",
            "--only-moe": "moe/", "--only-ssm": "ssm/"}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        prefix = only[sys.argv[1]]
        with np.load(GOLDEN) as old:
            arrays = {k: old[k] for k in old.files
                      if not k.startswith(prefix)}
        if prefix == "serve/":
            arrays.update(golden_serving())
        elif prefix == "moe/":
            arrays.update(golden_moe())
        elif prefix == "ssm/":
            arrays.update(golden_ssm())
        else:
            shutil.rmtree(os.path.join(CKPT_ROOT, "train"),
                          ignore_errors=True)
            arrays.update(golden_training(CKPT_ROOT))
        np.savez_compressed(GOLDEN, **arrays)
        print(f"wrote the {prefix}* keys of {GOLDEN} "
              f"({os.path.getsize(GOLDEN)} bytes)")
    else:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        np.savez_compressed(GOLDEN, **build(CKPT_ROOT))
        print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes) and "
              f"{CKPT_ROOT}")
