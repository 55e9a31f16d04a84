"""The program kernels' wrappers and their plain PyTorch versions.

Dense ingest:

``frugal_program_dense`` runs a [T, G] item block through any registered
lane program with the state in its serialized words (core.program
``StateLayout.pack_planes``). On CUDA tensors it launches the hand-written
kernel of ``csrc/frugal_update.cu`` or raises; on CPU tensors it runs
``frugal_program_dense_reference``, the plain version. It replaces the JAX
package's ``frugal_program_pallas_dma`` (B1), ``frugal_program_pallas``
(B2, as launches of ``block_t`` rows) and ``frugal_program_pallas_gpu``
(B4). ``frugal_program_dense_planes`` launches the same kernel on the
program's unpacked planes: the kernel packs and unpacks a (step, sign)
pair in registers as it loads and stores it, so the result is the word
path's with the packing around it, bit for bit. The entry points
(``ops.py``) use it.

Sparse events: ``frugal_program_scatter`` applies K event slots, grouped
into runs of one lane's events, in place to unpacked planes and an [L]
per-lane clock. On CUDA tensors it launches the run kernel of
``csrc/frugal_scatter.cu`` (one thread walks each run) or raises; on CPU
tensors it runs ``frugal_program_scatter_reference``, which applies the
runs one round at a time. It replaces the JAX package's
``frugal_program_scatter_pallas`` (B3).

``launch_count`` counts dense kernel launches and ``scatter_launch_count``
scatter kernel launches (and nothing else), so a run can show that its
path went through the kernels; ``producer_launch_count`` splits the dense
launches by the producer that staged their item tiles (TMA, or cp.async
where the row stride G * 4 is not a multiple of 16 bytes), and
``state_io_launch_count`` by the state format they read and wrote.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.core import frugal
from repro_torch.core import rng as crng

# Kernel instantiation per kernel family (FtFamily in csrc/frugal_tick.cuh).
FAMILY_IDS = {"1u": 0, "2u": 1, "2u-decay": 2, "1u-window": 3,
              "2u-window": 4}

launch_count = 0
scatter_launch_count = 0

# The dense kernel's threads per CUDA block, from a sweep of
# tools/bench_b1.py on an H100 with the kernel's tile rows and tick unroll
# (build-time constants of csrc/frugal_tick.cuh; PERF.md).
DEFAULT_BLOCK_G = 256
_INFO_FIELDS = ("lanes_per_thread", "ticks_per_step", "tile_rows",
                "tile_cols", "smem_bytes", "producer", "blocks_per_sm",
                "grid_blocks", "box_cols")
# The dense kernel's item producers, by FtProducer id; the wrapper counts
# its launches by producer.
PRODUCERS = {1: "cp.async", 2: "tma"}
producer_launch_count = dict.fromkeys(PRODUCERS.values(), 0)
# The dense kernel's state formats, by FtStateFormat id; the wrappers count
# their launches by format.
STATE_FORMATS = {"words": 0, "planes": 1}
state_io_launch_count = dict.fromkeys(STATE_FORMATS, 0)
_ENCODE_ERROR_BASE = 1000   # FT_ENCODE_ERROR_BASE of csrc/frugal_update.cu


def _scalar_slots(program, scalars):
    vals = tuple(int(s) for s in (program.scalar_values() if scalars is None
                                  else scalars))
    if len(vals) != len(program.layout.scalar_names):
        raise ValueError(f"{program.family}: {len(vals)} scalar operand(s), "
                         f"layout declares {program.layout.scalar_names}")
    return vals


def _check_operands(program, items, state, quantile, lanes_per_group, *,
                    planes=False):
    """The dense operands: items [T, G] float32, the state as the layout's
    words (or, with ``planes``, its float32 planes), each [G·Q], and [G·Q]
    float32 targets, all on the items' device."""
    layout = program.layout
    if items.dim() != 2 or items.dtype != torch.float32:
        raise ValueError(f"items must be [T, G] float32, got "
                         f"{tuple(items.shape)} {items.dtype}")
    lanes = items.shape[1] * lanes_per_group
    what = "plane" if planes else "state word"
    dtypes = ((torch.float32,) * layout.num_planes if planes
              else layout.word_dtypes)
    if len(state) != len(dtypes):
        raise ValueError(f"{program.family}: {len(state)} {what}s, layout "
                         f"has {len(dtypes)}")
    for w, dt in zip(state, dtypes):
        if w.dtype != dt or tuple(w.shape) != (lanes,):
            raise ValueError(f"{what} {tuple(w.shape)} {w.dtype} != "
                             f"[{lanes}] {dt}")
    if quantile.dtype != torch.float32 or tuple(quantile.shape) != (lanes,):
        raise ValueError(f"quantile must be [{lanes}] float32, got "
                         f"{tuple(quantile.shape)} {quantile.dtype}")
    for x in (*state, quantile):
        if x.device != items.device:
            raise ValueError(f"operands on {x.device} and {items.device}; "
                             "move them to one device")


def frugal_program_dense_reference(program, items, words, quantile, seed,
                                   scalars=None, *, t_offset=0, g_offset=0,
                                   lanes_per_group=1):
    """Plain PyTorch version of the kernel: unpack the words, run
    ``core.frugal.program_process_seeded``, repack. Same operands and
    result as ``frugal_program_dense``, on any device."""
    _check_operands(program, items, words, quantile, lanes_per_group)
    layout = program.layout
    planes, _ = frugal.program_process_seeded(
        program, layout.unpack_words(words), items, seed, quantile,
        scalars=_scalar_slots(program, scalars), t_offset=t_offset,
        g_offset=g_offset, lanes_per_group=lanes_per_group)
    return layout.pack_planes(planes)


def dense_launch_info(family, t_len, groups, lanes_per_group,
                      block_g=DEFAULT_BLOCK_G, items_ptr=0):
    """The dense kernel's launch at [t_len, groups] with ``lanes_per_group``
    lanes per group, as the CUDA library plans it: lanes per thread, ticks
    per unrolled step, the item tile's rows and columns, dynamic shared
    memory bytes, the item producer (a key of ``PRODUCERS``), resident
    blocks per SM from the runtime's occupancy calculator, grid blocks and
    the TMA box's columns. ``family`` is a ``FAMILY_IDS`` value. Needs the
    card."""
    from .build import load_library

    out = (ctypes.c_int64 * len(_INFO_FIELDS))()
    err = load_library().frugal_dense_info(
        family, t_len, groups, lanes_per_group, block_g, items_ptr, out)
    if err != 0:
        raise RuntimeError(f"frugal_dense_info failed: cudaError_t {err}")
    info = dict(zip(_INFO_FIELDS, out))
    info["block_threads"] = block_g
    return info


def frugal_program_dense(program, items, words, quantile, seed,
                         scalars=None, *, t_offset=0, g_offset=0,
                         lanes_per_group=1, block_g=DEFAULT_BLOCK_G):
    """Ingest ``items`` [T, G] into the state ``words`` (each [G·Q]) with
    one kernel launch; returns new word tensors.

    Lane l reads item column ``l // lanes_per_group``; its uniform at row i
    is ``counter_uniform(seed, t_offset + i, g_offset + l)``. ``block_g``
    is the CUDA block size (a multiple of 32, at most 1024): with Q =
    ``lanes_per_group`` at most 4 each thread holds one group's Q lanes,
    so a block stages and ticks ``block_g`` groups; with Q above 4 each
    thread holds one lane, so a block ticks ``block_g`` lanes. The result
    does not depend on it. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise (a failed launch or tensor-map encode
    included).
    """
    with tracing.span("kernels.dense_launch"):
        if items.device.type == "cpu":
            return frugal_program_dense_reference(
                program, items, words, quantile, seed, scalars,
                t_offset=t_offset, g_offset=g_offset,
                lanes_per_group=lanes_per_group)
        _check_operands(program, items, words, quantile, lanes_per_group)
        return _launch_dense(program, "words", items, words, quantile, seed,
                             scalars, t_offset, g_offset, lanes_per_group,
                             block_g)


def frugal_program_dense_planes(program, items, planes, quantile, seed,
                                scalars=None, *, t_offset=0, g_offset=0,
                                lanes_per_group=1, block_g=DEFAULT_BLOCK_G):
    """``frugal_program_dense`` on the program's plane tuple (each [G·Q]
    float32, ``plane_fields`` order): one launch of the same kernel, which
    reads and writes the planes; returns new plane tensors.

    The result is ``layout.unpack_words(frugal_program_dense(...,
    layout.pack_planes(planes), ...))`` bit for bit: each (step, sign)
    pair passes through its packed word in the kernel's load and store, so
    steps outside the packing's domain (NaN, beyond 2^32, below 2^-63)
    come out as the word path leaves them, and T = 0 returns the planes
    through that round trip. CPU tensors run that composition on the plain
    version."""
    with tracing.span("kernels.dense_launch"):
        _check_operands(program, items, planes, quantile, lanes_per_group,
                        planes=True)
        layout = program.layout
        if items.shape[0] == 0:
            return tuple(p.clone() for p in
                         layout.unpack_words(layout.pack_planes(planes)))
        if items.device.type == "cpu":
            return layout.unpack_words(frugal_program_dense_reference(
                program, items, layout.pack_planes(planes), quantile, seed,
                scalars, t_offset=t_offset, g_offset=g_offset,
                lanes_per_group=lanes_per_group))
        return _launch_dense(program, "planes", items, planes, quantile,
                             seed, scalars, t_offset, g_offset,
                             lanes_per_group, block_g)


def _launch_dense(program, fmt, items, state, quantile, seed, scalars,
                  t_offset, g_offset, lanes_per_group, block_g):
    """One launch of the dense kernel with the checked state in ``fmt`` (a
    key of ``STATE_FORMATS``); new state tensors in the same format."""
    global launch_count
    if items.device.type != "cuda":
        raise ValueError(f"no dense kernel for device {items.device}")
    family = program.kernel_family
    if family not in FAMILY_IDS:
        raise ValueError(f"no kernel instantiation for program family "
                         f"{family!r}; kernel families: "
                         f"{tuple(FAMILY_IDS)}")
    if block_g <= 0 or block_g > 1024 or block_g % 32:
        raise ValueError(f"block_g must be a multiple of 32 in "
                         f"[32, 1024], got {block_g}")
    for x in (items, *state, quantile):
        if not x.is_contiguous():
            raise ValueError("the dense kernel takes contiguous tensors")
    t_len, g = items.shape
    outs = tuple(torch.empty_like(x) for x in state)
    if t_len == 0:
        for o, x in zip(outs, state):
            o.copy_(x)
        return outs
    slots = _scalar_slots(program, scalars) + (0, 0)
    ptr_in = [x.data_ptr() for x in state] + [None] * (6 - len(state))
    ptr_out = [o.data_ptr() for o in outs] + [None] * (6 - len(outs))
    from .build import load_library

    producer = ctypes.c_int32(0)
    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream(items.device).cuda_stream
        err = load_library().frugal_dense_launch(
            FAMILY_IDS[family], STATE_FORMATS[fmt], items.data_ptr(),
            quantile.data_ptr(), *ptr_in, *ptr_out, t_len, g,
            lanes_per_group, crng.wrap_i32(seed), crng.wrap_i32(t_offset),
            crng.wrap_i32(g_offset), slots[0], slots[1], block_g, stream,
            ctypes.byref(producer))
    if err <= -_ENCODE_ERROR_BASE:
        raise RuntimeError(f"frugal_dense_launch: the items' tensor map "
                           f"could not be encoded: CUresult "
                           f"{-err - _ENCODE_ERROR_BASE}")
    if err != 0:
        raise RuntimeError(f"frugal_dense_launch failed: cudaError_t {err}")
    launch_count += 1
    producer_launch_count[PRODUCERS[producer.value]] += 1
    state_io_launch_count[fmt] += 1
    return outs


# ------------------------------------------------------------ sparse events
def _check_scatter_operands(program, lanes, items, mask, planes, ticks,
                            quantile):
    layout = program.layout
    if lanes.dim() != 1 or lanes.dtype != torch.int32:
        raise ValueError(f"lanes must be [K] int32, got "
                         f"{tuple(lanes.shape)} {lanes.dtype}")
    k = lanes.shape[0]
    for name, x, dt in (("items", items, torch.float32),
                        ("mask", mask, torch.int32)):
        if x is not None and (x.dtype != dt or tuple(x.shape) != (k,)):
            raise ValueError(f"{name} must be [{k}] {dt}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if len(planes) != len(layout.plane_fields):
        raise ValueError(f"{program.family}: {len(planes)} planes, layout "
                         f"has {layout.plane_fields}")
    lanes_l = ticks.shape[0] if ticks.dim() == 1 else -1
    if ticks.dtype != torch.int32 or lanes_l <= 0:
        raise ValueError(f"ticks must be [L] int32, got "
                         f"{tuple(ticks.shape)} {ticks.dtype}")
    for p in planes:
        if p.dtype != torch.float32 or tuple(p.shape) != (lanes_l,):
            raise ValueError(f"plane {tuple(p.shape)} {p.dtype} != "
                             f"[{lanes_l}] float32")
    if quantile.dtype != torch.float32 or \
            quantile.numel() not in (1, lanes_l) or quantile.dim() > 1:
        raise ValueError(f"quantile must be [{lanes_l}] or one float32, got "
                         f"{tuple(quantile.shape)} {quantile.dtype}")
    for x in (items, mask, *planes, ticks, quantile):
        if x is not None and x.device != lanes.device:
            raise ValueError(f"operands on {x.device} and {lanes.device}; "
                             "move them to one device")


def run_ranks(lanes):
    """Each slot's position within its run of equal adjacent lane ids
    (position minus run start): the round in which a round-by-round
    application takes it."""
    k = lanes.shape[0]
    pos = torch.arange(k, device=lanes.device)
    head = torch.ones(k, dtype=torch.bool, device=lanes.device)
    head[1:] = lanes[1:] != lanes[:-1]
    return pos - torch.cummax(torch.where(head, pos, 0), 0).values


def frugal_program_scatter_reference(program, lanes, items, mask, planes,
                                     ticks, quantile, seed, scalars=None, *,
                                     g_offset=0):
    """Plain PyTorch version of the run kernel: rank each slot within its
    run, then apply ranks 0, 1, ... as successive rounds, each a gather of
    its lanes' planes, clocks and targets, ``program.run_tick`` once with
    each lane's own tick, and an ``index_put_`` of planes and clocks back
    in place. Same operands and result as ``frugal_program_scatter``, on
    any device; a lane id outside [0, L) raises here (the kernel skips
    it)."""
    _check_scatter_operands(program, lanes, items, mask, planes, ticks,
                            quantile)
    n_lanes = ticks.shape[0]
    if bool(((lanes < 0) | (lanes >= n_lanes)).any()):
        raise ValueError(f"lane ids must lie in [0, {n_lanes})")
    if mask is None:
        mask = (~torch.isnan(items)).to(torch.int32)
    items = torch.where(mask == 0, float("nan"), items)
    g_ids = crng.wrap_i32(g_offset) + lanes
    q = quantile.reshape(-1)
    ctx_seed = crng.wrap_i32(seed)
    slots = _scalar_slots(program, scalars)
    rank = run_ranks(lanes)
    for r in range(int(rank.max()) + 1 if lanes.shape[0] else 0):
        sel = rank == r
        idx = lanes[sel].long()
        ticks_s = ticks[idx]
        ctx = frugal.TickCtx(
            quantile=q[idx] if q.numel() > 1 else q.expand(idx.shape),
            t=ticks_s, seed=ctx_seed, lanes=g_ids[sel], scalars=slots)
        u = crng.counter_uniform(ctx.seed, ticks_s, ctx.lanes)
        out = program.run_tick(tuple(p[idx] for p in planes), items[sel], u,
                               ctx)
        for p, o in zip(planes, out):
            p.index_put_((idx,), o)
        ticks.index_put_((idx,), ticks_s + mask[sel])
    return tuple(planes), ticks


def frugal_program_scatter(program, lanes, items, mask, planes, ticks,
                           quantile, seed, scalars=None, *, g_offset=0,
                           block_k=128):
    """Apply K event slots in place: slot j ticks lane ``lanes[j]`` once
    with item ``items[j]``, the uniform ``counter_uniform(seed,
    ticks[lane], g_offset + lane)`` and the target ``quantile[lane]`` (or
    the one scalar), then advances ``ticks[lane]`` by ``mask[j]``. A slot
    with mask 0 ticks with a NaN item; ``mask=None`` means mask = (item is
    not NaN). Returns ``(planes, ticks)``: the caller's tensors, updated.

    Run contract: a run is a stretch of adjacent slots naming one lane.
    Each lane's masked-in events lie in one run, in arrival order (a
    stable sort by lane gives this), and distinct runs name distinct
    lanes, except runs made only of pads (mask 0 or NaN items), which store
    their lane's state unchanged. A round of distinct lanes is the case of
    runs of length 1. The kernel walks each run on one thread; nothing is
    padded here. ``block_k`` is the CUDA block size (a multiple of 32, at
    most 1024). CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise.
    """
    global scatter_launch_count
    if lanes.device.type == "cpu":
        return frugal_program_scatter_reference(
            program, lanes, items, mask, planes, ticks, quantile, seed,
            scalars, g_offset=g_offset)
    if lanes.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {lanes.device}")
    _check_scatter_operands(program, lanes, items, mask, planes, ticks,
                            quantile)
    family = program.kernel_family
    if family not in FAMILY_IDS:
        raise ValueError(f"no kernel instantiation for program family "
                         f"{family!r}; kernel families: {tuple(FAMILY_IDS)}")
    if block_k <= 0 or block_k > 1024 or block_k % 32:
        raise ValueError(f"block_k must be a multiple of 32 in [32, 1024], "
                         f"got {block_k}")
    for x in (lanes, items, mask, *planes, ticks, quantile):
        if x is not None and not x.is_contiguous():
            raise ValueError("the scatter kernel takes contiguous tensors")
    k = lanes.shape[0]
    if k == 0:
        return tuple(planes), ticks
    slots = _scalar_slots(program, scalars) + (0, 0)
    ptrs = [p.data_ptr() for p in planes] + [None] * (6 - len(planes))
    from .build import load_library

    with torch.cuda.device(lanes.device):
        stream = torch.cuda.current_stream(lanes.device).cuda_stream
        err = load_library().frugal_scatter_launch(
            FAMILY_IDS[family], lanes.data_ptr(), items.data_ptr(),
            None if mask is None else mask.data_ptr(), quantile.data_ptr(),
            int(quantile.numel() > 1), *ptrs, ticks.data_ptr(), k,
            ticks.shape[0], crng.wrap_i32(seed), crng.wrap_i32(g_offset),
            slots[0], slots[1], block_k, stream)
    if err != 0:
        raise RuntimeError(f"frugal_scatter_launch failed: cudaError_t {err}")
    scatter_launch_count += 1
    return tuple(planes), ticks
