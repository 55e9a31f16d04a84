"""Model of the port's dense program kernel on a CUDA card.

It prices B1 as the port runs it (``kernels/csrc/frugal_update.cu``, cut
by ``ft_dense_plan`` of ``csrc/frugal_tick.cuh``), not the JAX package's
Pallas grid. One dense call of T ticks over G item columns with Q lanes
per column (L = G·Q lanes, W = ``layout.num_words`` state words a lane),
launched once per ``block_t`` rows (launches = ⌈T / block_t⌉), moves

  items   T · G · 4 B               read once: a thread holds a group's
                                    Q ≤ 4 lanes, and with Q > 4 a block
                                    stages only its own groups' columns
  state   2 · L · W · 4 B · launches  the serialized words in and out of
                                    every launch; within one launch they
                                    stay in registers
  out     L · 4 B                   the estimates, counted once

At Q = 1 this is the JAX package's formula term for term. At Q > 1 the JAX
model charges each item Q times, because its facade repeats the items per
quantile; B1 reads a column once per group.

Operations are issue slots per lane-tick of each kernel family
(``LANE_TICK_OPS``), counted on its expression tree, plus the (seed, t)
round of the hash once per tick (``OPS_TICK``). ``operation_bound_ms``
prices them at the compute capability 9.0 rates and the SM's issue limit,
over every SM of the card at a given SM clock. They are sm_90 counts, so
only the HwSpecs of ``SM90_MAX_SM_CLOCK_HZ`` get an operations term; on
any other known HwSpec the bytes alone bound the call.

``predict_kernel`` gives the bound (the larger of the bytes and the
operations terms) and ``predicted_s``: the bound plus a per-launch
overhead, ``HwSpec.grid_step_s`` (the registry's fixed cost of one
dispatched step, 3 us for the GPU entries) once per launch. The blocks of
a launch run concurrently and its tiles are pipelined, so nothing is
charged per block or per tile; the overhead is the registry's constant,
not a fit to measured launch costs.

All predictions go through HwSpec.require_known(): an unrecognized device
raises RooflineUnknownHardware instead of pricing against guessed numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.roofline.analysis import HwSpec, detect_hw

ITEM_BYTES = 4          # float32 stream items
WORD_BYTES = 4          # int32/float32 packed state words

# Build-time constants of csrc/frugal_tick.cuh (a test reads them there).
MAX_LANES_PER_THREAD = 4                 # FT_DENSE_MAX_LPT
TILE_ROWS = 32                           # FT_DENSE_TILE_ROWS
TILE_BYTES = 98304                       # FT_DENSE_TILE_BYTES
TMA_BOX_MAX = 256                        # FT_TMA_BOX_MAX
SMEM_MAX = TILE_BYTES + 16 * TILE_ROWS + 16   # FT_DENSE_SMEM_MAX

# Published maximum SM clock of the parts whose SMs the issue-slot tables
# describe (compute capability 9.0): H100 SXM5, 1980 MHz (data sheet).
SM90_MAX_SM_CLOCK_HZ = {"gpu-h100": 1980e6}

# The issue slots Frugal-2U needs per lane-tick, counted on its expression
# tree (frugal_tick.cuh: ft_lane_hash, ft_bits_to_uniform, ft_tick_2u; the
# same nodes as core/rng.py and core/frugal.py) at one SASS instruction
# each, with the fusions sm_90 offers: a multiply-add (IMAD) takes a
# multiply with the add after it, a three-input logic op (LOP3) and a
# compare with the `and` after it (FSETP.AND) one slot each, the mantissa
# fill's shift-and-or one LEA.HI (the or adds into zero bits), and a
# select whose one arm is the register's old value is a predicated
# instruction, no slot of its own. Nothing of the loop's bookkeeping (tick
# counter, item address, branch), the item and table loads or register
# moves is counted. The count (44) is below the 45 arithmetic instructions
# per lane-tick of the compiled tick loop (nvcc 12.8, sm_90a; PERF.md), so
# it is a floor the kernel can be held to. Each row is {class: (slots,
# thread-operations per clock per SM on sm_90)}; the rates are the CUDA
# C++ Programming Guide's throughput table for compute capability 9.0.
# Rounding and selects have no row there: they are priced only through
# the issue limit below, which can only lower the bound.
OPS_2U_LANE_TICK = {
    # lane round of the counter hash: tick entry + lane id * key (IMAD),
    # then fmix32 (3 shift-xor pairs, 2 multiplies); mantissa fill (LEA.HI).
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    # mantissa fill minus 1; 2U: step +-1 (x2), m +- ceil (x2), overshoot
    # difference and its step correction (x2 each, the correction
    # predicated on the overshoot).
    "fp32 add": (9, 128),
    # 2U: item vs m with u vs 1-q or q (2 each), sign > 0, sign < 0,
    # step > 0 (x2), overshoot (x2), clamp step > 1 with its sign (x2).
    "compare": (12, 64),
    "fp32 round (ceil)": (2, None),
    # 2U: +-1 (x2), ceil or 1 (x2); m: the overshoot's item or the
    # branch's m, taken for the branch that moved (x2), then new or old
    # (1); step: the clamp (x2), new or old (1); sign: +1 or -1 where a
    # branch moved (1).
    "select": (11, None),
}
# Decayed 2U (ft_tick_2u_decay) adds to the 2U tick: floor - (floor - step)
# * alpha (two subtractions, one multiply; the last subtraction predicated
# on the gate, so the select takes no slot) and its gate (item == item,
# step < floor).
OPS_2U_DECAY_LANE_TICK = dict(
    OPS_2U_LANE_TICK, **{"fp32 add": (11, 128), "fp32 multiply": (1, 128),
                         "compare": (14, 64)})
# Frugal-1U, counted as for 2U: the lane round of the hash and the
# mantissa fill (the rows of the 2U table), then u vs 1-q and item vs m
# for each branch (4 compares, each with its `and`) and the two
# predicated moves of m (2 fp32 adds).
OPS_1U_LANE_TICK = {
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    "fp32 add": (3, 128),
    "compare": (4, 64),
}
# The window families (ft_tick_{1u,2u}_window_flags) tick both planes of a
# lane with one uniform: the hash and mantissa fill once, the 1U or 2U
# tick twice, and each plane's restart gate (its epoch flag and item ==
# item, one FSETP.AND each). The warm starts select between a plane and
# the old value, predicated moves; the per-tick epoch flags come from the
# kernel's shared table and are not counted.
OPS_1U_WINDOW_LANE_TICK = {
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    "fp32 add": (5, 128),
    "compare": (10, 64),
}
OPS_2U_WINDOW_LANE_TICK = {
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    "fp32 add": (17, 128),
    "compare": (26, 64),
    "fp32 round (ceil)": (4, None),
    "select": (22, None),
}
# Issue slots per lane-tick, by kernel family (the 2u-dp program runs the
# 2u kernel).
LANE_TICK_OPS = {"1u": OPS_1U_LANE_TICK, "2u": OPS_2U_LANE_TICK,
                 "2u-decay": OPS_2U_DECAY_LANE_TICK,
                 "1u-window": OPS_1U_WINDOW_LANE_TICK,
                 "2u-window": OPS_2U_WINDOW_LANE_TICK}
# The (seed, t) round of the hash is the same for every lane: once per
# tick, seed + t * key (IMAD) and fmix32.
OPS_TICK = {"int32 multiply-add": (3, 64), "int32 shift": (3, 64),
            "int32 logic": (3, 64)}
# A sparse event also advances its lane's clock by its mask.
OPS_CLOCK = {"int32 add": (1, 64)}
ISSUE_PER_SM_CLOCK = 128   # 4 schedulers x 32 lanes; = the FP32 FMA rate


def operation_bound_ms(work, sm_clocks_per_s):
    """(ms, what binds): the least time the card needs for ``work``, pairs
    of (operation table, times it runs), at ``sm_clocks_per_s`` SM clocks
    per second over the whole card. Each class takes its operations over
    its own rate; every operation also takes one of the SM's issue
    slots."""
    counts = {}
    for table, n in work:
        for cls, (ops, rate) in table.items():
            counts[cls] = (counts.get(cls, (0, rate))[0] + ops * n, rate)
    clocks = {cls: ops / rate for cls, (ops, rate) in counts.items() if rate}
    clocks["issue"] = sum(ops for ops, _ in counts.values()) \
        / ISSUE_PER_SM_CLOCK
    binding = max(clocks, key=clocks.get)
    return clocks[binding] / sm_clocks_per_s * 1e3, binding


def issue_slots(table) -> int:
    """Issue slots of one run of an operation table."""
    return sum(ops for ops, _ in table.values())


def kernel_family(layout) -> str:
    """The kernel family whose instantiation runs programs of ``layout``
    (each family has its own layout; 2u-dp shares 2u's)."""
    two_u = any(pair is not None for _, pair in layout.packing)
    algo = "2u" if two_u else "1u"
    if "window" in layout.scalar_names:
        return f"{algo}-window"
    if "alpha_bits" in layout.scalar_names:
        return "2u-decay"
    return algo


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def dense_plan(t: int, g: int, q: int, block_g: int) -> Dict[str, int]:
    """How the kernel cuts one launch over [t, g] items with q lanes per
    group and ``block_g`` threads a block: ``ft_dense_plan`` transcribed.
    Keys: lpt (lanes per thread), threads, rows and cols of an item tile,
    box (columns per TMA box), tiles, blocks, smem_bytes (two tile
    buffers, two tick-hash and two window tables, two mbarriers)."""
    lpt = q if q <= MAX_LANES_PER_THREAD else 1
    # A block's lanes span at most (threads - 1) / Q + 2 groups when a
    # thread holds one lane of a wider group; its tile starts up to 31
    # columns before them.
    cols = block_g if lpt == q else _round_up((block_g - 1) // q + 2 + 31,
                                              32)
    box = cols
    if cols > TMA_BOX_MAX:
        d = TMA_BOX_MAX // 32
        while (cols // 32) % d != 0:
            d -= 1
        box = 32 * d
    rows = min(TILE_BYTES // (8 * cols), TILE_ROWS, _round_up(t, 4))
    rows = max(rows // 4 * 4, 4)
    return {"lpt": lpt, "threads": block_g, "rows": rows, "cols": cols,
            "box": box, "tiles": -(-t // rows),
            "blocks": -(-(g * q) // (block_g * lpt)),
            "smem_bytes": 8 * rows * cols + 16 * rows + 16}


def smem_footprint_bytes(t: int, g: int, q: int, *, block_g: int) -> int:
    """Dynamic shared memory of one block of the launch (the counterpart
    of the JAX model's VMEM footprint): ``dense_plan``'s smem_bytes."""
    return dense_plan(t, g, q, block_g)["smem_bytes"]


def kernel_bytes_per_item(layout, q: int = 1, *,
                          block_t: int, t: int) -> float:
    """Analytic device-memory bytes moved per source item (per group
    column, per tick): the item once, and the group's q lanes' state
    words in and out once per launch its tick range spans. Independent of
    G and block_g."""
    launches = max(math.ceil(t / block_t), 1)
    state_b = q * 2 * layout.num_words * WORD_BYTES * launches / max(t, 1)
    return ITEM_BYTES + state_b


def kernel_bytes_total(g: int, t: int, q: int, layout, *,
                       block_t: int) -> float:
    """Total device-memory bytes of one dense call (module docstring)."""
    per_item = kernel_bytes_per_item(layout, q, block_t=block_t, t=t)
    return t * g * per_item + g * q * ITEM_BYTES  # + final estimates


def predict_kernel(g: int, t: int, q: int, layout, *,
                   block_g: int, block_t: int,
                   hw: Optional[HwSpec] = None,
                   sm_clock_hz: Optional[float] = None,
                   real_items: Optional[int] = None) -> Dict[str, object]:
    """Roofline prediction for one dense call of [t, g] items at q lanes
    per group, launched per ``block_t`` rows with ``block_g`` threads a
    block.

    ``sm_clock_hz`` is the SM clock the operations are priced at (default:
    the part's published maximum, ``SM90_MAX_SM_CLOCK_HZ``); ``real_items``
    the non-NaN items of the data, which the operations count (default
    t·g: every item). Returns the JAX model's keys (``smem_bytes`` for its
    ``vmem_bytes``; ``grid`` = [blocks, launches]) and the operations
    term: ``operations_s``, the class that binds it, ``bound_s`` (the
    larger of ``bandwidth_s`` and ``operations_s``) and ``bound_by``."""
    hw = (hw or detect_hw()).require_known()
    launches = max(math.ceil(t / block_t), 1)
    plan = dense_plan(min(t, block_t), g, q, block_g)
    family = kernel_family(layout)

    bytes_total = kernel_bytes_total(g, t, q, layout, block_t=block_t)
    bandwidth_s = bytes_total / hw.hbm_bw
    operations_s, operations_by, clock = 0.0, None, None
    if hw.name in SM90_MAX_SM_CLOCK_HZ:
        clock = sm_clock_hz or SM90_MAX_SM_CLOCK_HZ[hw.name]
        lane_ticks = (t * g if real_items is None else real_items) * q
        ms, operations_by = operation_bound_ms(
            ((LANE_TICK_OPS[family], lane_ticks), (OPS_TICK, t)),
            hw.cores * clock)
        operations_s = ms / 1e3
    bound_s = max(bandwidth_s, operations_s)
    overhead_s = launches * hw.grid_step_s
    predicted_s = bound_s + overhead_s

    items = t * g
    return {
        "hw": hw.name,
        "hw_nominal": hw.nominal,
        "g": g, "t": t, "q": q, "layout_words": layout.num_words,
        "family": family,
        "block_g": block_g, "block_t": block_t,
        "grid": [plan["blocks"], launches],
        "bytes_total": bytes_total,
        "bytes_per_item": bytes_total / max(items, 1),
        "bandwidth_s": bandwidth_s,
        "operations_s": operations_s,
        "operations_bound_by": operations_by,
        "sm_clock_hz": clock,
        "bound_s": bound_s,
        "bound_by": "bytes" if bandwidth_s >= operations_s else "operations",
        "overhead_s": overhead_s,
        "predicted_s": predicted_s,
        "items_per_s_bound": items / bandwidth_s if bandwidth_s else 0.0,
        "items_per_s_predicted": items / predicted_s if predicted_s else 0.0,
        "smem_bytes": plan["smem_bytes"],
    }
