"""The least time an NVIDIA H100 SXM needs for the work of a kernel call,
from published peaks and counted bytes and operations: the yardstick of
the ``*_roofline`` metrics, frozen here so that a change to the program
cannot move it.

Peaks (NVIDIA's H100 SXM data sheet): 132 SMs, 1.98 GHz maximum SM clock,
3.35 TB/s of HBM3. Operations are issue slots by instruction class, each
class at its compute capability 9.0 throughput (CUDA C++ Programming
Guide) and all of them through the SM's 128 issue slots a clock. Per-lane
tick counts sit beside each lane program's reference (``programs/``).
"""
from __future__ import annotations

SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_SM_CLOCK = 128

# The (seed, tick) round of the counter hash: seed + t * key and fmix32.
OPS_TICK = {"int32 multiply-add": (3, 64), "int32 shift": (3, 64),
            "int32 logic": (3, 64)}
ITEM_BYTES = WORD_BYTES = 4


def operations_s(work) -> float:
    """Least seconds for ``work``, pairs of (operation table, times it
    runs): each class over its own rate, and every slot through the issue
    limit, over all SMs at the maximum clock."""
    counts = {}
    for table, n in work:
        for cls, (ops, rate) in table.items():
            counts[cls] = (counts.get(cls, (0, rate))[0] + ops * n, rate)
    clocks = [ops / rate for ops, rate in counts.values() if rate]
    clocks.append(sum(ops for ops, _ in counts.values())
                  / ISSUE_PER_SM_CLOCK)
    return max(clocks) / (SM_COUNT * SM_CLOCK_HZ)


def dense_call_s(prog, ticks: int, groups: int, q: int) -> float:
    """One dense call over [ticks, groups] items into groups * q lanes:
    the items read once, each lane's target read once, its state words
    read and written once; one lane tick a lane and item row, and the
    (seed, tick) round once a row."""
    lanes = groups * q
    nbytes = (ticks * groups * ITEM_BYTES + lanes * 4
              + 2 * lanes * prog.WORDS * WORD_BYTES)
    ops = operations_s(((prog.LANE_TICK_OPS, ticks * lanes),
                        (OPS_TICK, ticks)))
    return max(nbytes / HBM_BYTES_PER_S, ops)

