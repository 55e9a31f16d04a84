"""The cost of a traced function and the collectives its placement implies
(the port's counterpart of the JAX package's ``roofline/hlo_parse.py``).

The JAX package reads FLOPs from XLA's ``cost_analysis`` and collective
bytes from the partitioned HLO text. The port has neither: it runs the
function once, on ``meta`` tensors for a dry run, under
``torch.utils.flop_counter.FlopCounterMode``, which counts every matmul,
convolution and attention op that runs (each layer of the Python loop,
each chunk of the attention loop), so it needs no unrolled probes and no
extrapolation in depth.

Collectives are not traced: a single-controller program issues none. They
are a model of what a partitioner places for a sharding, one step
(``placement_collectives``), priced with the JAX parser's wire rule
(``collective_bytes``):

  all-reduce          2 x result     (reduce-scatter + all-gather phases)
  reduce-scatter      1 x operand
  all-gather, others  1 x result
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

Record = Tuple[str, int, int]        # (op, result bytes, operand bytes)


def traced_cost(fn, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` under FlopCounterMode: {"flops": total,
    "by_op": {op name: FLOPs}, "out": what fn returned}."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    return {"flops": int(counter.get_total_flops()), "by_op": by_op,
            "out": out}


def collective_bytes(records: Iterable[Record]
                     ) -> Tuple[int, Dict[str, int], Dict[str, int]]:
    """(total wire bytes, wire bytes by op, op counts) of ``records``."""
    by_op: Dict[str, int] = defaultdict(int)
    counts: Dict[str, int] = defaultdict(int)
    for op, result_b, operand_b in records:
        if op == "all-reduce":
            wire = 2 * result_b
        elif op == "reduce-scatter":
            wire = operand_b
        else:  # all-gather, all-to-all, collective-permute
            wire = result_b
        by_op[op] += wire
        counts[op] += 1
    return sum(by_op.values()), dict(by_op), dict(counts)


def placement_collectives(leaves, kind: str) -> List[Record]:
    """The collectives one step implies for a placement, per device.

    ``leaves``: (name, shape, itemsize, Sharding, uses, rows, act_bytes)
    per parameter tensor: ``uses`` the times a step runs it, ``rows`` the
    activation rows one use produces on a device, ``act_bytes`` the
    activation dtype's size. For each tensor a step uses:

    * split over 'data' (FSDP): an all-gather of its model-local part
      before the forward and, in training, another before the backward
      and a reduce-scatter of its gradient (an owned layer: the owner's
      whole layer is the result); across pods, in training, the pods'
      all-reduce of that gradient shard;
    * else, in training: the data-parallel all-reduce of its gradient;
    * row-parallel ('wo', 'w_out', 'out_proj', 'cv') and split over
      'model': an all-reduce of its [rows, last dim] output each use, and
      of the input gradient in the backward.

    This models the partitioner the JAX package leaves to XLA; it prices
    no activation resharding, no cache collective and no expert
    all-to-all."""
    from repro_torch.parallel.sharding import _leaf_rule, spec_axes

    train = kind == "train"
    out: List[Record] = []
    for name, shape, itemsize, sh, uses, rows, act_bytes in leaves:
        if not uses:
            continue
        split = {a for e in sh.spec for a in spec_axes(e)} \
            | set(sh.layer_axes)
        local = sh.shard_bytes(shape, itemsize)
        if "data" in split:
            data = sh.mesh.shape["data"]
            gathered = local if "data" in sh.layer_axes else local * data
            out.append(("all-gather", gathered, gathered // data))
            if train:
                out.append(("all-gather", gathered, gathered // data))
                out.append(("reduce-scatter", gathered // data, gathered))
                if "pod" in sh.mesh.shape:
                    out.append(("all-reduce", local, local))
        elif train:
            out.append(("all-reduce", local, local))
        if "model" in split and _leaf_rule(name.rsplit(".", 1)[-1]) == "row":
            act = int(rows) * shape[-1] * act_bytes
            out += [("all-reduce", act, act)] * (uses * (2 if train else 1))
    return out


__all__ = ["traced_cost", "collective_bytes", "placement_collectives"]
