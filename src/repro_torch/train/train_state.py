"""TrainState: the model, the optimizer state, the step, the key words,
the frugal monitors and the quantile clip (port of the JAX package's
``train/train_state.py``).

``params`` is the ``CausalLM`` module itself, whose tensors the optimizer
updates in place; the moments are keyed by its parameter names. ``step``
and ``qclip.warmup`` are host ints; ``rng`` is two uint32 key words,
split with the ported threefry (``core.rng.split``) as the JAX package
splits its key. ``models.convert`` carries a state to and from the JAX
package's stacked layout, which checkpoints use.

``abstract_train_state`` is the dry run's state: ``create_train_state``
on a model whose tensors are all on ``meta`` (shapes and dtypes, no
storage).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import rng as crng
from repro_torch.models.blocks import stage_unit_kinds
from repro_torch.optim import Optimizer
from repro_torch.optim.clipping import QuantileClipState, quantile_clip_init


class TrainState(NamedTuple):
    params: Any                    # the CausalLM (its parameters)
    opt_state: Any                 # AdamWState / LionState
    step: int
    rng: np.ndarray                # [2] uint32 key words
    monitors: Optional[Any]        # monitor.registry.TrainMonitors
    qclip: Optional[QuantileClipState]


def clip_blocks(model) -> Tuple[Tuple[str, ...], Dict[str, List[str]]]:
    """The quantile clip's groups: the JAX parameter tree's top-level keys
    in sorted order, and each one's parameter names. A decoder's are
    ``embed``, ``final_norm``, [``lm_head``], [``pos``], ``prefix``,
    [``shared_block``], ``stack`` (``prefix`` may be empty): every
    stacked layer falls in ``stack``, zamba2's shared block is its own
    group, as in JAX. An encoder-decoder's are its six top-level keys
    (``dec_norm``, ``dec_pos``, ``dec_stack``, ``embed``, ``enc_norm``,
    ``enc_stack``), which its parameter names begin with."""
    blocks: Dict[str, List[str]] = {}
    if not model.cfg.is_encdec:
        blocks.update(prefix=[], stack=[])
    n_prefix = len(stage_unit_kinds(model.cfg)[0])
    for name, _ in model.named_parameters():
        top, rest = name.split(".", 1)
        if top == "layers":
            top = "prefix" if int(rest.split(".", 1)[0]) < n_prefix \
                else "stack"
        blocks.setdefault(top, []).append(name)
    keys = tuple(sorted(blocks))
    return keys, blocks


def create_train_state(model, optimizer: Optimizer, key,
                       example_batch=None, with_monitors: bool = True,
                       with_quantile_clip: bool = True) -> TrainState:
    """The state of a fresh run of ``model`` (a ``CausalLM`` or an
    ``EncDecLM`` with its initial weights; the port draws them from a ``torch.Generator``, see
    ``models.build_model``). ``key``: uint32 key words
    (``core.rng.prng_key(seed)``), split as the JAX package splits its
    init key; the second child becomes the state's key. Monitors come
    with an ``example_batch``, as in the JAX package."""
    from repro_torch.monitor.registry import init_train_monitors

    _, k_rng = crng.split(key)
    dev = model.device
    opt_state = optimizer.init(dict(model.named_parameters()))
    monitors = None
    if with_monitors and example_batch is not None:
        monitors = init_train_monitors(model, device=dev)
    qclip = None
    if with_quantile_clip:
        qclip = quantile_clip_init(len(clip_blocks(model)[0]), device=dev)
    return TrainState(params=model, opt_state=opt_state, step=0, rng=k_rng,
                      monitors=monitors, qclip=qclip)


def abstract_train_state(model, optimizer: Optimizer, key,
                         example_batch=None, with_monitors: bool = True,
                         with_quantile_clip: bool = True) -> TrainState:
    """``create_train_state`` on ``model``'s ``meta`` twin (``model``
    itself where it is on meta, else a fresh ``build_model(model.cfg,
    device="meta")``): the moments, the monitors' and the clip's planes
    are meta tensors, the key words a host array. Allocates nothing."""
    if model.device.type != "meta":
        from repro_torch.models import build_model

        model = build_model(model.cfg, device="meta")
    return create_train_state(model, optimizer, key,
                              example_batch=example_batch,
                              with_monitors=with_monitors,
                              with_quantile_clip=with_quantile_clip)
