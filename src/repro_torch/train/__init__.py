"""Training substrate (port of the JAX package's ``train/``): the state
(``train_state.py``), the step builders (``steps.py``), the trainer loop
with its step-time straggler sketch (``trainer.py``), format-4
checkpoints (``checkpoint.py``) and the fleet restore across topologies
(``elastic.py``).

The state and step names load on first use: ``api.fleet`` imports
``train.checkpoint``, and the monitors the step ticks are fleets.
"""
import importlib

_LAZY = {"TrainState": "train_state", "create_train_state": "train_state",
         "make_train_step": "steps", "make_serve_step": "steps"}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
