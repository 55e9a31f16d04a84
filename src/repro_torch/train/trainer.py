"""Trainer loop: checkpoint and restart, straggler detection (a frugal
q99 of step times: the paper's sketch run on the trainer itself),
preemption-safe (port of the JAX package's ``train/trainer.py``).

Every piece of cross-step state lives in the ``TrainState``, so a restart
is a restore and a continue; host-side state is the step-time sketch and
the checkpoint writer. The step runs eagerly: there is no counterpart of
the JAX package's ``jit`` and buffer donation. Like the JAX trainer,
``run`` reads the next batch of whatever iterator it was given: a
restarted run that builds a fresh iterator reads its stream from the
first batch again.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Optional

import numpy as np

from . import checkpoint as ckpt_lib


class StepTimeMonitor:
    """Host-side frugal q99 sketch over step wall-times (2 floats of
    state): the JAX package's, draw for draw (``np.random.default_rng``)
    and step for step (``math.ceil``), in Python floats.

    A host whose step time exceeds margin x fleet-q99 is flagged a
    straggler; the flag is surfaced in the metrics."""

    def __init__(self, quantile: float = 0.99, margin: float = 1.5,
                 seed: int = 0):
        self.q = quantile
        self.margin = margin
        self.m = 0.0
        self.step_size = 1.0
        self.sign = 1.0
        self._rng = np.random.default_rng(seed)
        self.count = 0

    def observe(self, dt: float) -> bool:
        """Feed one step time in seconds; returns the straggler flag."""
        x = dt * 1000.0  # ms resolution for the +-1 walk
        r = float(self._rng.random())
        # Frugal-2U tick (paper Alg. 3, f = 1), persistent (m, step, sign)
        m, step, sign, q = self.m, self.step_size, self.sign, self.q
        if x > m and r > 1.0 - q:
            step += 1.0 if sign > 0 else -1.0
            m += math.ceil(step) if step > 0 else 1.0
            if m > x:
                step += x - m
                m = x
            if sign < 0 and step > 1:
                step = 1.0
            sign = 1.0
        elif x < m and r > q:
            step += 1.0 if sign < 0 else -1.0
            m -= math.ceil(step) if step > 0 else 1.0
            if m < x:
                step += m - x
                m = x
            if sign > 0 and step > 1:
                step = 1.0
            sign = -1.0
        self.m, self.step_size, self.sign = m, step, sign
        self.count += 1
        return self.count > 20 and x > self.margin * max(self.m, 1e-9)

    @property
    def q99_ms(self) -> float:
        return self.m


class Trainer:
    def __init__(self, model, optimizer, train_step: Callable, data_iter,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, log_every: int = 10,
                 log_fn: Callable = print):
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.data_iter = data_iter
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.log_every = log_every
        self.log_fn = log_fn
        self.step_monitor = StepTimeMonitor()
        self.metrics_history = []

    # ------------------------------------------------------------ lifecycle
    def restore_or_init(self, init_state) -> Any:
        """The newest committed checkpoint of ``ckpt_dir`` restored into
        ``init_state``'s structure (its model's weights overwritten), or
        ``init_state`` where there is none."""
        if self.ckpt_dir and ckpt_lib.latest_step(self.ckpt_dir) is not None:
            state, step = ckpt_lib.restore_train_state(self.ckpt_dir,
                                                       init_state)
            self.log_fn(f"[trainer] resumed from step {step}")
            return state
        return init_state

    def save(self, step: int, state) -> None:
        ckpt_lib.save_train_state(self.ckpt_dir, step, state, keep=self.keep)

    def run(self, state, num_steps: int) -> Any:
        start = int(state.step)
        for i in range(start, num_steps):
            batch = next(self.data_iter)
            t0 = time.time()
            state, metrics = self.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            straggler = self.step_monitor.observe(dt)
            metrics["step_time_s"] = dt
            metrics["straggler"] = straggler
            metrics["step"] = i + 1
            self.metrics_history.append(metrics)
            if (i + 1) % self.log_every == 0:
                self.log_fn(
                    f"[step {i + 1}] loss={metrics['loss']:.4f} "
                    f"gnorm={metrics.get('grad_norm', 0.0):.3f} "
                    f"dt={dt * 1000:.0f}ms "
                    f"q99={self.step_monitor.q99_ms:.0f}ms"
                    + (" STRAGGLER" if straggler else ""))
            if self.ckpt_dir and (i + 1) % self.ckpt_every == 0:
                self.save(i + 1, state)
        if self.ckpt_dir:
            self.save(num_steps, state)
        return state
