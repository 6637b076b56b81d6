"""Learning-rate schedules: const / piecewise-constant / reduce-on-plateau
(counterpart of ``wssdl_bus_tpu/train/schedules.py``).

The reference solver's three options (train_bus.py:274-282 and its
Keras-style ``ReduceLROnPlateau``, train_bus.py:32-94).  The LR is resolved
on the host each iteration and passed to the step as a float.  Pure Python;
each schedule has ``state_dict`` / ``load_state_dict`` for an exact resume.
"""

from __future__ import annotations

import numpy as np


class ConstSchedule:
    def __init__(self, lr: float):
        self.lr = lr

    def __call__(self, step: int) -> float:
        return self.lr

    def on_val_end(self, logs):
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict):
        pass


class PiecewiseConstant:
    """0.1x after 75% of max_iters (train_bus.py:276-279)."""

    def __init__(self, lr: float, max_iters: int):
        self.lr = lr
        self.boundary = int(max_iters * 0.75)

    def __call__(self, step: int) -> float:
        # tf.train.piecewise_constant returns values[0] for
        # step <= boundaries[0] (inclusive), train_bus.py:277-279
        return self.lr if step <= self.boundary else self.lr * 0.1

    def on_val_end(self, logs):
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict):
        pass


class ReduceLROnPlateau:
    """Halve the LR when the monitored test loss stops improving
    (train_bus.py:32-94; instantiated with factor=0.5, patience=5,
    epsilon=1e-3, mode='min', cooldown=0, min_lr=0 at :281)."""

    def __init__(self, init_lr: float, factor: float = 0.5,
                 patience: int = 5, epsilon: float = 1e-3,
                 cooldown: int = 0, min_lr: float = 0.0,
                 verbose: bool = True):
        if factor >= 1.0:
            raise ValueError("ReduceLROnPlateau needs factor < 1.0")
        self.cur_lr = init_lr
        self.factor = factor
        self.patience = patience
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        self.cooldown_counter = 0
        self.wait = 0
        self.best = np.inf

    def in_cooldown(self) -> bool:
        return self.cooldown_counter > 0

    def on_val_end(self, logs):
        """Feed the running list of periodic test losses (train_bus.py:898)."""
        assert len(logs) != 0
        current = logs[-1]
        if self.in_cooldown():
            self.cooldown_counter -= 1
            self.wait = 0
        if current < self.best - self.epsilon:
            self.best = current
            self.wait = 0
        elif not self.in_cooldown():
            if self.wait >= self.patience:
                if self.cur_lr > self.min_lr:
                    self.cur_lr = max(self.cur_lr * self.factor, self.min_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {self.cur_lr}")
                    self.cooldown_counter = self.cooldown
                    self.wait = 0
            self.wait += 1

    def __call__(self, step: int) -> float:
        return self.cur_lr

    def state_dict(self) -> dict:
        return {"cur_lr": self.cur_lr, "cooldown_counter":
                self.cooldown_counter, "wait": self.wait,
                "best": float(self.best)}

    def load_state_dict(self, d: dict):
        self.cur_lr = d["cur_lr"]
        self.cooldown_counter = d["cooldown_counter"]
        self.wait = d["wait"]
        self.best = d["best"]


def build_schedule(name: str, lr: float, max_iters: int):
    if name == "const":
        return ConstSchedule(lr)
    if name == "pc":
        return PiecewiseConstant(lr, max_iters)
    if name == "rop":
        return ReduceLROnPlateau(lr)
    raise NotImplementedError(f"lr_scheduling {name!r}")
