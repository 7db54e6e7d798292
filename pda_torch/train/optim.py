"""The optimizer and the learning-rate plateau controller (port of
``pda/train/optim.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """Adam as optax's ``adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8
    added after the square root, both moments bias-corrected. The learning
    rate lives in ``param_groups`` and may change between steps."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


@dataclass
class ReduceLROnPlateau:
    """``pda``'s plateau controller (torch's ``ReduceLROnPlateau(mode='min',
    factor=0.9, patience=10)`` as the reference trainers configure it), kept
    apart from the optimizer: ``step(metric, lr)`` returns the rate to set.

    An epoch is better when ``metric < best * (1 - threshold)``; after more
    than ``patience`` worse epochs in a row the rate is multiplied by
    ``factor`` (floored at ``min_lr``). Unlike
    ``torch.optim.lr_scheduler.ReduceLROnPlateau`` it has no ``eps`` rule,
    which skips any reduction smaller than 1e-8, so the two part once the
    rate falls below about 1e-7."""

    factor: float = 0.9
    patience: int = 10
    min_lr: float = 0.0
    threshold: float = 1e-4
    best: float = field(default=float("inf"), init=False)
    num_bad_epochs: int = field(default=0, init=False)

    def _is_better(self, metric: float) -> bool:
        if self.best == float("inf"):
            return True
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float, current_lr: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
            return current_lr
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
