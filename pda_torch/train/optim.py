"""The optimizer (port of ``pda/train/optim.py``'s ``adam``)."""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """Adam as optax's ``adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8
    added after the square root, both moments bias-corrected. The learning
    rate lives in ``param_groups`` and may change between steps."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
