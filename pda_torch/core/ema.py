"""Exponential-moving-average teacher updates (port of ``pda/core/ema.py``),
in place over module parameters."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, momentum: float) -> None:
    """teacher <- momentum * teacher + (1 - momentum) * student, parameter
    by parameter, in place (the two modules share one architecture)."""
    t, s = list(teacher.parameters()), list(student.parameters())
    if len(t) != len(s):
        raise ValueError(f"teacher has {len(t)} parameters, student {len(s)}")
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - momentum))


def ramped_momentum(step: float, momentum: float = 0.999) -> float:
    """AdaMT's ramped momentum ``min(1 - 1/(step + 1), momentum)``."""
    return min(1.0 - 1.0 / (step + 1.0), momentum)
