"""Train state and the PUNet's regularized parameter subset (port of
``pda/train/state.py``).

``pda``'s state is a pytree that each jitted step returns anew; here it holds
modules and an optimizer that a step updates in place.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.regularization import l2_regularisation
from ..models.punet import ProbabilisticUnet


@dataclass
class TrainState:
    """Everything that evolves during training."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    #: EMA teacher for Mean-Teacher training; None elsewhere
    teacher: Optional[nn.Module] = None
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                       with_teacher: bool = False) -> TrainState:
    """Fresh state; the teacher (if any) starts as a copy of the student and
    takes no gradients."""
    teacher = copy.deepcopy(model).requires_grad_(False) if with_teacher else None
    return TrainState(model=model, optimizer=optimizer, teacher=teacher)


def punet_l2_reg(model: ProbabilisticUnet) -> torch.Tensor:
    """l2(posterior) + l2(prior) + l2(Fcomb without ``last_layer``), as
    ``pda`` regularizes it: leaf by leaf. ``pda`` keeps the Fcomb's first
    layer as two Dense leaves, ``feat_proj`` (no bias) and ``z_proj``; the
    port holds it as one ``(C0, C0 + L)`` kernel, so its feature and latent
    parts enter as two norms, not one."""
    fc = model.fcomb
    first, *mids = fc.convs()
    c0 = fc.num_filters0
    tensors = [*model.posterior.parameters(), *model.prior.parameters(),
               first.weight[:, :c0], first.weight[:, c0:], first.bias]
    for m in mids:
        tensors += [m.weight, m.bias]
    return l2_regularisation(tensors)
