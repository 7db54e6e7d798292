"""Train state and the PUNet's regularized parameter subset (port of
``pda/train/state.py``).

``pda``'s state is a pytree that each jitted step returns anew; here it holds
modules and an optimizer that a step updates in place. ``pda``'s
``state.rng`` has no field here: the noise comes from a ``torch.Generator``
that the trainer owns.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Mapping, Optional, Union

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

    @property
    def learning_rate(self) -> float:
        """The optimizer's learning rate (its first parameter group's)."""
        return float(self.optimizer.param_groups[0]["lr"])

    def replace_lr(self, new_lr: float) -> "TrainState":
        """Set the learning rate of every parameter group, in place."""
        for group in self.optimizer.param_groups:
            group["lr"] = new_lr
        return self


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                       with_teacher: bool = False,
                       teacher: Optional[Union[nn.Module, Mapping]] = None) -> TrainState:
    """Fresh state. The teacher (if any) takes no gradients; it starts as a
    copy of the student, or from ``teacher``: a module, or a state dict such
    as a checkpoint's ``teacher_state`` (``pda``'s ``teacher_params=``)."""
    if not with_teacher:
        return TrainState(model=model, optimizer=optimizer)
    if isinstance(teacher, nn.Module):
        t = teacher
    else:
        t = copy.deepcopy(model)
        if teacher is not None:
            t.load_state_dict(teacher)
    return TrainState(model=model, optimizer=optimizer, teacher=t.requires_grad_(False))


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
