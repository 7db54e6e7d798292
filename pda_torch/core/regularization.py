"""Parameter-norm regularization (port of ``pda/core/regularization.py``)."""

from __future__ import annotations

from typing import Iterable

import torch


def l2_regularisation(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The SUM of the 2-norms of the tensors (not a squared norm, and not one
    global norm)."""
    return sum(torch.linalg.vector_norm(t) for t in tensors)
