"""Monte-Carlo pseudo-labels + consensus (port of ``pda/core/consensus.py``).

  samples    = sigmoid(logits_s),  s = 1..n
  agree_s    = (samples_s >= upper) | (samples_s <= lower)
  pseudo     = mean_s samples_s
  consensus  = mean_s agree_s;  masking: consensus = (consensus == 1)

This is also the plain version of the reduction in the MC-consensus kernel
(``pda_torch.kernels.mc_consensus``). :func:`distribution_alignment` is
FixMatch's rescaling of the pseudo-labels.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

UPPER_THRESHOLD = 0.9
LOWER_THRESHOLD = 0.1


def consensus_from_probs(
    sample_probs: torch.Tensor,
    *,
    upper: float = UPPER_THRESHOLD,
    lower: float = LOWER_THRESHOLD,
    masking: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pseudo_label, consensus) from (n_samples, ...) probabilities."""
    pseudo = sample_probs.mean(dim=0)
    agree = (sample_probs >= upper) | (sample_probs <= lower)
    consensus = agree.to(sample_probs.dtype).mean(dim=0)
    if masking:
        consensus = (consensus == 1.0).to(sample_probs.dtype)
    return pseudo, consensus


def consensus_from_logits(
    sample_logits: torch.Tensor,
    *,
    upper: float = UPPER_THRESHOLD,
    lower: float = LOWER_THRESHOLD,
    masking: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same as :func:`consensus_from_probs`, thresholds compared in logit
    space (p >= u  <=>  logit >= log(u / (1 - u))); the Python-float
    thresholds round to the logits' dtype, as in ``pda``."""
    pseudo = torch.sigmoid(sample_logits).mean(dim=0)
    logit_upper = math.log(upper / (1.0 - upper))
    logit_lower = math.log(lower / (1.0 - lower))
    agree = (sample_logits >= logit_upper) | (sample_logits <= logit_lower)
    consensus = agree.to(pseudo.dtype).mean(dim=0)
    if masking:
        consensus = (consensus == 1.0).to(pseudo.dtype)
    return pseudo, consensus


def distribution_alignment(pseudo: torch.Tensor, source_distribution, *,
                           eps: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """FixMatch distribution alignment: ``(aligned, ratio)``.

    The target's binary class frequency is the foreground share
    ``fg = mean(pseudo >= 0.5)``; ``ratio = source / ([1 - fg, fg] + eps)``
    (``source_distribution`` = [bg, fg]); each pseudo-label is scaled by the
    ratio of its side of 0.5 and clipped to [0, 1]. Single device: ``pda``'s
    ``axis_name`` (a global-batch mean) comes with data parallelism."""
    fg = (pseudo >= 0.5).to(pseudo.dtype).mean()
    source = torch.as_tensor(source_distribution, dtype=pseudo.dtype, device=pseudo.device)
    ratio = source / (torch.stack([1.0 - fg, fg]) + eps)
    aligned = torch.where(pseudo < 0.5, pseudo * ratio[0], pseudo * ratio[1])
    return aligned.clamp(0.0, 1.0), ratio
