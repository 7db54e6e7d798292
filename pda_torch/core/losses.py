"""Segmentation losses and the PUNet ELBO (port of ``pda/core/losses.py``).

Reductions as in ``pda`` (and the reference it restates):
  * BCE recon loss: elementwise, then summed over all axes.
  * Dice-with-logits recon loss (``rl_swap=True``): channelwise dice over
    batch + spatial axes, ``1 - dice`` summed over channels.
  * KL: mean over the batch.
  * neg_elbo = recon + beta * kl.

Single device only: ``pda``'s ``axis_name`` / ``space_axis`` arguments come
with data parallelism.
"""

from __future__ import annotations

from typing import Optional

import torch

from .distributions import DiagGaussian, kl_divergence, mc_kl_divergence


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (no reduction), in the
    stable form ``max(x, 0) - x t + log(1 + exp(-|x|))``."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _dice(pred: torch.Tensor, targets: torch.Tensor, eps: float) -> torch.Tensor:
    dims = tuple(range(pred.ndim - 1))  # all but the channel axis
    num = 2.0 * torch.sum(pred * targets, dim=dims)
    denom = torch.sum(pred.square(), dim=dims) + torch.sum(targets.square(), dim=dims)
    return torch.sum(1.0 - num / denom.clamp(min=eps))


def dice_loss_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                          eps: float = 1e-7) -> torch.Tensor:
    """Channelwise soft-dice loss on sigmoided logits, summed over channels:
    per channel ``1 - 2 sum(p t) / max(sum(p^2) + sum(t^2), eps)``, the sums
    over batch and spatial axes (NHWC)."""
    return _dice(torch.sigmoid(logits), targets, eps)


def dice_loss(pred: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Channelwise soft-dice loss on probabilities."""
    return _dice(pred, targets, eps)


def neg_elbo(reconstruction_logits: torch.Tensor, segm: torch.Tensor,
             posterior: DiagGaussian, prior: DiagGaussian, *, beta: float = 1.0,
             rl_swap: bool = True, consensus_mask: Optional[torch.Tensor] = None,
             consensus_masking: bool = False, analytic_kl: bool = True,
             z_posterior: Optional[torch.Tensor] = None):
    """Negative ELBO as ``pda`` computes it: ``(recon + beta * kl, aux)``.

    KL is the batch mean of the analytic KL(posterior || prior), or with
    ``analytic_kl=False`` of the single-sample estimate at ``z_posterior``,
    the draw that produced the reconstruction. With consensus masking the
    consensus multiplies the LOGITS (and the targets), so a masked pixel's
    logit is 0 and its sigmoid of 0.5 still enters the dice denominators.
    ``aux`` holds ``recon_loss`` and ``kl``."""
    if analytic_kl:
        kl = kl_divergence(posterior, prior).mean()
    else:
        if z_posterior is None:
            raise ValueError("analytic_kl=False requires the posterior draw "
                             "z_posterior that produced the reconstruction")
        kl = mc_kl_divergence(posterior, prior, z_posterior).mean()
    rec_in, seg_in = reconstruction_logits, segm
    if consensus_masking and consensus_mask is not None:
        rec_in, seg_in = rec_in * consensus_mask, seg_in * consensus_mask
    if rl_swap:
        recon = dice_loss_with_logits(rec_in, seg_in)
    else:
        recon = torch.sum(bce_with_logits(rec_in, seg_in))
    return recon + beta * kl, {"recon_loss": recon, "kl": kl}
