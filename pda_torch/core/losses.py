"""Segmentation losses and the PUNet ELBO (port of ``pda/core/losses.py``).

Reductions as in ``pda`` (and the reference it restates):
  * BCE recon loss: elementwise, then summed over all axes.
  * Dice-with-logits recon loss (``rl_swap=True``): channelwise dice over
    batch + spatial axes, ``1 - dice`` summed over channels.
  * KL: mean over the batch.
  * neg_elbo = recon + beta * kl.

On a data mesh (``mesh=``, ``pda``'s ``axis_name``) every batch reduction
is value-global and gradient-local (:func:`_gsum`, :func:`_gmean`): the
forward value is the global batch's, so the dice ratio sees the operands of
the single-device program, while autograd sees only the rank's own term, so
no collective is ever differentiated. Summing the ranks' gradients
(``steps._apply_updates``) then gives the single-device gradient.

On a (``data``, ``space``) mesh (``pda``'s ``space_axis``) the pixel sums
(the dice's, the BCE's) cross the world, the KL's batch mean the ``data``
axis only (each row shard holds its images' whole statistics, the encoders'
mean being space-global), and the KL, computed alike on every row shard,
enters the differentiated objective with 1/M of its gradient and its whole
value, so that the world's gradient sum counts it once.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import DATA_AXIS, SPACE_AXIS
from .distributions import DiagGaussian, kl_divergence, mc_kl_divergence


def _gsum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum over the mesh's ranks whose VALUE is global and whose GRADIENT is
    local: ``x + (all_reduce(x) - x)`` with both corrections detached.
    Differentiating the collective instead would scale every gradient by the
    rank count once the gradients are summed (``pda``'s ``_gsum``)."""
    if mesh is None:
        return x
    local = x.detach()
    return x + (mesh.all_reduce(local) - local)


def _gmean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Global-batch mean (equal shards): ``all_reduce(m) / n + (m - m) / n``
    with ``m`` the local mean, the first term and the second's subtrahend
    detached, so the local term carries 1/n of the gradient, which is
    d(global mean)/d(local element) (``pda``'s ``_gmean``)."""
    m = x.mean()
    if mesh is None:
        return m
    local = m.detach()
    return mesh.all_reduce(local) / mesh.world + (m - local) / mesh.world


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (no reduction), in the
    stable form ``max(x, 0) - x t + log(1 + exp(-|x|))``."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _dice(pred: torch.Tensor, targets: torch.Tensor, eps: float, mesh=None) -> torch.Tensor:
    dims = tuple(range(pred.ndim - 1))  # all but the channel axis
    num = _gsum(2.0 * torch.sum(pred * targets, dim=dims), mesh)
    denom = _gsum(torch.sum(pred.square(), dim=dims) + torch.sum(targets.square(), dim=dims),
                  mesh)
    return torch.sum(1.0 - num / denom.clamp(min=eps))


def dice_loss_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                          eps: float = 1e-7, mesh=None) -> torch.Tensor:
    """Channelwise soft-dice loss on sigmoided logits, summed over channels:
    per channel ``1 - 2 sum(p t) / max(sum(p^2) + sum(t^2), eps)``, the sums
    over batch and spatial axes (NHWC), on a ``mesh`` over the global batch
    before the ratio."""
    return _dice(torch.sigmoid(logits), targets, eps, mesh)


def dice_loss(pred: torch.Tensor, targets: torch.Tensor, eps: float = 1e-7,
              mesh=None) -> torch.Tensor:
    """Channelwise soft-dice loss on probabilities."""
    return _dice(pred, targets, eps, mesh)


def neg_elbo(reconstruction_logits: torch.Tensor, segm: torch.Tensor,
             posterior: DiagGaussian, prior: DiagGaussian, *, beta: float = 1.0,
             rl_swap: bool = True, consensus_mask: Optional[torch.Tensor] = None,
             consensus_masking: bool = False, analytic_kl: bool = True,
             z_posterior: Optional[torch.Tensor] = None, mesh=None):
    """Negative ELBO as ``pda`` computes it: ``(recon + beta * kl, aux)``.

    KL is the batch mean of the analytic KL(posterior || prior), or with
    ``analytic_kl=False`` of the single-sample estimate at ``z_posterior``,
    the draw that produced the reconstruction. With consensus masking the
    consensus multiplies the LOGITS (and the targets), so a masked pixel's
    logit is 0 and its sigmoid of 0.5 still enters the dice denominators.
    ``aux`` holds ``recon_loss`` and ``kl``. On a ``mesh`` the KL mean, the
    dice sums and the BCE sum are the global batch's (module docstring)."""
    data = None if mesh is None else mesh.axis(DATA_AXIS)
    if analytic_kl:
        kl = _gmean(kl_divergence(posterior, prior), data)
    else:
        if z_posterior is None:
            raise ValueError("analytic_kl=False requires the posterior draw "
                             "z_posterior that produced the reconstruction")
        kl = _gmean(mc_kl_divergence(posterior, prior, z_posterior), data)
    rec_in, seg_in = reconstruction_logits, segm
    if consensus_masking and consensus_mask is not None:
        rec_in, seg_in = rec_in * consensus_mask, seg_in * consensus_mask
    if rl_swap:
        recon = dice_loss_with_logits(rec_in, seg_in, mesh=mesh)
    else:
        recon = _gsum(torch.sum(bce_with_logits(rec_in, seg_in)), mesh)
    kl_term = kl
    if mesh is not None and SPACE_AXIS in mesh.shape:
        local = kl.detach()
        kl_term = local + (kl - local) / mesh.n_space
    return recon + beta * kl_term, {"recon_loss": recon, "kl": kl}
