"""Train and validation steps of the PUNet (port of ``pda/train/steps.py``):
supervised PUNet training and Mean-Teacher self-training.

Each factory returns ``step(state, *batch, ...) -> (state, aux)``. Batches
are NHWC tensors on the model's device. A step updates the state's modules
and optimizer in place (``pda``'s jitted steps return a new state) and
returns it with ``aux``, a dict of 0-d tensors.

Noise is explicit, since torch cannot reproduce ``jax.random`` streams: the
posterior draw takes ``eps_post`` (B, L), the teacher's MC draws
``eps_teacher`` (n, B, L) and the validation MC draws ``eps_mc`` (n, B, L);
or a ``torch.Generator`` draws whichever is not given, in that order of use.
``pda`` draws them as ``jax.random.normal`` of the keys its step splits off
``state.rng``, so handing those arrays in reproduces its step.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.ema import ema_update
from ..core.losses import neg_elbo
from ..core.metrics import dice_score_torch
from ..models.punet import ProbabilisticUnet, mc_predict_probs, mc_pseudo
from .state import TrainState, punet_l2_reg

REG_WEIGHT = 1e-5  # reference punet_trainer.py:34
N_MC_TRAIN = 16  # reference mean_teacher_trainer.py:36
N_MC_VAL = 8  # reference punet_trainer.py:70


def _punet_loss(model: ProbabilisticUnet, x, segm, eps_post=None,
                generator: Optional[torch.Generator] = None, consm=None,
                reconstruct_posterior_mean: bool = False):
    """-ELBO + 1e-5 * l2 over the regularized subset: ``(loss, aux)``.

    ``reconstruct_posterior_mean`` decodes the posterior mean instead of the
    draw for the reconstruction, while the MC-KL option still evaluates at
    the draw (the reference's ``elbo(..., reconstruct_posterior_mean=True)``).
    """
    enc = model.encode(x, segm)
    z_post = enc.posterior.sample(eps=eps_post, generator=generator)
    z_rec = enc.posterior.mu if reconstruct_posterior_mean else z_post
    recon = model.decode(enc.features, z_rec)
    nelbo, aux = neg_elbo(
        recon, segm, enc.posterior, enc.prior, beta=model.beta, rl_swap=model.rl_swap,
        consensus_mask=consm, consensus_masking=model.consensus_masking,
        analytic_kl=model.analytic_kl, z_posterior=z_post)
    loss = nelbo + REG_WEIGHT * punet_l2_reg(model)
    return loss, {"loss": loss, **aux}


@torch.no_grad()
def _mc_pseudo(model: ProbabilisticUnet, x, n_samples: int, masking: bool, eps=None,
               generator: Optional[torch.Generator] = None):
    """Teacher-style MC pseudo-label and consensus, gradient-free: the
    MC-consensus kernel on the card (``pda`` takes its XLA path here by
    default, ``steps.py`` ``USE_PALLAS_MC``; both compute the same)."""
    return mc_pseudo(model, x, n_samples, eps=eps, generator=generator, masking=masking)


def _apply_updates(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1


def _detached(aux: dict) -> dict:
    return {k: v.detach() for k, v in aux.items()}


def make_supervised_punet_step():
    """Supervised PUNet training: -ELBO on (x, y), one Adam step."""

    def step(state: TrainState, x, y, *, eps_post=None,
             generator: Optional[torch.Generator] = None):
        loss, aux = _punet_loss(state.model, x, y, eps_post, generator)
        _apply_updates(state, loss)
        return state, _detached(aux)

    return step


def make_punet_val_step(n_samples: int = N_MC_VAL):
    """Train-style loss, and the dice of the MC-n mean probability (``pda``'s
    ``_mc_mean_probs``) against the target; metric = 1 - dice."""

    @torch.no_grad()
    def step(state: TrainState, x, y, *, eps_post=None, eps_mc=None,
             generator: Optional[torch.Generator] = None):
        _, aux = _punet_loss(state.model, x, y, eps_post, generator)
        pred = mc_predict_probs(state.model, x, n_samples, eps=eps_mc, generator=generator)
        dice = dice_score_torch(pred, y)
        return state, {"loss": aux["loss"], "dice": dice, "metric": 1.0 - dice}

    return step


def make_mean_teacher_step(*, momentum: float = 0.999, do_consensus_masking: bool = False,
                           n_samples: int = N_MC_TRAIN):
    """Mean-Teacher step: the teacher's MC-n pseudo-label y and consensus z
    on the weak view x1; the student's -ELBO on (x2, y, z) and one Adam
    step; then the teacher's EMA toward the UPDATED student. ``x`` and
    ``gt`` are unused, as in ``pda``."""

    def step(state: TrainState, x, x1, x2, gt, *, eps_teacher=None, eps_post=None,
             generator: Optional[torch.Generator] = None):
        y, z = _mc_pseudo(state.teacher, x1, n_samples, do_consensus_masking,
                          eps_teacher, generator)
        loss, aux = _punet_loss(state.model, x2, y, eps_post, generator, consm=z)
        _apply_updates(state, loss)
        ema_update(state.teacher, state.model, momentum)
        return state, _detached(aux)

    return step


def make_mean_teacher_val_step(*, do_consensus_masking: bool = False,
                               n_samples: int = N_MC_TRAIN):
    """Teacher pseudo-label on x1, the student's loss on (x2, y, z), and the
    student's MC mean-probability dice against y (metric) and against the
    true gt (gt_metric)."""

    @torch.no_grad()
    def step(state: TrainState, x, x1, x2, gt, *, eps_teacher=None, eps_post=None,
             eps_mc=None, generator: Optional[torch.Generator] = None):
        y, z = _mc_pseudo(state.teacher, x1, n_samples, do_consensus_masking,
                          eps_teacher, generator)
        _, aux = _punet_loss(state.model, x2, y, eps_post, generator, consm=z)
        pred = mc_predict_probs(state.model, x2, n_samples, eps=eps_mc, generator=generator)
        dice, gt_dice = dice_score_torch(pred, y), dice_score_torch(pred, gt)
        return state, {"loss": aux["loss"], "dice": dice, "metric": 1.0 - dice,
                       "gt_metric": 1.0 - gt_dice}

    return step
