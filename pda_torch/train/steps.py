"""Train and validation steps of every training algorithm (port of
``pda/train/steps.py``):

  supervised PUNet, pseudo UNet, pseudo PUNet, Mean Teacher, FixMatch,
  AdaMT (joint Mean Teacher), AdaMatch (joint FixMatch), supervised UNet

Each factory returns ``step(state, *batch, ...) -> (state, aux)``. Batches
are NHWC tensors on the model's device. A step updates the state's modules
and optimizer in place (``pda``'s jitted steps return a new state) and
returns it with ``aux``, a dict of 0-d tensors.

Noise is explicit, since torch cannot reproduce ``jax.random`` streams. The
arrays are named after the keys ``pda``'s steps split off ``state.rng``:
the target (or only) posterior draw ``eps_post`` (B, L) goes with
``k_post``, the source posterior draw ``eps_source`` (B, L) with ``k_s``,
the teacher's MC draws ``eps_teacher`` (n, B, L) with ``k_t``, the model's
own (weak-view) MC draws ``eps_weak`` (n, B, L) with ``k_w`` and the
validation MC draws ``eps_mc`` (n, B, L) with ``k_mc``. ``pda`` draws each as
``jax.random.normal`` of its key, so handing those arrays in reproduces its
step; each step's docstring gives the split. A ``torch.Generator`` draws
whichever is not given, in the order the step uses them.

Data parallelism (``mesh=``, ``pda``'s ``axis_name=``): on a data mesh of N
ranks (:mod:`pda_torch.parallel`) each rank runs the step on its rows of the
global batch. The losses' and metrics' batch reductions are the global
batch's (value-global, gradient-local: :mod:`pda_torch.core.losses`); after
``backward()`` the gradients are summed over the ranks (never averaged),
then the optimizer steps, so every rank applies the single-device update;
the parameter-only L2 term enters the differentiated objective as
``reg / N`` (the sum counts it N times) while ``aux["loss"]`` reports it
whole. The noise is the global batch's, of which each rank keeps its rows
(``eps_*`` given are the global batch's; a generator draws them), so a
sharded step sees the single-device step's noise; the teacher's MC tail
stays on the MC-consensus kernel.

On a (``data``, ``space``) mesh of N x M ranks each rank holds its rows of
the batch and, of each image, its row shard: the step runs under the
models' row sharding (:func:`pda_torch.models.blocks.space_sharding`,
``pda``'s engine context), the pixel reductions cross the world (``pda``'s
``_with_space``), the KL's batch mean the ``data`` axis
(:mod:`pda_torch.core.losses`), the L2 term enters as ``reg / (N M)`` and
the gradients are summed over the world; the row shards of an image share
its noise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..core.consensus import distribution_alignment
from ..core.ema import ema_update, ramped_momentum
from ..core.losses import dice_loss, neg_elbo
from ..core.metrics import dice_score_torch
from ..models.blocks import space_sharding
from ..models.punet import ProbabilisticUnet, mc_decode_logits, mc_predict_probs, mc_pseudo
from .state import TrainState, punet_l2_reg

REG_WEIGHT = 1e-5  # reference punet_trainer.py:34
N_MC_TRAIN = 16  # reference mean_teacher_trainer.py:36
N_MC_VAL = 8  # reference punet_trainer.py:70


def _punet_loss(model: ProbabilisticUnet, x, segm, eps_post=None,
                generator: Optional[torch.Generator] = None, consm=None,
                reconstruct_posterior_mean: bool = False, mesh=None):
    """-ELBO + 1e-5 * l2 over the regularized subset: ``(objective, aux)``,
    ``aux["loss"]`` the loss's value. Without a mesh the objective is the
    loss; on a mesh of N ranks (N x M) it carries ``reg / N`` (``reg / (N
    M)``; module docstring).

    ``reconstruct_posterior_mean`` decodes the posterior mean instead of the
    draw for the reconstruction, while the MC-KL option still evaluates at
    the draw (the reference's ``elbo(..., reconstruct_posterior_mean=True)``).
    """
    enc = model.encode(x, segm)
    z_post = enc.posterior.sample(eps=eps_post, generator=generator, mesh=mesh)
    z_rec = enc.posterior.mu if reconstruct_posterior_mean else z_post
    recon = model.decode(enc.features, z_rec)
    nelbo, aux = neg_elbo(
        recon, segm, enc.posterior, enc.prior, beta=model.beta, rl_swap=model.rl_swap,
        consensus_mask=consm, consensus_masking=model.consensus_masking,
        analytic_kl=model.analytic_kl, z_posterior=z_post, mesh=mesh)
    reg = punet_l2_reg(model)
    loss = nelbo + REG_WEIGHT * reg
    aux = {"loss": loss, **aux}
    if mesh is None:
        return loss, aux
    return nelbo + (REG_WEIGHT / mesh.world) * reg, aux


@torch.no_grad()
def _mc_pseudo(model: ProbabilisticUnet, x, n_samples: int, masking: bool, eps=None,
               generator: Optional[torch.Generator] = None, mesh=None):
    """Teacher-style MC pseudo-label and consensus, gradient-free: the
    MC-consensus kernel on the card where :func:`mc_pseudo` takes it
    (``pda`` takes its XLA path here by default, ``steps.py``
    ``USE_PALLAS_MC``, and always on a mesh, where its kernel's draw cannot
    be sliced; both compute the same)."""
    return mc_pseudo(model, x, n_samples, eps=eps, generator=generator, masking=masking,
                     mesh=mesh)


def _sum_gradients(optimizer: torch.optim.Optimizer, mesh) -> None:
    """Sum every gradient over the mesh's ranks, in place: one all-reduce
    of a flat bucket a (device, dtype)."""
    buckets: dict = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                buckets.setdefault((p.grad.device, p.grad.dtype), []).append(p.grad)
    for grads in buckets.values():
        flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])


def _apply_updates(state: TrainState, objective: torch.Tensor, mesh=None) -> None:
    """backward(); on a mesh the gradients summed over the ranks (SUM, as
    ``pda``'s ``psum``: each rank's is its data's share of the global
    gradient); then the optimizer's step."""
    state.optimizer.zero_grad(set_to_none=True)
    objective.backward()
    if mesh is not None:
        _sum_gradients(state.optimizer, mesh)
    state.optimizer.step()
    state.step += 1


def _detached(aux: dict) -> dict:
    return {k: v.detach() for k, v in aux.items()}


def _on(mesh, step):
    """``step`` itself, or on a 2-D mesh ``step`` run under the models' row
    sharding over the mesh's space axis."""
    space = None if mesh is None else mesh.space
    if space is None:
        return step

    @functools.wraps(step)
    def sharded(*args, **kwargs):
        with space_sharding(space):
            return step(*args, **kwargs)

    return sharded


def make_supervised_punet_step(*, mesh=None):
    """Supervised PUNet training: -ELBO on (x, y), one Adam step.
    ``pda``: ``rng, k_post = split(rng)``. ``mesh``: every factory's data
    mesh (module docstring)."""

    def step(state: TrainState, x, y, *, eps_post=None,
             generator: Optional[torch.Generator] = None):
        loss, aux = _punet_loss(state.model, x, y, eps_post, generator, mesh=mesh)
        _apply_updates(state, loss, mesh)
        return state, _detached(aux)

    return _on(mesh, step)


def make_punet_val_step(n_samples: int = N_MC_VAL, *, mesh=None):
    """Train-style loss, and the dice of the MC-n mean probability (``pda``'s
    ``_mc_mean_probs``) against the target; metric = 1 - dice.
    ``pda``: ``rng, k_post, k_mc = split(rng, 3)``."""

    @torch.no_grad()
    def step(state: TrainState, x, y, *, eps_post=None, eps_mc=None,
             generator: Optional[torch.Generator] = None):
        return state, _punet_val(state.model, x, y, n_samples, eps_post, eps_mc, generator,
                                 mesh=mesh)

    return _on(mesh, step)


def _punet_val(model: ProbabilisticUnet, x, y, n_samples: int, eps_post, eps_mc, generator,
               consm=None, mesh=None) -> dict:
    """Train-style loss on (x, y[, z]) and the MC mean-probability dice
    against y; metric = 1 - dice."""
    _, aux = _punet_loss(model, x, y, eps_post, generator, consm=consm, mesh=mesh)
    pred = mc_predict_probs(model, x, n_samples, eps=eps_mc, generator=generator, mesh=mesh)
    dice = dice_score_torch(pred, y, mesh=mesh)
    return {"loss": aux["loss"], "dice": dice, "metric": 1.0 - dice}


def make_mean_teacher_step(*, momentum: float = 0.999, do_consensus_masking: bool = False,
                           n_samples: int = N_MC_TRAIN, mesh=None):
    """Mean-Teacher step: the teacher's MC-n pseudo-label y and consensus z
    on the weak view x1; the student's -ELBO on (x2, y, z) and one Adam
    step; then the teacher's EMA toward the UPDATED student. ``x`` and
    ``gt`` are unused, as in ``pda``. ``pda``: ``rng, k_t, k_post =
    split(rng, 3)``."""

    def step(state: TrainState, x, x1, x2, gt, *, eps_teacher=None, eps_post=None,
             generator: Optional[torch.Generator] = None):
        y, z = _mc_pseudo(state.teacher, x1, n_samples, do_consensus_masking,
                          eps_teacher, generator, mesh=mesh)
        loss, aux = _punet_loss(state.model, x2, y, eps_post, generator, consm=z, mesh=mesh)
        _apply_updates(state, loss, mesh)
        ema_update(state.teacher, state.model, momentum)
        return state, _detached(aux)

    return _on(mesh, step)


def make_mean_teacher_val_step(*, do_consensus_masking: bool = False,
                               n_samples: int = N_MC_TRAIN, mesh=None):
    """Teacher pseudo-label on x1, the student's loss on (x2, y, z), and the
    student's MC mean-probability dice against y (metric) and against the
    true gt (gt_metric). ``pda``: ``rng, k_t, k_post, k_mc = split(rng, 4)``."""

    @torch.no_grad()
    def step(state: TrainState, x, x1, x2, gt, *, eps_teacher=None, eps_post=None,
             eps_mc=None, generator: Optional[torch.Generator] = None):
        return state, _target_val(state, state.teacher, x1, x2, gt, n_samples,
                                  do_consensus_masking, eps_teacher, eps_post, eps_mc,
                                  generator, mesh)

    return _on(mesh, step)


def _target_val(state: TrainState, labeller, x1, x2, gt, n_samples: int, masking: bool,
                eps_pseudo, eps_post, eps_mc, generator, mesh=None):
    """The self-training validation: ``labeller``'s MC pseudo-label and
    consensus on x1, the model's loss on (x2, y, z), and its MC
    mean-probability dice against y (metric) and against gt (gt_metric)."""
    y, z = _mc_pseudo(labeller, x1, n_samples, masking, eps_pseudo, generator, mesh=mesh)
    _, aux = _punet_loss(state.model, x2, y, eps_post, generator, consm=z, mesh=mesh)
    pred = mc_predict_probs(state.model, x2, n_samples, eps=eps_mc, generator=generator,
                            mesh=mesh)
    dice, gt_dice = dice_score_torch(pred, y, mesh=mesh), dice_score_torch(pred, gt, mesh=mesh)
    return {"loss": aux["loss"], "dice": dice, "metric": 1.0 - dice,
            "gt_metric": 1.0 - gt_dice}


def make_pseudo_unet_step(*, mesh=None):
    """Pseudo-label UNet training on fixed pseudo-labels y and consensus z
    from disk: ``dice_loss(pred * z, y * z)``, one Adam step. No noise
    (``pda`` splits ``rng`` and draws nothing)."""

    def step(state: TrainState, x, y, z):
        loss = dice_loss(state.model(x) * z, y * z, mesh=mesh)
        _apply_updates(state, loss, mesh)
        return state, {"loss": loss.detach()}

    return _on(mesh, step)


def make_pseudo_unet_val_step(*, mesh=None):
    @torch.no_grad()
    def step(state: TrainState, x, y, z):
        loss = dice_loss(state.model(x) * z, y * z, mesh=mesh)
        return state, {"loss": loss, "metric": loss}

    return _on(mesh, step)


def make_pseudo_punet_step(*, mesh=None):
    """Pseudo-label PUNet training: -ELBO on the precomputed pseudo-labels y
    with the consensus z from disk as the consensus mask, one Adam step.
    ``pda``: ``rng, k_post = split(rng)``."""

    def step(state: TrainState, x, y, z, *, eps_post=None,
             generator: Optional[torch.Generator] = None):
        loss, aux = _punet_loss(state.model, x, y, eps_post, generator, consm=z, mesh=mesh)
        _apply_updates(state, loss, mesh)
        return state, _detached(aux)

    return _on(mesh, step)


def make_pseudo_punet_val_step(n_samples: int = N_MC_VAL, *, mesh=None):
    """The consensus-weighted loss and the MC-n mean-probability dice against
    y; metric = 1 - dice. ``pda``: ``rng, k_post, k_mc = split(rng, 3)``."""

    @torch.no_grad()
    def step(state: TrainState, x, y, z, *, eps_post=None, eps_mc=None,
             generator: Optional[torch.Generator] = None):
        return state, _punet_val(state.model, x, y, n_samples, eps_post, eps_mc, generator,
                                 consm=z, mesh=mesh)

    return _on(mesh, step)


def make_fixmatch_step(*, source_distribution=None, do_consensus_masking: bool = False,
                       n_samples: int = N_MC_TRAIN, mesh=None):
    """FixMatch: the model itself, gradient-free and before the update, draws
    the MC-n pseudo-label y and consensus z on the weak view x1; with a
    ``source_distribution`` ([bg, fg]) y is distribution-aligned; then the
    model's -ELBO on (x2, y, z) and one Adam step. aux gains
    ``distr_ratio_bg`` / ``distr_ratio_fg`` (0 without alignment).
    ``pda``: ``rng, k_w, k_post = split(rng, 3)``."""

    def step(state: TrainState, x, x1, x2, gt, *, eps_weak=None, eps_post=None,
             generator: Optional[torch.Generator] = None):
        y, z = _mc_pseudo(state.model, x1, n_samples, do_consensus_masking, eps_weak,
                          generator, mesh=mesh)
        if source_distribution is not None:
            y, ratio = distribution_alignment(y, source_distribution, mesh=mesh)
        else:
            ratio = y.new_zeros(2)
        loss, aux = _punet_loss(state.model, x2, y, eps_post, generator, consm=z, mesh=mesh)
        _apply_updates(state, loss, mesh)
        return state, {"distr_ratio_bg": ratio[0], "distr_ratio_fg": ratio[1],
                       **_detached(aux)}

    return _on(mesh, step)


def make_fixmatch_val_step(*, do_consensus_masking: bool = False,
                           n_samples: int = N_MC_TRAIN, mesh=None):
    """The model's own pseudo-label on x1 (no alignment at validation), its
    loss on (x2, y, z), and its MC mean-probability dice against y (metric)
    and gt (gt_metric). ``pda``: ``rng, k_w, k_post, k_mc = split(rng, 4)``."""

    @torch.no_grad()
    def step(state: TrainState, x, x1, x2, gt, *, eps_weak=None, eps_post=None,
             eps_mc=None, generator: Optional[torch.Generator] = None):
        return state, _target_val(state, state.model, x1, x2, gt, n_samples,
                                  do_consensus_masking, eps_weak, eps_post, eps_mc, generator,
                                  mesh)

    return _on(mesh, step)


def _joint_loss(model: ProbabilisticUnet, xs, ys, xt2, y, z, eps_source, eps_post, generator,
                mesh=None):
    """(source -ELBO on (xs, ys) + target -ELBO on (xt2, y, z)) / 2:
    ``(objective, aux)``, aux ``loss``, ``supervised_loss``, ``target_loss``."""
    sup, sup_aux = _punet_loss(model, xs, ys, eps_source, generator, mesh=mesh)
    tgt, tgt_aux = _punet_loss(model, xt2, y, eps_post, generator, consm=z, mesh=mesh)
    sup_loss, tgt_loss = sup_aux["loss"], tgt_aux["loss"]
    return (sup + tgt) / 2.0, {"loss": (sup_loss + tgt_loss) / 2.0,
                               "supervised_loss": sup_loss, "target_loss": tgt_loss}


def make_adamt_step(*, momentum: float = 0.999, do_consensus_masking: bool = False,
                    n_samples: int = N_MC_TRAIN, mesh=None):
    """AdaMT (joint Mean Teacher): the teacher's MC-n pseudo-label y and
    consensus z on the target's weak view xt1; (source -ELBO on (xs, ys) +
    target -ELBO on (xt2, y, z)) / 2 and one Adam step; then the teacher's
    EMA toward the updated student at ``min(1 - 1/(step + 1), momentum)``,
    ``step`` the count BEFORE this update. ``xt`` and ``yt`` are unused.
    ``pda``: ``rng, k_s, k_t, k_post = split(rng, 4)``."""

    def step(state: TrainState, xs, ys, xt, xt1, xt2, yt, *, eps_source=None,
             eps_teacher=None, eps_post=None, generator: Optional[torch.Generator] = None):
        y, z = _mc_pseudo(state.teacher, xt1, n_samples, do_consensus_masking, eps_teacher,
                          generator, mesh=mesh)
        loss, aux = _joint_loss(state.model, xs, ys, xt2, y, z, eps_source, eps_post,
                                generator, mesh)
        m = ramped_momentum(float(state.step), momentum)
        _apply_updates(state, loss, mesh)
        ema_update(state.teacher, state.model, m)
        return state, _detached(aux)

    return _on(mesh, step)


def make_adamt_val_step(*, do_consensus_masking: bool = False, n_samples: int = N_MC_TRAIN,
                        mesh=None):
    """Target-only validation: the teacher's pseudo-label on xt1, the
    model's loss on (xt2, y, z), its MC mean-probability dice against y
    (metric) and yt (gt_metric). ``pda``: ``rng, k_t, k_post, k_mc =
    split(rng, 4)``."""

    @torch.no_grad()
    def step(state: TrainState, xt, xt1, xt2, yt, *, eps_teacher=None, eps_post=None,
             eps_mc=None, generator: Optional[torch.Generator] = None):
        return state, _target_val(state, state.teacher, xt1, xt2, yt, n_samples,
                                  do_consensus_masking, eps_teacher, eps_post, eps_mc,
                                  generator, mesh)

    return _on(mesh, step)


def make_adamatch_step(*, do_consensus_masking: bool = False, n_samples: int = N_MC_TRAIN,
                       mesh=None):
    """AdaMatch (joint FixMatch): AdaMT's loss with the pseudo-label drawn by
    the model itself (gradient-free, before the update) and no EMA.
    ``pda``: ``rng, k_s, k_w, k_post = split(rng, 4)``."""

    def step(state: TrainState, xs, ys, xt, xt1, xt2, yt, *, eps_source=None,
             eps_weak=None, eps_post=None, generator: Optional[torch.Generator] = None):
        y, z = _mc_pseudo(state.model, xt1, n_samples, do_consensus_masking, eps_weak,
                          generator, mesh=mesh)
        loss, aux = _joint_loss(state.model, xs, ys, xt2, y, z, eps_source, eps_post,
                                generator, mesh)
        _apply_updates(state, loss, mesh)
        return state, _detached(aux)

    return _on(mesh, step)


def make_adamatch_val_step(*, do_consensus_masking: bool = False, n_samples: int = N_MC_TRAIN,
                           mesh=None):
    """The model's own pseudo-label on xt1, its loss on (xt2, y, z), its MC
    mean-probability dice against y and yt. ``pda``: ``rng, k_w, k_post,
    k_mc = split(rng, 4)``."""

    @torch.no_grad()
    def step(state: TrainState, xt, xt1, xt2, yt, *, eps_weak=None, eps_post=None,
             eps_mc=None, generator: Optional[torch.Generator] = None):
        return state, _target_val(state, state.model, xt1, xt2, yt, n_samples,
                                  do_consensus_masking, eps_weak, eps_post, eps_mc, generator,
                                  mesh)

    return _on(mesh, step)


def make_supervised_unet_step(*, mesh=None):
    """Supervised UNet2d training (torch_em's default segmentation trainer):
    ``dice_loss(pred, y)`` on the sigmoid output, one Adam step. No noise."""

    def step(state: TrainState, x, y):
        loss = dice_loss(state.model(x), y, mesh=mesh)
        _apply_updates(state, loss, mesh)
        return state, {"loss": loss.detach()}

    return _on(mesh, step)


def make_supervised_unet_val_step(*, mesh=None):
    @torch.no_grad()
    def step(state: TrainState, x, y):
        loss = dice_loss(state.model(x), y, mesh=mesh)
        return state, {"loss": loss, "metric": loss}

    return _on(mesh, step)


# TensorBoard image panels: the tensors each reference logger writes
# (pseudo-labels, consensus, MC samples, predictions), computed in a separate
# forward-only pass on the first batch element. Each factory returns
# ``panels(model, teacher, *batch, eps_*=None, generator=None) -> {tag:
# tensor}``; the trainer hands in a generator of its own for panels, so they
# never shift the training noise (``pda`` folds the state's key instead,
# ``steps.py`` ``_panel_keys``: ``pda``'s key k of ``_panel_keys(rng, n)`` is
# the port's k-th ``eps_*`` keyword below, each drawn ``(n_samples, 1, L)``).


def _sample_logits(model: ProbabilisticUnet, x, n_samples: int, eps, generator):
    """n raw-logit prior samples (n, B, H, W, C) (reference ``_sample``)."""
    enc = model.encode(x)
    return mc_decode_logits(model, enc.features, enc.prior, n_samples, eps=eps,
                            generator=generator)


def make_punet_panels(n_samples: int = 16):
    """PUNetLogger, and the pseudo-label PUNet's panels: input, target and 16
    raw prior samples (gridded on the host, ``make_grid(nrow=4, padding=4)``);
    a pseudo-label batch's consensus is not shown. ``pda``: one key,
    ``eps_samples``."""

    @torch.no_grad()
    def panels(model, teacher, x, y, *_, eps_samples=None,
               generator: Optional[torch.Generator] = None):
        s = _sample_logits(model, x[:1], n_samples, eps_samples, generator)
        return {"input": x[0], "target": y[0], "samples": s[:, 0]}

    return panels


make_pseudo_punet_panels = make_punet_panels


def _labelled_panels(labeller, model, x1, x2, n_samples, masking, eps_pseudo, eps_mc,
                     generator):
    """``labeller``'s MC pseudo-label and consensus on x1[:1] (the
    MC-consensus kernel on the card) and the model's MC mean on x2[:1]."""
    y, z = mc_pseudo(labeller, x1[:1], n_samples, eps=eps_pseudo, generator=generator,
                     masking=masking)
    pred = mc_predict_probs(model, x2[:1], n_samples, eps=eps_mc, generator=generator)
    return y[0], z[0], pred[0]


def make_mean_teacher_panels(*, do_consensus_masking: bool = False,
                             n_samples: int = N_MC_TRAIN):
    """MeanTeacherLogger: input, both views, the teacher's pseudo-labels and
    consensus, ground truth, the model's MC mean. ``pda``: ``k_t, k_m``
    -> ``eps_teacher``, ``eps_mc``."""

    @torch.no_grad()
    def panels(model, teacher, x, x1, x2, gt, *, eps_teacher=None, eps_mc=None,
               generator: Optional[torch.Generator] = None):
        y, z, pred = _labelled_panels(teacher, model, x1, x2, n_samples, do_consensus_masking,
                                      eps_teacher, eps_mc, generator)
        return {"input": x[0], "aug_inputs_1": x1[0], "aug_inputs_2": x2[0],
                "teacher_predictions": y, "teacher_consensus": z, "ground_truth": gt[0],
                "model_samples": pred}

    return panels


def make_fixmatch_panels(*, do_consensus_masking: bool = False, n_samples: int = N_MC_TRAIN):
    """FixMatchLogger's four components (weak view, strong view,
    pseudo-labels, prediction), gridded on the host. ``pda``: ``k_w, k_m``
    -> ``eps_weak``, ``eps_mc``."""

    @torch.no_grad()
    def panels(model, teacher, x, x1, x2, gt, *, eps_weak=None, eps_mc=None,
               generator: Optional[torch.Generator] = None):
        y, _, pred = _labelled_panels(model, model, x1, x2, n_samples, do_consensus_masking,
                                      eps_weak, eps_mc, generator)
        return {"weak_aug": x1[0], "strong_aug": x2[0], "pseudo_labels": y, "prediction": pred}

    return panels


def make_adamt_panels(*, do_consensus_masking: bool = False, n_samples: int = N_MC_TRAIN):
    """AdaMTLogger: the target's input and weak views, the teacher's
    pseudo-labels and consensus, the target ground truth, the model's MC
    mean. ``pda``: ``k_t, k_m`` -> ``eps_teacher``, ``eps_mc``."""

    @torch.no_grad()
    def panels(model, teacher, xt, xt1, xt2, yt, *, eps_teacher=None, eps_mc=None,
               generator: Optional[torch.Generator] = None):
        y, z, pred = _labelled_panels(teacher, model, xt1, xt2, n_samples, do_consensus_masking,
                                      eps_teacher, eps_mc, generator)
        return {"target_inputs": xt[0], "weak_aug1": xt1[0], "weak_aug2": xt2[0],
                "teacher_predictions": y, "teacher_consensus": z,
                "target_ground_truth": yt[0], "model_samples": pred}

    return panels


def make_adamatch_panels(*, do_consensus_masking: bool = False, n_samples: int = N_MC_TRAIN):
    """AdaMatchLogger: the target's views, the model's own pseudo-labels and
    consensus, the target ground truth, its MC mean. ``pda``: ``k_w, k_m``
    -> ``eps_weak``, ``eps_mc``."""

    @torch.no_grad()
    def panels(model, teacher, xt, xt1, xt2, yt, *, eps_weak=None, eps_mc=None,
               generator: Optional[torch.Generator] = None):
        y, z, pred = _labelled_panels(model, model, xt1, xt2, n_samples, do_consensus_masking,
                                      eps_weak, eps_mc, generator)
        return {"target_inputs": xt[0], "weak_aug": xt1[0], "strong_aug": xt2[0],
                "weak_model_predictions": y, "weak_model_consensus": z,
                "target_ground_truth": yt[0], "model_samples": pred}

    return panels


def make_supervised_unet_panels():
    """The UNet's panels (supervised, and PseudoLogger's): input, target,
    prediction; a pseudo-label batch's consensus is not shown. No noise."""

    @torch.no_grad()
    def panels(model, teacher, x, y, *_):
        return {"input": x[0], "target": y[0], "prediction": model(x[:1])[0]}

    return panels


make_pseudo_unet_panels = make_supervised_unet_panels
