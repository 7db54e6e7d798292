"""The port's losses, ELBO, EMA, regularizers and dice against ``pda``'s,
values and (for the losses) gradients, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pda.core import distributions as jdist
from pda.core import ema as jema
from pda.core import losses as jlosses
from pda.core import metrics as jmetrics
from pda.core import regularization as jreg
from pda.train.state import punet_l2_reg as jpunet_l2_reg
from pda_torch.core import distributions as tdist
from pda_torch.core import ema as tema
from pda_torch.core import losses as tlosses
from pda_torch.core import metrics as tmetrics
from pda_torch.core import regularization as treg
from pda_torch.train import punet_l2_reg
from torch_port_utils import assert_close_scaled, pda_punet, port_punet, t


def _logits_targets(seed=0, shape=(2, 5, 6, 2)):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    targets = (rng.random(size=shape) > 0.6).astype(np.float32)
    return logits, targets


def _grad_pair(jfn, tfn, *arrays):
    """(value, grads) of a scalar loss in pda and in the port."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [t(a).requires_grad_() for a in arrays]
    tval = tfn(*ts)
    tgrads = torch.autograd.grad(tval, ts, allow_unused=True, materialize_grads=True)
    return (tval.detach().numpy(), [g.numpy() for g in tgrads]), (jval, jgrads)


@pytest.mark.parametrize("name", ["bce_with_logits", "dice_loss_with_logits", "dice_loss"])
def test_recon_losses_match_pda(name):
    logits, targets = _logits_targets()
    if name == "dice_loss":
        logits = 1.0 / (1.0 + np.exp(-logits))  # dice_loss takes probabilities

    def reduce(mod):
        fn = getattr(mod, name)
        return (lambda a, b: fn(a, b).sum()) if name == "bce_with_logits" else fn

    port, ref = _grad_pair(reduce(jlosses), reduce(tlosses), logits, targets)
    assert_close_scaled(port[0], ref[0], rel=1e-6)
    for a, b in zip(port[1], ref[1]):
        assert_close_scaled(a, b, rel=1e-6)
    elementwise = getattr(tlosses, name)(t(logits), t(targets)).numpy()
    assert_close_scaled(elementwise, getattr(jlosses, name)(logits, targets), rel=1e-6)


def test_dice_loss_clips_an_empty_denominator():
    """All-zero predictions and targets: the eps clip makes each channel's
    score 0, so the loss is the channel count (pda's :117)."""
    zeros = np.zeros((1, 3, 3, 2), np.float32)
    assert float(tlosses.dice_loss(t(zeros), t(zeros))) == float(jlosses.dice_loss(zeros, zeros))
    assert float(tlosses.dice_loss(t(zeros), t(zeros))) == 2.0


@pytest.mark.parametrize("analytic_kl", [True, False])
@pytest.mark.parametrize("masking", [False, True])
@pytest.mark.parametrize("rl_swap", [True, False])
def test_neg_elbo_matches_pda(analytic_kl, masking, rl_swap):
    rng = np.random.default_rng(int(analytic_kl) + 2 * int(masking) + 4 * int(rl_swap))
    logits, segm = _logits_targets(seed=5, shape=(2, 6, 5, 1))
    mask = (rng.random(size=segm.shape) > 0.4).astype(np.float32)
    stats = [(rng.normal(size=(2, 6)) * s).astype(np.float32) for s in (1.0, 0.3, 1.0, 0.3)]
    z = rng.normal(size=(2, 6)).astype(np.float32)

    def make(mod, dist):
        def fn(logits, qm, qs, pm, ps, z):
            out, aux = mod.neg_elbo(
                logits, t(segm) if mod is tlosses else segm, dist.DiagGaussian(qm, qs),
                dist.DiagGaussian(pm, ps), beta=0.7, rl_swap=rl_swap,
                consensus_mask=t(mask) if mod is tlosses else mask,
                consensus_masking=masking, analytic_kl=analytic_kl, z_posterior=z)
            fn.aux = aux
            return out
        return fn

    jfn, tfn = make(jlosses, jdist), make(tlosses, tdist)
    port, ref = _grad_pair(jfn, tfn, logits, *stats, z)
    assert_close_scaled(port[0], ref[0], rel=1e-5)
    for a, b in zip(port[1], ref[1]):
        assert_close_scaled(a, b, rel=1e-5)
    jaux = jlosses.neg_elbo(logits, segm, jdist.DiagGaussian(*stats[:2]),
                            jdist.DiagGaussian(*stats[2:]), beta=0.7, rl_swap=rl_swap,
                            consensus_mask=mask, consensus_masking=masking,
                            analytic_kl=analytic_kl, z_posterior=z)[1]
    for k in ("recon_loss", "kl"):
        assert_close_scaled(tfn.aux[k].detach().numpy(), jaux[k], rel=1e-5)
    if masking:  # a masked pixel's logit is 0, so its sigmoid 0.5 still counts
        unmasked = tlosses.neg_elbo(t(logits), t(segm), tdist.DiagGaussian(*map(t, stats[:2])),
                                    tdist.DiagGaussian(*map(t, stats[2:])), rl_swap=rl_swap,
                                    z_posterior=t(z), analytic_kl=analytic_kl)[0]
        assert abs(float(unmasked) - float(port[0])) > 1e-3


def test_mc_kl_divergence_matches_pda():
    rng = np.random.default_rng(2)
    stats = [(rng.normal(size=(3, 6)) * s).astype(np.float32) for s in (1.0, 0.3, 1.0, 0.3)]
    z = rng.normal(size=(3, 6)).astype(np.float32)
    ref = jdist.mc_kl_divergence(jdist.DiagGaussian(*stats[:2]), jdist.DiagGaussian(*stats[2:]), z)
    out = tdist.mc_kl_divergence(tdist.DiagGaussian(*map(t, stats[:2])),
                                 tdist.DiagGaussian(*map(t, stats[2:])), t(z))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_ema_update_matches_pda():
    rng = np.random.default_rng(4)
    teacher, student = nn.Linear(5, 3), nn.Linear(5, 3)
    with torch.no_grad():
        for m in (teacher, student):
            for p in m.parameters():
                p.copy_(t(rng.normal(size=tuple(p.shape))))
    ref = jema.ema_update([p.detach().numpy() for p in teacher.parameters()],
                          [p.detach().numpy() for p in student.parameters()], 0.999)
    tema.ema_update(teacher, student, 0.999)
    for p, r in zip(teacher.parameters(), ref):
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=0, atol=1e-7)
    with pytest.raises(ValueError):
        tema.ema_update(teacher, nn.Linear(5, 3, bias=False), 0.9)


@pytest.mark.parametrize("step", [0, 1, 5, 999, 12345])
def test_ramped_momentum_matches_pda(step):
    ref = float(jema.ramped_momentum(jnp.float32(step), 0.999))
    assert tema.ramped_momentum(step, 0.999) == pytest.approx(ref, rel=1e-6, abs=1e-7)


def test_l2_regularisation_matches_pda():
    rng = np.random.default_rng(6)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 3, 2, 4), (4,), (7, 5))]
    ref = jreg.l2_regularisation(leaves)
    assert float(treg.l2_regularisation(map(t, leaves))) == pytest.approx(float(ref), rel=1e-6)


def test_punet_l2_reg_matches_pda_leafwise():
    """pda regularizes the Fcomb's first layer as two leaves (feat_proj,
    z_proj); the port holds it as one kernel and must split the norm the
    same way: one norm of the whole kernel is a different loss."""
    _, params = pda_punet()
    model = port_punet(params)
    ref = float(jpunet_l2_reg(params))
    loss = punet_l2_reg(model)
    assert float(loss.detach()) == pytest.approx(ref, rel=1e-6)
    with torch.no_grad():
        first = model.fcomb.convs()[0].weight
        whole = (float(loss) - float(torch.linalg.vector_norm(first[:, :4]))
                 - float(torch.linalg.vector_norm(first[:, 4:]))
                 + float(torch.linalg.vector_norm(first)))
    assert abs(whole - ref) > 1e-3 * ref
    loss.backward()
    assert model.unet.contracting_path[0].layers[0].weight.grad is None  # not regularized
    assert model.fcomb.last_layer.weight.grad is None


@pytest.mark.parametrize("thresholds", [(None, None), (0.5, None), (0.3, 0.5)])
def test_dice_scores_match_pda(thresholds):
    rng = np.random.default_rng(8)
    seg = rng.random(size=(2, 9, 7, 1)).astype(np.float32)
    gt = (rng.random(size=(2, 9, 7, 1)) > 0.5).astype(np.float32)
    ref = jmetrics.dice_score(seg, gt, *thresholds)
    assert tmetrics.dice_score(seg, gt, *thresholds) == ref
    ref_t = float(jmetrics.dice_score_jnp(jnp.asarray(seg), jnp.asarray(gt), *thresholds))
    assert float(tmetrics.dice_score_torch(t(seg), t(gt), *thresholds)) == pytest.approx(
        ref_t, rel=1e-6)
    with pytest.raises(ValueError):
        tmetrics.dice_score(seg, gt[:1])
