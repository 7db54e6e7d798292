"""The PUNet's other configurations against ``pda`` on the CPU: a 2-class
PUNet, 2 convs a block, and the MC tail's path (the MC-consensus kernel for
one class at a Fcomb width up to 64, zero-padded to a multiple of 8 on the
card; the plain tail otherwise).

Same weights (``pda``'s seeded tree through ``state_dict_from_pda``), same
batch, and the noise ``pda``'s steps draw from ``state.rng``'s split.
Tolerances as in ``tests/test_torch_train_step.py``: loss and aux rel 1e-5,
gradients 1e-4 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.models.convert import convert_punet_state_dict
from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch import train as ttrain
from pda_torch.models import punet as tpunet
from pda_torch.models import state_dict_from_pda
from pda_torch.train import adam, create_train_state
from pda_torch.train.steps import N_MC_TRAIN, N_MC_VAL
from torch_port_utils import (FILTERS, LATENT, assert_close_scaled, pda_punet, port_punet,
                              t)

B, P, LR, SEED = 2, 16, 1e-5, 5


def _bridged(tree) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_pda(tree).items()}


#: variant -> ProbabilisticUnet options
VARIANTS = {"two_classes": {"num_classes": 2}, "two_convs_per_block": {"no_convs_per_block": 2}}


def _variant(name: str):
    """(pda module, params, a fresh port model carrying them)."""
    kw = VARIANTS[name]
    model, params = pda_punet(**kw)
    return model, params, port_punet(params, **kw)


def _segm(n_classes, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P, P, 1)).astype(np.float32)
    y = (rng.uniform(size=(B, P, P, n_classes)) > 0.5).astype(np.float32)
    return x, y


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_punet_variant_supervised_and_val_steps_match_pda(variant):
    """A 2-class PUNet and a PUNet of 2 convs a block: the supervised step
    (loss, aux, gradients) and the validation step (its MC mean probability
    over both classes) against pda."""
    model, params, port = _variant(variant)
    x, y = _segm(model.num_classes)
    tx = jadam(LR)
    state = jcreate_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.random.PRNGKey(SEED))
    _, k_post = jax.random.split(state.rng)
    _, kv_post, kv_mc = jax.random.split(state.rng, 3)
    grads = jax.grad(lambda p: jsteps._punet_loss(model, p, jnp.asarray(x), jnp.asarray(y),
                                                  k_post)[0])(state.params)
    _, aux = jax.jit(jsteps.make_supervised_punet_step(model, tx))(state, x, y)
    _, vaux = jax.jit(jsteps.make_punet_val_step(model))(state, x, y)

    tstate = create_train_state(port, adam(port.parameters(), LR))
    _, vout = ttrain.make_punet_val_step()(
        tstate, t(x), t(y), eps_post=t(jax.random.normal(kv_post, (B, LATENT))),
        eps_mc=t(jax.random.normal(kv_mc, (N_MC_VAL, B, LATENT))))
    _, out = ttrain.make_supervised_punet_step()(
        tstate, t(x), t(y), eps_post=t(jax.random.normal(k_post, (B, LATENT))))
    for ref, got in ((aux, out), (vaux, vout)):
        assert set(ref) == set(got)
        for k, v in ref.items():
            assert_close_scaled(got[k].numpy(), np.asarray(v), rel=1e-5)
    want = _bridged(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in port.named_parameters():
        err = float(np.abs(p.grad.numpy() - want[name]).max())
        assert err <= 1e-4 * float(np.abs(want[name]).max()), (name, err)


@pytest.mark.parametrize("masking", [False, True])
def test_two_class_mc_pseudo_takes_the_plain_tail_and_matches_pda(masking, monkeypatch):
    """A 2-class PUNet's pseudo-labels and consensus (B, H, W, 2), and its
    validation predictor, against pda's ``_mc_pseudo`` / ``_mc_mean_probs``.
    The model's configuration sends it through the plain tail: the
    MC-consensus kernel's wrapper, which takes one class only, is never
    called (on the card it would raise)."""
    model, params, port = _variant("two_classes")
    x, _ = _segm(2, seed=11)
    key = jax.random.PRNGKey(13)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    y_ref, z_ref = jsteps._mc_pseudo(model, jparams, jnp.asarray(x), key, N_MC_TRAIN, masking)
    mean_ref = jsteps._mc_mean_probs(model, jparams, jnp.asarray(x), key, N_MC_TRAIN)
    eps = t(jax.random.normal(key, (N_MC_TRAIN, B, LATENT)))

    def refuse(*a, **k):
        raise AssertionError("the 2-class tail reached the one-class MC kernel")

    monkeypatch.setattr(tpunet, "mc_consensus", refuse)
    assert not tpunet.uses_mc_kernel(port)
    with torch.no_grad():
        y, z = tpunet.mc_pseudo(port, t(x), N_MC_TRAIN, eps=eps, masking=masking)
        mean = tpunet.mc_predict_probs(port, t(x), N_MC_TRAIN, eps=eps)
    assert y.shape == z.shape == mean.shape == (B, P, P, 2)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), mean_ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(z.numpy(), z_ref)


@pytest.mark.parametrize("num_filters0,num_classes,kernel", [
    (16, 1, True), (20, 1, True), (64, 1, True), (72, 1, False), (16, 2, False)])
def test_mc_path_is_chosen_by_the_configuration(num_filters0, num_classes, kernel):
    """One class and a Fcomb width up to 64 take the MC-consensus kernel; more
    classes or a wider Fcomb the plain tail."""
    from pda_torch.models import ProbabilisticUnet

    model = ProbabilisticUnet(num_filters=(num_filters0, 8), num_classes=num_classes,
                              no_convs_fcomb=3)
    assert tpunet.uses_mc_kernel(model) is kernel


@pytest.mark.parametrize("c", [12, 20, 33])
def test_mc_kernel_zero_padding_keeps_the_tail(c):
    """The wrapper's zero channels (C up to the next multiple of 8) leave the
    tail's mean and consensus unchanged: the plain version on the padded
    inputs equals it on the original ones."""
    from pda_torch.kernels import mc_consensus as kmc
    from pda_torch.tools.workload import mc_inputs

    feat, z, mid_w, mid_b, last_w, last_b = mc_inputs(torch.Generator().manual_seed(c),
                                                      2, 5, 7, c, s=6, n_mid=2)
    cp = kmc.padded_width(c)
    assert cp % 8 == 0 and c <= cp < c + 8 and cp in kmc.KERNEL_WIDTHS
    padded = kmc._pad_width(cp, feat, z, mid_w, mid_b, last_w)
    assert padded[0].shape == (2, 5, 7, cp) and padded[2].shape == (2, cp, cp)
    for masking in (False, True):
        want = kmc.mc_consensus_plain(feat, z, mid_w, mid_b, last_w, last_b, masking)
        got = kmc.mc_consensus_plain(*padded, last_b, masking)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        assert torch.equal(got[1], want[1])


def test_round_trip_at_two_convs_per_block():
    """pda params of a 2-convs-a-block PUNet -> the port (state_dict_from_pda)
    -> pda (pda's own convert_punet_state_dict), leaf for leaf."""
    _, params, port = _variant("two_convs_per_block")
    back = convert_punet_state_dict(port.state_dict(), num_filters=FILTERS, no_convs_fcomb=3,
                                    no_convs_per_block=2)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(k): np.asarray(v)
           for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
