"""The port's supervised PUNet step and Mean-Teacher step (with their
validation steps) against ``pda``'s jitted steps on the CPU.

Both sides start from the same weights (``pda``'s tree, bridged with
``state_dict_from_pda``), take the same batch and the same noise: the
normals ``pda``'s steps draw from the keys they split off ``state.rng``
(``rng, k_t, k_post = jax.random.split(state.rng, 3)``, then
``jax.random.normal(k_t, (16, B, 6))`` and ``jax.random.normal(k_post,
(B, 6))``), handed to the port as ``eps_teacher`` / ``eps_post``. Compared:
loss and aux (rel 1e-5), every parameter gradient leaf by leaf (1e-4 of the
leaf's largest), the updated student and the updated teacher (abs 1e-6).
Adam's first step moves a parameter by about lr * sign(g), so where the
reference gradient is within 1e-5 of its leaf's largest the sign is noise:
there the test asks only |step| <= lr.

The Fcomb's last layer is scaled up and its latent projection down so that,
with masking on, the teacher's consensus share lies strictly between 0 and 1
(asserted), so the masked pixels and the kept ones both enter the loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch.models import state_dict_from_pda
from pda_torch.train import (adam, create_train_state, make_mean_teacher_step,
                             make_mean_teacher_val_step, make_punet_val_step,
                             make_supervised_punet_step)
from pda_torch.train.steps import N_MC_TRAIN, N_MC_VAL, _mc_pseudo
from torch_port_utils import LATENT, assert_close_scaled, pda_punet, port_punet, t

B, P, LR, SEED = 2, 16, 1e-5, 3
#: Fcomb scales that put the consensus share inside (0, 1): a sharper last
#: layer and a weaker latent projection, so samples agree on many pixels
LAST_SCALE, Z_SCALE = 32.0, 0.02
#: case -> consensus masking of the MT step (None: the supervised step)
CASES = {"supervised": None, "mt_masking_on": True, "mt_masking_off": False}
MT_CASES = ["mt_masking_on", "mt_masking_off"]


@functools.lru_cache(maxsize=None)
def _params():
    _, params = pda_punet()
    fc = dict(params["fcomb"])
    fc["last_layer"] = {k: v * LAST_SCALE for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * Z_SCALE}
    return {**params, "fcomb": fc}


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(B, P, P, 1)).astype(np.float32)
    x1 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    x2 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    gt = (x > 0.5).astype(np.float32)
    return x, x1, x2, gt


def _normal(key, shape):
    return jax.random.normal(key, shape)


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> dict:
    """pda's train and val steps on one state, its gradients, and the noise
    its steps drew, as numpy trees."""
    masking = CASES[case]
    model, _ = pda_punet(consensus_masking=bool(masking))
    tx = jadam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    state = jcreate_train_state(params, tx, jax.random.PRNGKey(SEED),
                                with_teacher=masking is not None)
    x, x1, x2, gt = map(jnp.asarray, _batch())

    if masking is None:
        train = jsteps.make_supervised_punet_step(model, tx)
        val = jsteps.make_punet_val_step(model)

        def run(state):
            new, aux = train(state, x, gt)
            _, k_post = jax.random.split(state.rng)
            grads = jax.grad(lambda p: jsteps._punet_loss(model, p, x, gt, k_post)[0])(
                state.params)
            _, vaux = val(state, x, gt)
            _, kv_post, kv_mc = jax.random.split(state.rng, 3)
            noise = {"eps_post": _normal(k_post, (B, LATENT)),
                     "val_eps_post": _normal(kv_post, (B, LATENT)),
                     "val_eps_mc": _normal(kv_mc, (N_MC_VAL, B, LATENT))}
            return {"params": new.params, "aux": aux, "grads": grads, "val": vaux,
                    "noise": noise}
    else:
        train = jsteps.make_mean_teacher_step(model, tx, do_consensus_masking=masking)
        val = jsteps.make_mean_teacher_val_step(model, do_consensus_masking=masking)

        def run(state):
            new, aux = train(state, x, x1, x2, gt)
            _, k_t, k_post = jax.random.split(state.rng, 3)
            y, z = jsteps._mc_pseudo(model, state.teacher_params, x1, k_t, N_MC_TRAIN, masking)
            grads = jax.grad(
                lambda p: jsteps._punet_loss(model, p, x2, y, k_post, consm=z)[0])(state.params)
            _, vaux = val(state, x, x1, x2, gt)
            _, kv_t, kv_post, kv_mc = jax.random.split(state.rng, 4)
            noise = {"eps_teacher": _normal(k_t, (N_MC_TRAIN, B, LATENT)),
                     "eps_post": _normal(k_post, (B, LATENT)),
                     "val_eps_teacher": _normal(kv_t, (N_MC_TRAIN, B, LATENT)),
                     "val_eps_post": _normal(kv_post, (B, LATENT)),
                     "val_eps_mc": _normal(kv_mc, (N_MC_TRAIN, B, LATENT))}
            return {"params": new.params, "teacher": new.teacher_params, "aux": aux,
                    "grads": grads, "val": vaux, "noise": noise, "consensus": z}

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(state))


@functools.lru_cache(maxsize=None)
def _port(case: str) -> dict:
    """The port's val step, then its train step, on the same state."""
    masking = CASES[case]
    ref = _reference(case)
    noise = {k: t(v) for k, v in ref["noise"].items()}
    model = port_punet(_params(), consensus_masking=bool(masking))
    state = create_train_state(model, adam(model.parameters(), LR),
                               with_teacher=masking is not None)
    x, x1, x2, gt = map(t, _batch())
    out = {}
    if masking is None:
        _, out["val"] = make_punet_val_step()(state, x, gt, eps_post=noise["val_eps_post"],
                                              eps_mc=noise["val_eps_mc"])
        _, out["aux"] = make_supervised_punet_step()(state, x, gt, eps_post=noise["eps_post"])
    else:
        out["consensus"] = _mc_pseudo(state.teacher, x1, N_MC_TRAIN, masking,
                                      noise["eps_teacher"])[1]
        _, out["val"] = make_mean_teacher_val_step(do_consensus_masking=masking)(
            state, x, x1, x2, gt, eps_teacher=noise["val_eps_teacher"],
            eps_post=noise["val_eps_post"], eps_mc=noise["val_eps_mc"])
        _, out["aux"] = make_mean_teacher_step(do_consensus_masking=masking)(
            state, x, x1, x2, gt, eps_teacher=noise["eps_teacher"], eps_post=noise["eps_post"])
        out["teacher"] = {k: v.detach().clone() for k, v in state.teacher.state_dict().items()}
    out["params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    out["step"] = state.step
    return out


def _bridged(tree) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_pda(tree).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_step_loss_and_aux_match_pda(case):
    ref, port = _reference(case), _port(case)
    assert set(port["aux"]) == set(ref["aux"]) == {"loss", "recon_loss", "kl"}
    for name, v in ref["aux"].items():
        assert_close_scaled(port["aux"][name].numpy(), v, rel=1e-5)
    assert set(port["val"]) == set(ref["val"])
    for name, v in ref["val"].items():
        assert_close_scaled(port["val"][name].numpy(), v, rel=1e-5)
    assert port["step"] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_step_gradients_match_pda(case):
    ref, port = _bridged(_reference(case)["grads"]), _port(case)["grads"]
    assert set(port) == set(ref)
    for name, g in ref.items():
        err = float(np.abs(port[name].numpy() - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()), (name, err, float(np.abs(g).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_step_updated_student_matches_pda(case):
    ref = _reference(case)
    new, grads = _bridged(ref["params"]), _bridged(ref["grads"])
    old = _bridged(_params())
    port = _port(case)["params"]
    for name, p in new.items():
        out = port[name].numpy()
        g = np.abs(grads[name])
        sign_noise = g <= 1e-5 * g.max()
        assert np.abs(out - p)[~sign_noise].max(initial=0.0) <= 1e-6, name
        assert np.abs(out - old[name])[sign_noise].max(initial=0.0) <= LR * (1 + 1e-6), name
        assert np.abs(out - old[name]).max() > 0, name  # every leaf moved


@pytest.mark.parametrize("case", MT_CASES)
def test_mt_step_updated_teacher_matches_pda(case):
    ref = _bridged(_reference(case)["teacher"])
    port = _port(case)["teacher"]
    old = _bridged(_params())
    for name, p in ref.items():
        np.testing.assert_allclose(port[name].numpy(), p, rtol=0, atol=1e-6, err_msg=name)
    # the EMA moved the teacher (a leaf of large values may stay put in float32)
    assert sum(not np.array_equal(p, old[name]) for name, p in ref.items()) > len(ref) // 2


@pytest.mark.parametrize("case", MT_CASES)
def test_mt_teacher_consensus_matches_pda(case):
    ref, port = _reference(case)["consensus"], _port(case)["consensus"].numpy()
    np.testing.assert_array_equal(port, ref)
    if CASES[case]:
        assert 0.0 < float(ref.mean()) < 1.0, float(ref.mean())
