"""The port's other training algorithms (pseudo PUNet, FixMatch, AdaMT,
AdaMatch) against ``pda`` on the CPU, and FixMatch's distribution alignment.

As in ``tests/test_torch_train_step.py``: both sides start from the same
weights (``pda``'s tree, bridged with ``state_dict_from_pda``), take the same
batch and the same noise, the normals ``pda``'s steps draw from the keys
they split off ``state.rng`` (e.g. AdaMT's ``rng, k_s, k_t, k_post =
split(rng, 4)``), handed to the port as ``eps_source`` / ``eps_teacher`` /
``eps_post``. Compared: loss and aux (rel 1e-5), every gradient leaf (1e-4 of
the leaf's largest), the updated student and teacher (abs 1e-6, where Adam's
sign is defined: where a reference gradient is within 1e-5 of its leaf's
largest, only |step| <= lr is asked). AdaMT runs two steps, so its ramped
EMA momentum is taken at step 0 (0: the teacher becomes the student) and at
step 1 (0.5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.core import consensus as jcons
from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch import train as ttrain
from pda_torch.core.consensus import distribution_alignment
from pda_torch.models import state_dict_from_pda
from pda_torch.train import adam, create_train_state
from pda_torch.train.steps import N_MC_TRAIN, N_MC_VAL
from torch_port_utils import LATENT, assert_close_scaled, pda_punet, port_punet, t

B, P, LR, SEED = 2, 16, 1e-5, 5
LAST_SCALE, Z_SCALE = 32.0, 0.02  # the consensus share lies inside (0, 1)
SOURCE = (0.7, 0.3)  # FixMatch's source class distribution [bg, fg]
#: case -> (algorithm, consensus masking, steps taken)
CASES = {
    "pseudo_punet": ("pseudo_punet", True, 1),
    "fixmatch_aligned": ("fixmatch", True, 1),
    "fixmatch": ("fixmatch", False, 1),
    "adamt": ("adamt", True, 2),
    "adamatch": ("adamatch", True, 1),
}
#: the noise each step takes: (port keyword, key index in pda's split, shape)
NOISE = {
    "pseudo_punet": [("eps_post", 1, (B, LATENT))],
    "fixmatch": [("eps_weak", 1, (N_MC_TRAIN, B, LATENT)), ("eps_post", 2, (B, LATENT))],
    "adamt": [("eps_source", 1, (B, LATENT)), ("eps_teacher", 2, (N_MC_TRAIN, B, LATENT)),
              ("eps_post", 3, (B, LATENT))],
    "adamatch": [("eps_source", 1, (B, LATENT)), ("eps_weak", 2, (N_MC_TRAIN, B, LATENT)),
                 ("eps_post", 3, (B, LATENT))],
}
VAL_NOISE = {
    "pseudo_punet": [("eps_post", 1, (B, LATENT)), ("eps_mc", 2, (N_MC_VAL, B, LATENT))],
    "fixmatch": [("eps_weak", 1, (N_MC_TRAIN, B, LATENT)), ("eps_post", 2, (B, LATENT)),
                 ("eps_mc", 3, (N_MC_TRAIN, B, LATENT))],
    "adamt": [("eps_teacher", 1, (N_MC_TRAIN, B, LATENT)), ("eps_post", 2, (B, LATENT)),
              ("eps_mc", 3, (N_MC_TRAIN, B, LATENT))],
    "adamatch": [("eps_weak", 1, (N_MC_TRAIN, B, LATENT)), ("eps_post", 2, (B, LATENT)),
                 ("eps_mc", 3, (N_MC_TRAIN, B, LATENT))],
}
AUX = {"pseudo_punet": {"loss", "recon_loss", "kl"},
       "fixmatch": {"loss", "recon_loss", "kl", "distr_ratio_bg", "distr_ratio_fg"},
       "adamt": {"loss", "supervised_loss", "target_loss"},
       "adamatch": {"loss", "supervised_loss", "target_loss"}}


@functools.lru_cache(maxsize=None)
def _params():
    _, params = pda_punet()
    fc = dict(params["fcomb"])
    fc["last_layer"] = {k: v * LAST_SCALE for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * Z_SCALE}
    return {**params, "fcomb": fc}


@functools.lru_cache(maxsize=None)
def _batch(algo: str):
    """The step's batch as numpy arrays: (x, y, z) for pseudo PUNet, (x, x1,
    x2, gt) for FixMatch, (xs, ys, xt, xt1, xt2, yt) for the joint ones."""
    rng = np.random.default_rng(SEED)

    def img():
        return rng.normal(size=(B, P, P, 1)).astype(np.float32)

    def view(x):
        return x + 0.1 * rng.normal(size=x.shape).astype(np.float32)

    if algo == "pseudo_punet":
        x = img()
        y = rng.uniform(size=x.shape).astype(np.float32)
        z = (rng.uniform(size=x.shape) > 0.3).astype(np.float32)
        return x, y, z
    xt = img()
    target = (xt, view(xt), view(xt), (xt > 0.5).astype(np.float32))
    if algo == "fixmatch":
        return target
    xs = img()
    return (xs, (xs > 0.3).astype(np.float32), *target)


def _draw(rng_key, spec):
    keys = jax.random.split(rng_key, max(i for _, i, _ in spec) + 1)
    return {name: jax.random.normal(keys[i], shape) for name, i, shape in spec}


def _jax_factories(algo, model, tx, masking):
    if algo == "pseudo_punet":
        return jsteps.make_pseudo_punet_step(model, tx), jsteps.make_pseudo_punet_val_step(model)
    if algo == "fixmatch":
        src = jnp.asarray(SOURCE) if masking else None
        return (jsteps.make_fixmatch_step(model, tx, source_distribution=src,
                                          do_consensus_masking=masking),
                jsteps.make_fixmatch_val_step(model, do_consensus_masking=masking))
    make, make_val = {"adamt": (jsteps.make_adamt_step, jsteps.make_adamt_val_step),
                      "adamatch": (jsteps.make_adamatch_step,
                                   jsteps.make_adamatch_val_step)}[algo]
    return make(model, tx, do_consensus_masking=masking), make_val(model,
                                                                   do_consensus_masking=masking)


def _jax_loss(algo, model, params, state, batch, noise_keys, masking):
    """pda's differentiated objective at ``params``, with the pseudo-labels
    its step draws from ``state`` (for the gradients)."""
    if algo == "pseudo_punet":
        x, y, z = batch
        return jsteps._punet_loss(model, params, x, y, noise_keys[1], consm=z)[0]
    if algo == "fixmatch":
        x, x1, x2, gt = batch
        y, z = jsteps._mc_pseudo(model, state.params, x1, noise_keys[1], N_MC_TRAIN, masking)
        if masking:
            y, _ = jcons.distribution_alignment(y, jnp.asarray(SOURCE))
        return jsteps._punet_loss(model, params, x2, y, noise_keys[2], consm=z)[0]
    xs, ys, xt, xt1, xt2, yt = batch
    labeller = state.teacher_params if algo == "adamt" else state.params
    y, z = jsteps._mc_pseudo(model, labeller, xt1, noise_keys[2], N_MC_TRAIN, masking)
    sup = jsteps._punet_loss(model, params, xs, ys, noise_keys[1])[0]
    tgt = jsteps._punet_loss(model, params, xt2, y, noise_keys[3], consm=z)[0]
    return (sup + tgt) / 2.0


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> dict:
    """pda's train steps (and val step, on the first state), its gradients
    and the noise its steps drew, step by step, as numpy trees."""
    algo, masking, n_steps = CASES[case]
    model, _ = pda_punet(consensus_masking=masking)
    tx = jadam(LR)
    state = jcreate_train_state(jax.tree_util.tree_map(jnp.asarray, _params()), tx,
                                jax.random.PRNGKey(SEED), with_teacher=algo == "adamt")
    batch = tuple(map(jnp.asarray, _batch(algo)))
    train, val = _jax_factories(algo, model, tx, masking)
    n_keys = 1 + len(NOISE[algo])

    @jax.jit
    def run(state):
        keys = jax.random.split(state.rng, n_keys)
        grads = jax.grad(lambda p: _jax_loss(algo, model, p, state, batch, keys, masking))(
            state.params)
        new, aux = train(state, *batch)
        return new, {"params": new.params, "teacher": new.teacher_params, "aux": aux,
                     "grads": grads, "noise": _draw(state.rng, NOISE[algo])}

    val_batch = batch if algo == "pseudo_punet" else batch[-4:]
    _, vaux = jax.jit(val)(state, *val_batch)
    out = {"val": vaux, "val_noise": _draw(state.rng, VAL_NOISE[algo]), "steps": []}
    for _ in range(n_steps):
        state, rec = run(state)
        out["steps"].append(rec)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_factories(algo, masking):
    if algo == "pseudo_punet":
        return ttrain.make_pseudo_punet_step(), ttrain.make_pseudo_punet_val_step()
    if algo == "fixmatch":
        return (ttrain.make_fixmatch_step(source_distribution=SOURCE if masking else None,
                                          do_consensus_masking=masking),
                ttrain.make_fixmatch_val_step(do_consensus_masking=masking))
    make, make_val = {"adamt": (ttrain.make_adamt_step, ttrain.make_adamt_val_step),
                      "adamatch": (ttrain.make_adamatch_step,
                                   ttrain.make_adamatch_val_step)}[algo]
    return make(do_consensus_masking=masking), make_val(do_consensus_masking=masking)


@functools.lru_cache(maxsize=None)
def _port(case: str) -> dict:
    """The port's val step, then its train steps, on the same state."""
    algo, masking, n_steps = CASES[case]
    ref = _reference(case)
    model = port_punet(_params(), consensus_masking=masking)
    state = create_train_state(model, adam(model.parameters(), LR),
                               with_teacher=algo == "adamt")
    batch = tuple(map(t, _batch(algo)))
    train, val = _port_factories(algo, masking)
    val_batch = batch if algo == "pseudo_punet" else batch[-4:]
    _, vaux = val(state, *val_batch, **{k: t(v) for k, v in ref["val_noise"].items()})
    out = {"val": vaux, "steps": []}
    for rec in ref["steps"]:
        _, aux = train(state, *batch, **{k: t(v) for k, v in rec["noise"].items()})
        out["steps"].append({
            "aux": aux, "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "teacher": (None if state.teacher is None else
                        {k: v.detach().clone() for k, v in state.teacher.state_dict().items()}),
        })
    out["step"] = state.step
    return out


def _bridged(tree) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_pda(tree).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_algorithm_loss_and_aux_match_pda(case):
    algo, _, n_steps = CASES[case]
    ref, port = _reference(case), _port(case)
    for r, p in zip(ref["steps"], port["steps"]):
        assert set(p["aux"]) == set(r["aux"]) == AUX[algo]
        for name, v in r["aux"].items():
            assert_close_scaled(p["aux"][name].numpy(), v, rel=1e-5)
    assert port["step"] == n_steps


@pytest.mark.parametrize("case", list(CASES))
def test_algorithm_val_step_matches_pda(case):
    ref, port = _reference(case), _port(case)
    assert set(port["val"]) == set(ref["val"])
    for name, v in ref["val"].items():
        assert_close_scaled(port["val"][name].numpy(), v, rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_algorithm_gradients_match_pda(case):
    ref, port = _reference(case), _port(case)
    for r, p in zip(ref["steps"], port["steps"]):
        want = _bridged(r["grads"])
        assert set(p["grads"]) == set(want)
        for name, g in want.items():
            err = float(np.abs(p["grads"][name].numpy() - g).max())
            assert err <= 1e-4 * float(np.abs(g).max()), (name, err, float(np.abs(g).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_algorithm_updated_student_and_teacher_match_pda(case):
    ref, port = _reference(case), _port(case)
    old = _bridged(_params())
    noisy = {}  # where a step's reference gradient leaves Adam's sign to noise
    for k, (r, p) in enumerate(zip(ref["steps"], port["steps"])):
        for name, g in _bridged(r["grads"]).items():
            g = np.abs(g)
            noisy[name] = noisy.get(name, False) | (g <= 1e-5 * g.max())
        bound = (k + 1) * LR * (1 + 1e-6)
        trees = [(_bridged(r["params"]), p["params"])]
        if p["teacher"] is not None:
            trees.append((_bridged(r["teacher"]), p["teacher"]))
        for want, got in trees:
            for name, w in want.items():
                out = got[name].numpy()
                assert np.abs(out - w)[~noisy[name]].max(initial=0.0) <= 1e-6, (k, name)
                assert np.abs(out - old[name])[noisy[name]].max(initial=0.0) <= bound, (k, name)
    last = _bridged(ref["steps"][-1]["params"])
    assert all(np.abs(last[n] - old[n]).max() > 0 for n in last)  # every leaf moved


def test_adamt_ramped_momentum_moves_the_teacher():
    """At step 0 the ramp is 0, so the teacher becomes the updated student;
    at step 1 it is 0.5."""
    port = _port("adamt")
    s0, s1 = port["steps"]
    for name, v in s0["teacher"].items():
        assert torch.equal(v, s0["params"][name]), name
    for name, v in s1["teacher"].items():
        assert torch.allclose(v, 0.5 * (s0["params"][name] + s1["params"][name]),
                              rtol=0, atol=1e-6), name


@pytest.mark.parametrize("masking", [False, True])
@pytest.mark.parametrize("source", [(0.7, 0.3), (0.2, 0.8)])
def test_distribution_alignment_matches_pda(source, masking):
    rng = np.random.default_rng(7)
    pseudo = rng.uniform(size=(2, 9, 7, 1)).astype(np.float32)
    if masking:  # a unanimity-masked batch: many pseudo-labels at 0 or 1
        pseudo = np.where(rng.uniform(size=pseudo.shape) > 0.5, np.round(pseudo), pseudo)
    want, want_ratio = jcons.distribution_alignment(jnp.asarray(pseudo), jnp.asarray(source))
    got, ratio = distribution_alignment(t(pseudo), source)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ratio.numpy(), want_ratio, rtol=1e-6)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
