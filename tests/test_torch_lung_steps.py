"""The Lung suite's BCE reconstruction (``rl_swap=False``, an unreduced sum
over the pixels) through the port's train steps against ``pda``'s jitted
steps on the CPU: the supervised PUNet step (``lung_punet``), the
Mean-Teacher step with consensus weighting and with consensus masking
(``lung_mt``), the AdaMT step over two steps (``lung_adamt``).

As in ``tests/test_torch_algorithms.py``: a PUNet at num_filters
(4, 8, 12, 16) with the same weights on both sides (``pda``'s tree bridged
by ``state_dict_from_pda``; the Fcomb's last layer x32 and its latent
projection x0.02, so that the teacher's consensus share lies inside
(0, 1)), the same batch, and the normals ``pda``'s steps draw from the keys
they split off ``state.rng``. Tolerances: loss and aux within 1e-5 of
max(1, |ref|) (the BCE sum is in the thousands), every gradient leaf within
1e-4 of its largest, the updated student and teacher within 1e-6 where
Adam's sign is defined (where a reference gradient lies within 1e-5 of its
leaf's largest, only |step| <= lr per step is asked).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch import train as ttrain
from pda_torch.models import state_dict_from_pda
from pda_torch.train import adam, create_train_state
from pda_torch.train.steps import N_MC_TRAIN
from torch_port_utils import LATENT, assert_close_scaled, pda_punet, port_punet, t

B, P, LR, SEED = 2, 16, 1e-5, 11
LAST_SCALE, Z_SCALE = 32.0, 0.02
#: case -> (algorithm, consensus masking, steps taken)
CASES = {
    "supervised": ("supervised", False, 1),
    "mt_weighting": ("mt", False, 1),
    "mt_masking": ("mt", True, 1),
    "adamt_masking": ("adamt", True, 2),
}
#: the noise each step takes: (port keyword, key index in pda's split, shape)
NOISE = {
    "supervised": [("eps_post", 1, (B, LATENT))],
    "mt": [("eps_teacher", 1, (N_MC_TRAIN, B, LATENT)), ("eps_post", 2, (B, LATENT))],
    "adamt": [("eps_source", 1, (B, LATENT)), ("eps_teacher", 2, (N_MC_TRAIN, B, LATENT)),
              ("eps_post", 3, (B, LATENT))],
}
AUX = {"supervised": {"loss", "recon_loss", "kl"}, "mt": {"loss", "recon_loss", "kl"},
       "adamt": {"loss", "supervised_loss", "target_loss"}}


@functools.lru_cache(maxsize=None)
def _params():
    _, params = pda_punet(rl_swap=False)
    fc = dict(params["fcomb"])
    fc["last_layer"] = {k: v * LAST_SCALE for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * Z_SCALE}
    return {**params, "fcomb": fc}


@functools.lru_cache(maxsize=None)
def _batch(algo: str):
    """(x, y) supervised, (x, x1, x2, gt) Mean Teacher, (xs, ys, xt, xt1,
    xt2, yt) AdaMT, as numpy arrays; lung-like binary labels."""
    rng = np.random.default_rng(SEED)

    def img():
        return rng.normal(size=(B, P, P, 1)).astype(np.float32)

    def view(x):
        return x + 0.1 * rng.normal(size=x.shape).astype(np.float32)

    xt = img()
    if algo == "supervised":
        return xt, (xt > 0.3).astype(np.float32)
    target = (xt, view(xt), view(xt), (xt > 0.5).astype(np.float32))
    if algo == "mt":
        return target
    xs = img()
    return (xs, (xs > 0.3).astype(np.float32), *target)


def _draw(rng_key, spec):
    keys = jax.random.split(rng_key, max(i for _, i, _ in spec) + 1)
    return {name: jax.random.normal(keys[i], shape) for name, i, shape in spec}


def _jax_loss(algo, model, params, state, batch, keys, masking):
    """pda's differentiated objective at ``params`` (for the gradients)."""
    if algo == "supervised":
        return jsteps._punet_loss(model, params, *batch, keys[1])[0]
    if algo == "mt":
        x, x1, x2, gt = batch
        y, z = jsteps._mc_pseudo(model, state.teacher_params, x1, keys[1], N_MC_TRAIN, masking)
        return jsteps._punet_loss(model, params, x2, y, keys[2], consm=z)[0]
    xs, ys, xt, xt1, xt2, yt = batch
    y, z = jsteps._mc_pseudo(model, state.teacher_params, xt1, keys[2], N_MC_TRAIN, masking)
    sup = jsteps._punet_loss(model, params, xs, ys, keys[1])[0]
    tgt = jsteps._punet_loss(model, params, xt2, y, keys[3], consm=z)[0]
    return (sup + tgt) / 2.0


@functools.lru_cache(maxsize=None)
def _reference(case: str) -> dict:
    algo, masking, n_steps = CASES[case]
    model, _ = pda_punet(consensus_masking=masking, rl_swap=False)
    tx = jadam(LR)
    state = jcreate_train_state(jax.tree_util.tree_map(jnp.asarray, _params()), tx,
                                jax.random.PRNGKey(SEED), with_teacher=algo != "supervised")
    batch = tuple(map(jnp.asarray, _batch(algo)))
    train = {"supervised": lambda: jsteps.make_supervised_punet_step(model, tx),
             "mt": lambda: jsteps.make_mean_teacher_step(model, tx,
                                                         do_consensus_masking=masking),
             "adamt": lambda: jsteps.make_adamt_step(model, tx,
                                                     do_consensus_masking=masking)}[algo]()
    n_keys = 1 + len(NOISE[algo])

    @jax.jit
    def run(state):
        keys = jax.random.split(state.rng, n_keys)
        grads = jax.grad(lambda p: _jax_loss(algo, model, p, state, batch, keys, masking))(
            state.params)
        new, aux = train(state, *batch)
        return new, {"params": new.params, "teacher": new.teacher_params, "aux": aux,
                     "grads": grads, "noise": _draw(state.rng, NOISE[algo])}

    out = []
    for _ in range(n_steps):
        state, rec = run(state)
        out.append(rec)
    return jax.tree_util.tree_map(np.asarray, out)


@functools.lru_cache(maxsize=None)
def _port(case: str) -> list:
    algo, masking, _ = CASES[case]
    model = port_punet(_params(), consensus_masking=masking, rl_swap=False)
    assert model.rl_swap is False
    state = create_train_state(model, adam(model.parameters(), LR),
                               with_teacher=algo != "supervised")
    batch = tuple(map(t, _batch(algo)))
    train = {"supervised": ttrain.make_supervised_punet_step,
             "mt": lambda: ttrain.make_mean_teacher_step(do_consensus_masking=masking),
             "adamt": lambda: ttrain.make_adamt_step(do_consensus_masking=masking)}[algo]()
    out = []
    for rec in _reference(case):
        _, aux = train(state, *batch, **{k: t(v) for k, v in rec["noise"].items()})
        out.append({
            "aux": aux, "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "teacher": (None if state.teacher is None else
                        {k: v.detach().clone() for k, v in state.teacher.state_dict().items()}),
        })
    return out


def _bridged(tree) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_pda(tree).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_bce_loss_and_aux_match_pda(case):
    algo = CASES[case][0]
    for r, p in zip(_reference(case), _port(case)):
        assert set(p["aux"]) == set(r["aux"]) == AUX[algo]
        for name, v in r["aux"].items():
            assert_close_scaled(p["aux"][name].numpy(), v, rel=1e-5)
        # the BCE term is a sum over the batch's pixels, not a mean
        assert float(r["aux"]["loss"]) > 0.1 * B * P * P


@pytest.mark.parametrize("case", list(CASES))
def test_bce_gradients_match_pda(case):
    for r, p in zip(_reference(case), _port(case)):
        want = _bridged(r["grads"])
        assert set(p["grads"]) == set(want)
        for name, g in want.items():
            err = float(np.abs(p["grads"][name].numpy() - g).max())
            assert err <= 1e-4 * float(np.abs(g).max()), (name, err, float(np.abs(g).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_bce_updated_student_and_teacher_match_pda(case):
    ref, port = _reference(case), _port(case)
    old = _bridged(_params())
    noisy = {}
    for k, (r, p) in enumerate(zip(ref, port)):
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


def test_bce_teacher_consensus_is_mixed():
    """The pseudo-label pass the MT and AdaMT cases exercise: a teacher
    consensus share strictly inside (0, 1) on the weak view."""
    from pda_torch.train import steps as tsteps

    model = port_punet(_params(), consensus_masking=True, rl_swap=False)
    noise = _reference("mt_masking")[0]["noise"]
    _, z = tsteps._mc_pseudo(model, t(_batch("mt")[1]), N_MC_TRAIN, True,
                             t(noise["eps_teacher"]))
    assert 0.0 < float(z.mean()) < 1.0
