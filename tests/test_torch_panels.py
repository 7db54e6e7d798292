"""The port's panel makers (``pda_torch.train.steps.make_*_panels``, the
TensorBoard images each reference logger writes) against ``pda``'s on the
CPU: the same weights, batch and noise (the normals of ``pda``'s
``_panel_keys``), every panel within 1e-5 of the largest value (the
consensus masks exactly)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pda.train import steps as jsteps
from pda_torch.models import unet_state_dict_from_pda
from pda_torch.train import steps as tsteps
from torch_port_utils import (LATENT, assert_close_scaled, pda_punet, port_punet, seeded_params,
                              t)

B, P = 2, 16
#: panel maker -> (the batch's fields, PUNet (else UNet2d), the port's noise keywords)
PANELS = {
    "punet": ("xy", True, ("eps_samples",)),
    "pseudo_punet": ("xyz", True, ("eps_samples",)),
    "mean_teacher": ("target", True, ("eps_teacher", "eps_mc")),
    "fixmatch": ("target", True, ("eps_weak", "eps_mc")),
    "adamt": ("target", True, ("eps_teacher", "eps_mc")),
    "adamatch": ("target", True, ("eps_weak", "eps_mc")),
    "pseudo_unet": ("xyz", False, ()),
    "supervised_unet": ("xy", False, ()),
}


@functools.lru_cache(maxsize=None)
def _punet_params(seed):
    _, params = pda_punet(seed=seed)
    fc = dict(params["fcomb"])
    fc["last_layer"] = {k: v * 32.0 for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * 0.02}
    return {**params, "fcomb": fc}


@functools.lru_cache(maxsize=None)
def _unet():
    from pda.models import UNet2d as JUNet2d

    model = JUNet2d(depth=2, initial_features=4, final_activation="Sigmoid")
    return model, seeded_params(model, jnp.zeros((1, P, P, 1)), seed=3)


def _batch(fields):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, P, P, 1)).astype(np.float32)
    y = (x > 0.3).astype(np.float32)
    if fields == "xy":
        return x, y
    if fields == "xyz":
        return x, rng.uniform(size=x.shape).astype(np.float32), (x > -0.5).astype(np.float32)
    views = [x + 0.1 * rng.normal(size=x.shape).astype(np.float32) for _ in range(2)]
    return (x, *views, y)


@pytest.mark.parametrize("name", list(PANELS))
def test_panels_match_pda(name):
    fields, is_punet, noise = PANELS[name]
    batch = _batch(fields)
    jmake, tmake = getattr(jsteps, f"make_{name}_panels"), getattr(tsteps, f"make_{name}_panels")
    kw = {"do_consensus_masking": True} if len(noise) == 2 else {}
    if is_punet:
        jmodel, _ = pda_punet(consensus_masking=True)
        params, teacher = _punet_params(0), _punet_params(1)
        model = port_punet(params, consensus_masking=True)
        port_teacher = port_punet(teacher, consensus_masking=True)
    else:
        from pda_torch.models import UNet2d

        jmodel, params = _unet()
        teacher = params
        model = UNet2d(depth=2, initial_features=4, final_activation="Sigmoid")
        model.load_state_dict(unet_state_dict_from_pda(params))
        port_teacher = model
    rng = jax.random.PRNGKey(11)
    want = jmake(jmodel, **kw)(jax.tree_util.tree_map(jnp.asarray, params),
                               jax.tree_util.tree_map(jnp.asarray, teacher), rng,
                               *map(jnp.asarray, batch))
    keys = jsteps._panel_keys(rng, len(noise)) if noise else []
    eps = {k: t(jax.random.normal(key, (16, 1, LATENT))) for k, key in zip(noise, keys)}
    got = tmake(**kw)(model, port_teacher, *map(t, batch), **eps)
    assert sorted(got) == sorted(want)
    for tag, w in want.items():
        g = got[tag].detach().numpy()
        if "consensus" in tag:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=tag)
            assert 0.0 < float(np.mean(w)) < 1.0, tag
        else:
            assert_close_scaled(g, np.asarray(w), rel=1e-5)
