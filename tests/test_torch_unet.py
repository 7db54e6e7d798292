"""The port's UNet path against ``pda`` on the CPU: ``UNet2d`` (forward,
both weight-bridge directions), ``PUNetBackbone``'s optional head, the
supervised and pseudo-label UNet steps, ``unet_prediction`` (tiled and
padded, on TIFFs) and the four dice runners (on fixture TIFFs).

Weights are seeded numpy on ``jax.eval_shape(model.init)``'s tree, carried
across by ``unet_state_dict_from_pda`` / ``backbone_state_dict_from_pda``.
Tolerances: outputs 1e-5 of max(1, their largest), loss rel 1e-5, gradients
1e-4 of each leaf's largest, updated parameters 1e-6 (where Adam's sign is
defined), dice means 1e-12.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.eval import dice as jdice
from pda.infer.predict import unet_prediction as j_unet_prediction
from pda.models.convert import convert_unet_state_dict
from pda.models.unet import PUNetBackbone as JBackbone
from pda.models.unet import UNet2d as JUNet2d
from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch import eval as tdice
from pda_torch import train as ttrain
from pda_torch.infer import unet_prediction
from pda_torch.models import (PUNetBackbone, UNet2d, backbone_state_dict_from_pda,
                              unet_state_dict_from_pda)
from pda_torch.train import adam, create_train_state
from torch_port_utils import FILTERS, assert_close_scaled, seeded_params, t

DEPTH, FEATS, LR = 2, 4, 1e-5
NORMS = {"instance_norm": "InstanceNorm", "no_norm": None}


@functools.lru_cache(maxsize=None)
def _pda_unet(norm_case: str = "instance_norm"):
    model = JUNet2d(depth=DEPTH, initial_features=FEATS, final_activation="Sigmoid",
                    norm=NORMS[norm_case])
    return model, seeded_params(model, jnp.zeros((1, 16, 16, 1)), seed=1)


def _port_unet(norm_case: str = "instance_norm") -> UNet2d:
    _, params = _pda_unet(norm_case)
    model = UNet2d(depth=DEPTH, initial_features=FEATS, final_activation="Sigmoid",
                   norm=NORMS[norm_case])
    model.load_state_dict(unet_state_dict_from_pda(params, norm=NORMS[norm_case]))
    return model


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _image(shape=(40, 56), seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    img = 0.02 * xx + rng.normal(size=shape) * 0.3
    for _ in range(5):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        img += 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0)
    return (img * 40 + 100).astype(np.float32)


@pytest.mark.parametrize("norm_case", list(NORMS))
def test_unet2d_forward_matches_pda(norm_case):
    model, params = _pda_unet(norm_case)
    x = np.random.default_rng(2).normal(size=(2, 32, 24, 1)).astype(np.float32) * 3 + 1
    ref = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = _port_unet(norm_case)(t(x))
    assert out.shape == (2, 32, 24, 1)
    assert_close_scaled(out.numpy(), ref)


@pytest.mark.parametrize("norm_case", list(NORMS))
def test_unet_bridge_round_trip_pda_port_pda(norm_case):
    """pda -> port (unet_state_dict_from_pda) -> pda (pda's own
    convert_unet_state_dict), leaf for leaf."""
    _, params = _pda_unet(norm_case)
    back = convert_unet_state_dict(_port_unet(norm_case).state_dict(), depth=DEPTH)
    want, got = _leaves(params), _leaves(back)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unet_port_init_converts_to_pda_tree():
    """The port's own init carries torch_em's names: pda's converter maps it
    to a tree of pda's paths and shapes, and the port's UNet2d at full
    configuration has every name the experiments' checkpoints carry."""
    _, params = _pda_unet()
    port = UNet2d(depth=DEPTH, initial_features=FEATS, generator=torch.Generator().manual_seed(4))
    conv = convert_unet_state_dict(port.state_dict(), depth=DEPTH)
    assert ({k: v.shape for k, v in _leaves(params).items()}
            == {k: v.shape for k, v in _leaves(conv).items()})
    names = set(UNet2d().state_dict())
    assert {"encoder.blocks.3.block.4.weight", "base.block.1.weight",
            "decoder.samplers.0.conv.weight", "decoder.blocks.3.block.1.bias",
            "out_conv.weight"} <= names
    assert UNet2d().decoder.samplers[0].conv.weight.shape == (512, 1024, 1, 1)  # deepest first


@pytest.mark.parametrize("n_convs", [2, 3])
def test_punet_backbone_with_head_matches_pda(n_convs):
    """PUNetBackbone(num_classes=2): the 1x1 head ``last_layer`` (pda's
    ``unet/Conv_0``) on the last decoder map, at 2 and 3 convs a block."""
    model = JBackbone(num_filters=FILTERS, n_convs_per_block=n_convs, num_classes=2)
    params = seeded_params(model, jnp.zeros((1, 16, 16, 1)), seed=3)
    port = PUNetBackbone(1, FILTERS, n_convs=n_convs, num_classes=2)
    sd = backbone_state_dict_from_pda(params)
    assert {"last_layer.weight", "last_layer.bias"} <= set(sd)
    port.load_state_dict(sd)
    x = np.random.default_rng(4).normal(size=(2, 16, 24, 1)).astype(np.float32)
    with torch.no_grad():
        out = port(t(x))
    assert out.shape == (2, 16, 24, 2)
    assert_close_scaled(out.numpy(), model.apply({"params": params}, jnp.asarray(x)))


def test_punet_backbone_head_init():
    """He-normal 1x1 head (std sqrt(2 / C0)) and biases within 2 sigma of
    1e-3."""
    head = PUNetBackbone(1, (64, 32), num_classes=3).last_layer.requires_grad_(False)
    assert abs(float(head.weight.std()) - (2.0 / 64) ** 0.5) < 0.06
    assert float(head.bias.abs().max()) <= 2e-3


# -- the UNet steps -----------------------------------------------------------

STEPS = ["supervised_unet", "pseudo_unet"]


def _unet_batch(algo):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    y = (x > 0.3).astype(np.float32)
    if algo == "supervised_unet":
        return x, y
    return x, rng.uniform(size=x.shape).astype(np.float32), (x > -0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _unet_reference(algo):
    model, params = _pda_unet()
    tx = jadam(LR)
    state = jcreate_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.random.PRNGKey(0))
    batch = tuple(map(jnp.asarray, _unet_batch(algo)))
    make, make_val = {"supervised_unet": (jsteps.make_supervised_unet_step,
                                          jsteps.make_supervised_unet_val_step),
                      "pseudo_unet": (jsteps.make_pseudo_unet_step,
                                      jsteps.make_pseudo_unet_val_step)}[algo]

    def loss(p):
        pred = model.apply({"params": p}, batch[0])
        if algo == "supervised_unet":
            return jsteps.dice_loss(pred, batch[1])
        return jsteps.dice_loss(pred * batch[2], batch[1] * batch[2])

    new, aux = jax.jit(make(model, tx))(state, *batch)
    _, vaux = jax.jit(make_val(model))(state, *batch)
    out = {"params": new.params, "aux": aux, "val": vaux, "grads": jax.grad(loss)(state.params)}
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("algo", STEPS)
def test_unet_step_matches_pda(algo):
    ref = _unet_reference(algo)
    model = _port_unet()
    state = create_train_state(model, adam(model.parameters(), LR))
    make, make_val = {"supervised_unet": (ttrain.make_supervised_unet_step,
                                          ttrain.make_supervised_unet_val_step),
                      "pseudo_unet": (ttrain.make_pseudo_unet_step,
                                      ttrain.make_pseudo_unet_val_step)}[algo]
    batch = tuple(map(t, _unet_batch(algo)))
    _, vaux = make_val()(state, *batch)
    _, aux = make()(state, *batch)
    assert state.step == 1
    for want, got in ((ref["aux"], aux), (ref["val"], vaux)):
        assert set(want) == set(got)
        for k, v in want.items():
            assert_close_scaled(got[k].numpy(), v, rel=1e-5)
    grads = {k: v.numpy() for k, v in unet_state_dict_from_pda(ref["grads"]).items()}
    new = {k: v.numpy() for k, v in unet_state_dict_from_pda(ref["params"]).items()}
    old = {k: v.numpy() for k, v in unet_state_dict_from_pda(_pda_unet()[1]).items()}
    # A sampler's bias is taken out again by the InstanceNorm after the
    # concat: its exact gradient is 0, both sides hold rounding noise (within
    # 1e-6 of the largest gradient) and Adam's step there is noise.
    top = max(float(np.abs(g).max()) for g in grads.values())
    for name, p in model.named_parameters():
        g = np.abs(grads[name])
        zero = name.startswith("decoder.samplers.") and name.endswith(".bias")
        scale = 1e-2 * top if zero else float(g.max())
        assert float(np.abs(p.grad.numpy() - grads[name]).max()) <= 1e-4 * scale, name
        noisy = (g <= 1e-5 * g.max()) | zero  # there Adam's sign is noise
        out = p.detach().numpy()
        assert np.abs(out - new[name])[~noisy].max(initial=0.0) <= 1e-6, name
        assert np.abs(out - old[name])[noisy].max(initial=0.0) <= LR * (1 + 1e-6), name


# -- unet_prediction ------------------------------------------------------------


@pytest.mark.parametrize("tiling", [True, False])
def test_unet_prediction_matches_pda(tmp_path, tiling):
    """File level: the same TIFFs in, float32 probability TIFFs out, against
    pda's unet_prediction (tiled: block 32, halo 16; padded: to 16)."""
    import imageio.v3 as imageio

    model, params = _pda_unet()
    src = tmp_path / "images"
    src.mkdir()
    for i, name in enumerate(["a.tif", "b.tif"]):
        imageio.imwrite(str(src / name), _image(seed=i))
    kw = dict(tiling=tiling, block_shape=(32, 32), halo=(16, 16), verbose=False)
    j_unet_prediction(str(src / "*.tif"), str(tmp_path / "ref"), model,
                      jax.tree_util.tree_map(jnp.asarray, params), **kw)
    unet_prediction(str(src / "*.tif"), str(tmp_path / "port"), _port_unet(), **kw)
    for name in ("a.tif", "b.tif"):
        ref = imageio.imread(str(tmp_path / "ref" / name))
        out = imageio.imread(str(tmp_path / "port" / name))
        assert out.shape == (40, 56) and out.dtype == np.float32
        assert float(np.abs(out - ref).max()) <= 1e-5


# -- dice runners ---------------------------------------------------------------


def _write(folder, name, arr):
    import imageio.v3 as imageio

    os.makedirs(folder, exist_ok=True)
    imageio.imwrite(os.path.join(folder, name), arr)


def _masks(seed, shape=(24, 20)):
    rng = np.random.default_rng(seed)
    gt = (rng.uniform(size=shape) > 0.6).astype(np.uint8) * 255
    pred = np.clip(gt / 255.0 * 0.7 + rng.uniform(size=shape) * 0.5, 0, 1).astype(np.float32)
    return gt, pred


#: case -> (runner name, keyword, value, [(gt name, prediction name)])
DICE_CASES = {
    "livecell": ("run_dice_evaluation", "subtype", None, [("a.tif", "a.tif"), ("b.tif", "b.tif")]),
    "livecell_lucchi": ("run_dice_evaluation", "subtype", "lucchi",
                        [("7.tif", "mask0007.tif"), ("12.tif", "mask0012.tif")]),
    "livecell_urocell": ("run_dice_evaluation", "subtype", "urocell",
                         [("c_gt.tif", "c_image.tif")]),
    "lung": ("run_lung_dice_evaluation", "lung_domain", "montgomery",
             [("l1.tif", "l1.tif"), ("l2.tif", "l2.tif")]),
    "lung_jsrt2": ("run_lung_dice_evaluation", "lung_domain", "jsrt2",
                   [("JPCLN001_lmask.tif", "JPCLN001.tif"), ("other.tif", "other.tif")]),
    "em_vnc": ("run_em_dice_evaluation", "model", "vnc", [("v1.tif", "v1.tif")]),
    "em_lucchi": ("run_em_dice_evaluation", "model", "lucchi", [("3.tif", "mask0003.tif")]),
    "em_mitoem": ("run_em_dice_evaluation", "model", "mitoem", [("seg0001.tif", "im0001.tif")]),
    "em_other": ("run_em_dice_evaluation", "model", "urocell", [("u.tif", "u.tif")]),
    "pseudo_punet": ("run_dice_evaluation_for_pseudo", "model", "punet", [("p.tif", "p.tif")]),
    "pseudo_unet": ("run_dice_evaluation_for_pseudo", "model", "unet", [("q.tif", "q-c0.tif")]),
}


@pytest.mark.parametrize("case", list(DICE_CASES))
def test_dice_runner_matches_pda(tmp_path, case):
    runner, key, value, files = DICE_CASES[case]
    gt_dir, pred_dir, cons_dir = (str(tmp_path / d) for d in ("gt", "pred", "cons"))
    for i, (gt_name, pred_name) in enumerate(files):
        gt, pred = _masks(i)
        _write(gt_dir, gt_name, gt)
        _write(pred_dir, pred_name, pred)
        _write(cons_dir, gt_name, (np.random.default_rng(i + 9).uniform(size=gt.shape) > 0.3)
               .astype(np.uint8))
    gt_path = os.path.join(gt_dir, "*.tif" if runner == "run_dice_evaluation" else "")
    args = (gt_path, pred_dir) + ((cons_dir,) if runner == "run_dice_evaluation_for_pseudo"
                                  else ())
    kw = {key: value, "verbose": False}
    want = getattr(jdice, runner)(*args, **kw)
    got = getattr(tdice, runner)(*args, **kw)
    assert 0.0 < want < 1.0
    assert abs(got - want) <= 1e-12
