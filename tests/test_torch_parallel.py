"""The port's data mesh (``pda_torch.parallel``) on the CPU: gloo worlds of 2
and 4 ranks, spawned once each for the whole module
(``tests/torch_dp_worker.py`` runs every case on each rank).

  * (a) every train step sharded against the port's single-process step on
    the global batch of 4, within ``pda``'s bounds (``tests/test_parallel.py``):
    loss and aux 1e-5 relative; the parameters after one SGD step 1e-5
    (supervised steps) or 1e-4 (the others); the summed gradients leaf by
    leaf within 1e-4 of the leaf's largest; the teacher 1e-4; every rank
    holding the same bytes. SGD makes the step lr times the gradient, so a
    gradient averaged over the ranks instead of summed fails; the
    ``supervised_reg`` case (the L2 term's weight at 1) fails unless the
    term enters the differentiated objective divided by the rank count and
    the reported loss whole.
  * (b) every validation step's metrics within 1e-4.
  * (c) the sharded Mean-Teacher step (the port's Adam) and the sharded
    tiled MC serving against ``pda``'s ``shard_map`` step and
    ``_tiled_punet_probs(mesh=get_mesh(2))`` on the 8-device CPU mesh of
    ``conftest.py``: same weights, the same JAX-drawn global noise; a tile
    count the mesh divides (4) and one it pads (9 -> 10). The same two
    frames through ``punet_prediction(mesh=)`` against ``pda``'s
    ``punet_prediction(mesh=get_mesh(2))``: the TIFFs, written by rank 0
    alone, every rank returning.
  * (d) a world of 1 bit-equal to ``mesh=None``.
  * (e) the refusals (``shard_batch``, a ``Loader`` shard, ``mesh_from_arg``
    against ``pda``'s, a ``space=M`` mesh in a world other than N x M, a
    world other than the launcher's, a second mesh in one process, a
    trainer's device off its mesh). The (data, space) mesh itself is
    ``tests/test_torch_space.py``'s.
  * (f) ``PUNetTrainer(mesh=).fit(4)`` at world 2 against ``fit(4)`` in one
    process: equal parameters on both ranks, within (a)'s bounds of the
    single process's; rank 0 alone wrote the checkpoints and the event file.
    A trainer that validates at batch 1, as the CLIs' do, refuses a world of
    2 at set-up, before its first step, with ``pda``'s message.
"""

from __future__ import annotations

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as W
from torch_port_utils import FILTERS, LATENT, numpy_augs, pda_punet

B, P, MC, SEED = 4, 32, 16, 3
LAST_SCALE, Z_SCALE = 32.0, 0.02  # test_torch_train_step.py's: a consensus share inside (0, 1)
TILE_N, TILE_BLOCK, TILE_HALO = 4, (32, 32), (8, 8)
TILE_FRAMES = {"divided": (64, 64), "padded": (96, 96)}  # 2x2 and 3x3 tiles of 32^2
PREDICTION_SEED = 0  # punet_prediction's default
WORLD2 = [*W.TRAIN, *W.VAL, "mt_adam", "tiles", "prediction", "fit", "val_batch_1"]
WORLD4 = ["mt", "mt_val"]
SUPERVISED = ("supervised", "supervised_reg", "pseudo_punet", "unet", "pseudo_unet")


@functools.lru_cache(maxsize=None)
def _pda_params():
    _, params = pda_punet(consensus_masking=True)
    fc = dict(params["fcomb"])
    fc["last_layer"] = {k: v * LAST_SCALE for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * Z_SCALE}
    return {**params, "fcomb": fc}


def _padded(n, world):
    return n + (-n) % world


@functools.lru_cache(maxsize=None)
def _spec(world: int) -> dict:
    """Weights, global batches and global noise of every case. The MT
    noise is what ``pda``'s step draws from its state's key (``rng, k_t,
    k_post = split(state.rng, 3)``); each frame's tile noise is ``pda``'s
    ``normal(key, (n, padded tiles, L))``."""
    from pda_torch.models import UNet2d, state_dict_from_pda

    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(B, P, P, 1)).astype(np.float32)
    x1 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    x2 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    gt = (x > 0.5).astype(np.float32)
    xs = rng.normal(size=x.shape).astype(np.float32)
    ys = (xs > 0.3).astype(np.float32)
    z = (rng.random(x.shape) > 0.3).astype(np.float32)
    t = torch.from_numpy
    batches = {"xy": (t(x), t(gt)), "xyz": (t(x), t(gt), t(z)),
               "dual": (t(x), t(x1), t(x2), t(gt)),
               "joint": (t(xs), t(ys), t(x), t(x1), t(x2), t(gt)),
               "target": (t(x), t(x1), t(x2), t(gt))}
    _, k_t, k_post = jax.random.split(jax.random.PRNGKey(SEED), 3)
    noise = {"eps_teacher": np.asarray(jax.random.normal(k_t, (MC, B, LATENT))),
             "eps_post": np.asarray(jax.random.normal(k_post, (B, LATENT)))}
    for name, shape in (("eps_source", (B, LATENT)), ("eps_weak", (MC, B, LATENT)),
                        ("eps_mc", (MC, B, LATENT)), ("eps_mc8", (W.N_MC_VAL, B, LATENT))):
        noise[name] = rng.normal(size=shape).astype(np.float32)
    tiles = {}
    for i, (name, hw) in enumerate(TILE_FRAMES.items()):
        image = rng.normal(size=(*hw, 1)).astype(np.float32)
        n_tiles = (hw[0] // TILE_BLOCK[0]) * (hw[1] // TILE_BLOCK[1])
        eps = jax.random.normal(jax.random.PRNGKey(10 + i),
                                (TILE_N, _padded(n_tiles, world), LATENT))
        tiles[name] = (t(image), t(np.array(eps)), TILE_N, TILE_BLOCK, TILE_HALO)
    # punet_prediction's noise in pda: a frame's key split off PRNGKey(seed)
    # in glob order, its normal((n, padded tiles, L))
    key, prediction_eps = jax.random.PRNGKey(PREDICTION_SEED), []
    for name, hw in sorted(TILE_FRAMES.items()):
        key, sub = jax.random.split(key)
        n_tiles = (hw[0] // TILE_BLOCK[0]) * (hw[1] // TILE_BLOCK[1])
        prediction_eps.append(
            t(np.array(jax.random.normal(sub, (TILE_N, _padded(n_tiles, world), LATENT)))))
    unet_cfg = dict(depth=2, initial_features=4, final_activation="Sigmoid")
    return {
        "punet_cfg": dict(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3, beta=1.0,
                          rl_swap=True, consensus_masking=True),
        "punet_state": state_dict_from_pda(_pda_params()),
        "unet_cfg": unet_cfg,
        "unet_state": UNet2d(**unet_cfg, generator=torch.Generator().manual_seed(4)).state_dict(),
        "batches": batches, "noise": {k: t(np.array(v)) for k, v in noise.items()},
        "tiles": tiles, "cases": WORLD2 if world == 2 else WORLD4,
        "prediction": {"frames": {name: tiles[name][0][..., 0] for name in sorted(TILE_FRAMES)},
                       "eps": prediction_eps, "n": TILE_N, "block": TILE_BLOCK,
                       "halo": TILE_HALO}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> each rank's results, one spawn a world."""
    return {world: W.spawn(world, _spec(world), str(tmp_path_factory.mktemp(f"world{world}")))
            for world in (2, 4)}


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """world -> the single-process results on the global batch."""
    with numpy_augs():
        return {world: W.run_cases(_spec(world), None,
                                   root=str(tmp_path_factory.mktemp(f"single{world}")))
                for world in (2, 4)}


def _close(out, ref, rel, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(out - ref).max()) if out.size else 0.0
    tol = rel * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.1e}"


def _same_on_every_rank(results, case, part):
    for r, res in enumerate(results[1:], 1):
        for k, v in res[case][part].items():
            assert torch.equal(v, results[0][case][part][k]), f"rank {r} {part} {k}"


TRAIN_CASES = [(2, c) for c in W.TRAIN] + [(4, "mt")]


@pytest.mark.parametrize("world,case", TRAIN_CASES, ids=[f"{c}-w{w}" for w, c in TRAIN_CASES])
def test_sharded_train_step_matches_single_process(ranks, single, world, case):
    got, ref = ranks[world][0][case], single[world][case]
    for k, v in ref["aux"].items():
        _close(got["aux"][k], v, 1e-5, f"aux {k}")
    bound = 1e-5 if case in SUPERVISED else 1e-4
    for k, v in ref["params"].items():
        _close(got["params"][k], v, bound, f"param {k}")
    assert got["grads"].keys() == ref["grads"].keys()
    largest = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        # a leaf's scale floored at 1e-3 of the largest leaf's: a bias ahead of
        # a norm has a gradient of 0 up to float32 cancellation
        err = float((got["grads"][k] - g).abs().max())
        assert err <= 1e-4 * max(float(g.abs().max()), 1e-3 * largest), f"grad {k}: {err:.3e}"
    for k, v in ref["teacher"].items():
        _close(got["teacher"][k], v, 1e-4, f"teacher {k}")
    for part in ("params", "grads", "teacher"):
        _same_on_every_rank(ranks[world], case, part)


@pytest.mark.parametrize("case", ["supervised", "supervised_reg"])
def test_gradients_are_summed_and_l2_divided(ranks, single, case):
    """What (a) pins, said outright: the ranks' summed gradients are the
    single-process gradients, and half of them (the mean over 2 ranks) are
    not; with the L2 term at weight 1 the reported loss carries it whole."""
    got, ref = ranks[2][0][case], single[2][case]
    gaps = [float((got["grads"][k] - g / 2).abs().max()) / max(float(g.abs().max()), 1e-12)
            for k, g in ref["grads"].items()]
    assert max(gaps) > 0.4
    if case == "supervised_reg":  # the L2 term dominates the loss
        reg = ref["aux"]["loss"] - ref["aux"]["recon_loss"] - ref["aux"]["kl"]
        assert reg > 0.5 * ref["aux"]["loss"]
        _close(got["aux"]["loss"], ref["aux"]["loss"], 1e-5, "loss")


VAL_CASES = [(2, c) for c in W.VAL] + [(4, "mt_val")]


@pytest.mark.parametrize("world,case", VAL_CASES, ids=[f"{c}-w{w}" for w, c in VAL_CASES])
def test_sharded_val_step_matches_single_process(ranks, single, world, case):
    ref = single[world][case]
    for res in ranks[world]:
        assert res[case].keys() == ref.keys()
        for k, v in ref.items():
            assert abs(res[case][k] - v) <= 1e-4, (k, res[case][k], v)


@functools.lru_cache(maxsize=None)
def _pda_mt_shard_map():
    """``pda``'s Mean-Teacher step inside ``jax.shard_map`` on 2 devices,
    Adam at the worker's rate, from the spec's weights and key."""
    from jax.sharding import PartitionSpec as Ps

    from pda.parallel import get_mesh, replicated
    from pda.train.optim import adam
    from pda.train.state import create_train_state
    from pda.train.steps import make_mean_teacher_step

    model, _ = pda_punet(consensus_masking=True)
    tx = adam(W.ADAM_LR)
    params = jax.tree_util.tree_map(jnp.asarray, _pda_params())
    state = create_train_state(params, tx, jax.random.PRNGKey(SEED), with_teacher=True)
    mesh = get_mesh(2)
    step = jax.jit(jax.shard_map(
        make_mean_teacher_step(model, tx, momentum=W.MOMENTUM, do_consensus_masking=True,
                               axis_name="data"),
        mesh=mesh, in_specs=(Ps(), *([Ps("data")] * 4)), out_specs=(Ps(), Ps()),
        check_vma=False))
    batch = [jnp.asarray(b.numpy()) for b in _spec(2)["batches"]["dual"]]
    return step(jax.device_put(state, replicated(mesh)), *batch)


def test_sharded_mt_step_matches_pda_shard_map(ranks):
    from pda_torch.models import state_dict_from_pda

    state, metrics = _pda_mt_shard_map()
    got = ranks[2][0]["mt_adam"]
    for k in ("loss", "recon_loss", "kl"):
        _close(got["aux"][k], float(metrics[k]), 1e-5, k)
    for part, tree in (("params", state.params), ("teacher", state.teacher_params)):
        ref = state_dict_from_pda(jax.tree_util.tree_map(np.asarray, tree))
        for k, v in ref.items():
            _close(got[part][k], v, 1e-4, f"{part} {k}")
    _same_on_every_rank(ranks[2], "mt_adam", "params")


@pytest.mark.parametrize("frame", list(TILE_FRAMES))
def test_sharded_tiles_match_pda_shard_map(ranks, single, frame):
    from pda.infer.predict import _tiled_punet_probs
    from pda.parallel import get_mesh

    model, _ = pda_punet(consensus_masking=True)
    image = _spec(2)["tiles"][frame][0]
    key = jax.random.PRNGKey(10 + list(TILE_FRAMES).index(frame))
    ref = np.asarray(_tiled_punet_probs(model, _pda_params(), jnp.asarray(image.numpy()), key,
                                        TILE_N, TILE_BLOCK, TILE_HALO, mesh=get_mesh(2)))
    for res in ranks[2]:
        out = res["tiles"][frame]
        assert out.shape == (*TILE_FRAMES[frame], 1)
        _close(out.numpy(), ref, 1e-5, frame)
    if frame == "divided":  # no padding: the single-process frame, same noise
        _close(ranks[2][0]["tiles"][frame].numpy(), single[2]["tiles"][frame].numpy(), 1e-6,
               "single process")


def test_sharded_prediction_matches_pda_shard_map(ranks, single, tmp_path):
    """``punet_prediction(mesh=)`` at world 2: rank 0 alone wrote one TIFF a
    frame, every rank returned, and the TIFFs are ``pda``'s
    ``punet_prediction(mesh=get_mesh(2))``'s on the same frames, weights and
    noise, within (c)'s bound; the frame the mesh divides is the
    single-process TIFF."""
    from pda.infer.predict import punet_prediction
    from pda.parallel import get_mesh
    from pda_torch.data.tiff import read_image

    got = [r["prediction"] for r in ranks[2]]
    names = [f"{name}.tif" for name in sorted(TILE_FRAMES)]
    assert all(g["returned"] for g in got)
    assert got[0]["writes"] == names and got[1]["writes"] == []
    assert sorted(os.listdir(got[0]["out_dir"])) == names
    model, _ = pda_punet(consensus_masking=True)
    out = str(tmp_path / "pda")
    punet_prediction(os.path.join(got[0]["in_dir"], "*.tif"), out, model, _pda_params(),
                     prior_samples=TILE_N, block_shape=TILE_BLOCK, halo=TILE_HALO,
                     seed=PREDICTION_SEED, mesh=get_mesh(2), verbose=False)
    for name in names:
        port = read_image(os.path.join(got[0]["out_dir"], name))
        ref = read_image(os.path.join(out, name))
        assert port.shape == ref.shape == TILE_FRAMES[name[:-4]]
        _close(port, ref, 1e-5, name)
    name = "divided.tif"
    _close(read_image(os.path.join(got[0]["out_dir"], name)),
           read_image(os.path.join(single[2]["prediction"]["out_dir"], name)), 1e-6,
           "single process")


@pytest.fixture(scope="module")
def world1():
    """Every train, validation and tile case on an in-process gloo world of
    1, and without a mesh."""
    from pda_torch.parallel import get_mesh

    spec = W.copy_spec(_spec(1), [*W.TRAIN, *W.VAL, "tiles"])
    mesh = get_mesh(1, device="cpu")
    try:
        assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
        return W.run_cases(spec, mesh), W.run_cases(spec, None)
    finally:
        mesh.destroy()


def _bit_equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _bit_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, (what, a, b)


@pytest.mark.parametrize("case", [*W.TRAIN, *W.VAL, "tiles"])
def test_world_of_one_is_bit_equal_to_no_mesh(world1, case):
    meshed, plain = world1
    _bit_equal(meshed[case], plain[case], case)


def test_shard_batch_refuses_what_the_mesh_does_not_divide():
    from pda.parallel import get_mesh as jget_mesh
    from pda.parallel import shard_batch as jshard_batch
    from pda_torch.parallel import Mesh, shard_batch

    x = np.zeros((3, 4, 4, 1), np.float32)
    with pytest.raises(ValueError) as ref:
        jshard_batch(jget_mesh(2), (x,))
    mesh = Mesh(None, 2, 1, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError) as got:
        shard_batch(mesh, (x,))
    assert str(got.value) == str(ref.value)
    x4 = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    rows, scalar = shard_batch(mesh, (x4, np.float32(7)))
    np.testing.assert_array_equal(rows, x4[2:])
    assert scalar == 7


def test_loader_shard_fetches_the_ranks_rows():
    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays

    raws, labels = make_dataset_arrays(2, (48, 48), seed=1)
    ds = ImageCollectionDataset(raws, labels, patch_shape=(16, 16), n_samples=8, seed=2,
                                raw_transform=None)
    whole = list(Loader(ds, 4, seed=3))
    parts = [list(Loader(ds, 4, seed=3, shard=(r, 2))) for r in range(2)]
    assert len(whole) == len(parts[0]) == 2
    for i, batch in enumerate(whole):
        for f in range(2):
            np.testing.assert_array_equal(
                np.concatenate([parts[0][i][f], parts[1][i][f]]), batch[f])
    with pytest.raises(ValueError, match="not divisible by the mesh's 'data' axis"):
        Loader(ds, 3, shard=(0, 2))


def _pda_spec(spec):
    from pda.experiments.common import mesh_from_arg, standard_parser

    try:
        mesh = mesh_from_arg(standard_parser("mesh").parse_args(["--mesh", spec]))
        return ("mesh", mesh.devices.shape)
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e))


def _launched(monkeypatch, world: int) -> None:
    """This process as rank 0 of a ``torchrun`` world of ``world``."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(world))


SPECS = ["auto", "data=2", "data=2,space=1", "data=4", "data=2,space=2", "data=0", "data=x",
         "data", "data=2,data=2", "data=2,bogus=2"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_from_arg_parses_as_pda(monkeypatch, spec):
    """Launched as a world of 2: ``auto`` and ``data=2`` ask ``get_mesh``
    for the world (recorded here in place of a process group), ``data=4``
    and ``data=2,space=2`` (a world of 4) raise with the launch line before
    any group is made; every malformed spec is ``pda``'s refusal, word for
    word."""
    import torch.distributed as dist

    from pda_torch import parallel
    from pda_torch.experiments.common import mesh_from_arg, standard_parser

    ref = _pda_spec(spec)
    _launched(monkeypatch, 2)
    real = parallel.get_mesh
    asked = []

    def recorded(n_devices=None, **kw):
        asked.append(n_devices)
        if n_devices not in (None, 2):
            return real(n_devices, **kw)
        return parallel.Mesh(None, 2, 0, torch.device(kw["device"]), "gloo")

    monkeypatch.setattr(parallel, "get_mesh", recorded)
    try:
        mesh = mesh_from_arg(standard_parser("mesh").parse_args(["--mesh", spec]), "cpu")
        got = ("mesh", mesh.world, asked)
    except Exception as e:  # noqa: BLE001 - the refusals are compared
        got = (type(e).__name__, str(e))
    assert not dist.is_initialized()
    if spec in ("auto", "data=2", "data=2,space=1"):
        assert got == ("mesh", 2, [None if spec == "auto" else 2])
        assert ref[0] == "mesh"
    elif spec == "data=4":
        assert got[0] == "ValueError" and "torchrun --nproc-per-node 4" in got[1]
        assert ref == ("mesh", (4,))
    elif spec == "data=2,space=2":
        assert got[0] == "ValueError" and ("torchrun --nproc-per-node 4 -m pda_torch.experiments"
                                           ".<cli> --mesh data=2,space=2") in got[1]
        assert ref == ("mesh", (2, 2))
    else:
        assert got == ref and got[0] == "ValueError"


def test_mesh_from_arg_without_a_launcher():
    """No torchrun: ``data=N > 1`` and ``data=1,space=2`` raise with the
    launch line before any process group is made; no ``--mesh`` is no
    mesh."""
    import torch.distributed as dist

    from pda_torch.experiments.common import mesh_from_arg, standard_parser

    parser = standard_parser("mesh")
    assert mesh_from_arg(parser.parse_args([]), "cpu") is None
    assert mesh_from_arg(argparse.Namespace(), "cpu") is None
    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 2 -m pda_torch"):
        mesh_from_arg(parser.parse_args(["--mesh", "data=2"]), "cpu")
    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 2 -m pda_torch\.experiments"
                                         r"\.<cli> --mesh data=1,space=2"):
        mesh_from_arg(parser.parse_args(["--mesh", "data=1,space=2"]), "cpu")
    assert not dist.is_initialized()


def test_get_mesh_refuses_another_world_and_a_second_mesh(monkeypatch):
    """A world other than the one given (explicitly, or by the launcher)
    raises with the launch line and makes no group; one mesh a process: a
    second ``get_mesh`` raises until the first is destroyed."""
    import torch.distributed as dist

    from pda_torch.parallel import get_mesh

    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 4 -m pda_torch"):
        get_mesh(4, device="cpu", rank=0, world_size=2, store=dist.HashStore())
    with monkeypatch.context() as env:
        _launched(env, 2)
        with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 1 -m pda_torch"):
            get_mesh(1, device="cpu")
    assert not dist.is_initialized()
    mesh = get_mesh(1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="one mesh a process"):
            get_mesh(device="cpu")
    finally:
        mesh.destroy()
    assert not dist.is_initialized()
    mesh.destroy()  # a second time: nothing left to end
    again = get_mesh(1, device="cpu")
    again.destroy()


def test_trainer_refuses_a_device_off_its_mesh():
    from pda_torch.models import UNet2d
    from pda_torch.parallel import Mesh
    from pda_torch.train import UNetTrainer

    mesh = Mesh(None, 2, 0, torch.device("cuda", 0), "nccl")
    with pytest.raises(ValueError, match="not this rank's mesh device"):
        UNetTrainer("dp", UNet2d(depth=2, initial_features=4), [], [], device="cpu", mesh=mesh)


def test_get_mesh_2d_names_the_next_part():
    """``get_mesh_2d`` is the (data, space) mesh: in a world other than N x M
    it raises with the launch line of N x M ranks and makes no group; in
    this process a (1, 1) mesh has its world, its two axes' groups of one
    rank, and ends its process group once."""
    import torch.distributed as dist

    from pda_torch.parallel import get_mesh_2d

    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 4 -m pda_torch\.experiments"
                                         r"\.<cli> --mesh data=2,space=2"):
        get_mesh_2d(2, 2, device="cpu")
    assert not dist.is_initialized()
    mesh = get_mesh_2d(1, 1, device="cpu")
    try:
        assert mesh.shape == {"data": 1, "space": 1} and mesh.world == 1
        for axis in ("data", "space"):
            view = mesh.axis(axis)
            assert (view.world, view.rank, view.ranks) == (1, 0, [0])
    finally:
        mesh.destroy()
    assert not dist.is_initialized()


def test_sharded_normal_is_the_ranks_slice_of_one_draw():
    from pda_torch.core.distributions import sharded_normal
    from pda_torch.parallel import Mesh

    full = torch.randn(16, 4, 6, generator=torch.Generator().manual_seed(0))
    for r in range(2):
        mesh = Mesh(None, 2, r, torch.device("cpu"), "gloo")
        got = sharded_normal((16, 2, 6), eps=full, mesh=mesh, batch_axis=1)
        assert got.is_contiguous() and torch.equal(got, full[:, 2 * r:2 * r + 2])
        drawn = sharded_normal((16, 2, 6), generator=torch.Generator().manual_seed(0),
                               mesh=mesh, batch_axis=1)
        assert torch.equal(drawn, got)
        with pytest.raises(ValueError, match="global batch"):
            sharded_normal((16, 2, 6), eps=full[:, :2], mesh=mesh, batch_axis=1)


def test_trainer_fit_at_world_two(ranks, single):
    got, ref = [r["fit"] for r in ranks[2]], single[2]["fit"]
    for k, v in ref["params"].items():
        _close(got[0]["params"][k], v, 1e-5, f"param {k}")
        assert torch.equal(got[1]["params"][k], got[0]["params"][k]), k
    _close(got[0]["loss"], ref["loss"], 1e-5, "train losses")
    for a, b in zip(got[0]["val"], ref["val"]):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-4, (k, a[k], b[k])
    assert got[0]["val"] == got[1]["val"]
    assert got[0]["writes"] == ref["writes"] and len(ref["writes"]) >= 2
    assert got[1]["writes"] == [] and got[0]["logger"] and not got[1]["logger"]
    assert len(W.event_files(ranks[2][0]["fit_root"])) == 1


TORCHRUN_SCRIPT = """
import argparse, sys, torch
from pda_torch.experiments.common import mesh_from_arg
mesh = mesh_from_arg(argparse.Namespace(mesh=sys.argv[1]), "cpu")
t = torch.tensor([float(mesh.rank + 1)])
mesh.all_reduce_(t)
try:
    mesh_from_arg(argparse.Namespace(mesh="auto"), "cpu")
    again = "made"
except RuntimeError:
    again = "refused"
mesh.wait_for_rank0()
with open(f"rank{mesh.rank}.txt", "w") as f:  # each rank its own file: stdout interleaves
    f.write(f"rank {mesh.rank} of {mesh.world} {mesh.backend} sum {float(t)} again {again}")
"""


@pytest.mark.parametrize("spec", ["data=2", "auto"])
def test_torchrun_environment_gives_the_mesh(tmp_path, spec):
    """``torchrun --nproc-per-node 2`` (its rendezvous on localhost): each
    rank's ``--mesh data=2`` or ``auto`` is the launcher's world of 2, and a
    second mesh in the rank's process is refused."""
    import subprocess
    import sys

    script = tmp_path / "ranks.py"
    script.write_text(TORCHRUN_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", str(script), spec], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = [(tmp_path / f"rank{r}.txt").read_text() for r in range(2)]
    assert lines == [f"rank {r} of 2 gloo sum 3.0 again refused" for r in range(2)]


def test_cli_shaped_trainer_refuses_a_world_of_two(ranks):
    """The CLIs validate at batch 1, which 2 ranks cannot share: the
    trainer raises ``shard_batch``'s message when it sets up, on every
    rank, before any step."""
    for res in ranks[2]:
        got = res["val_batch_1"]
        assert got["steps"] == 0
        assert got["refused"] is not None and got["refused"].startswith(
            "batch size 1 is not divisible by the mesh's 'data' axis (2)"), got
