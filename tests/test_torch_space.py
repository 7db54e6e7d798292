"""The port's (data, space) mesh (``pda_torch.parallel.get_mesh_2d``) on the
CPU against one process: gloo worlds of (1, 2), (2, 2) and (1, 4) ranks,
spawned once each for the module (``tests/torch_space_worker.py`` runs
every case on each rank), at ``pda``'s ``TestSpatialShardMap`` geometry,
H 160 x W 64 with num_filters (4, 8, 12, 16), and H 288 at (1, 4) for 9
rows a shard at the deepest level.

  * (a) the supervised PUNet step (with the L2 term at weight 1 too), the
    Mean-Teacher step (consensus masking on), FixMatch with distribution
    alignment (its foreground share over data x space) and the validation
    steps, row-sharded against the port's single-process step on the global
    batch, within the data mesh's bounds (``tests/test_torch_parallel.py``):
    loss and aux 1e-5 relative, the parameters after one SGD step 1e-5
    (supervised) or 1e-4, the summed gradients leaf by leaf within 1e-4 of
    the leaf's largest, the teacher 1e-4, the metrics 1e-4; every rank
    holding the same bytes.
  * (b) every route of the row-sharded block in float64 (single, pooled
    "with" and "only", dual, each also in the mixed mode; the
    align-corners upsample; the encoder's completed mean) against the block
    on the whole image: each shard's output rows, the gradients of its
    inputs and, summed over the shards, of the parameters, within 1e-12 of
    the largest; both global edges included, and every interior seam.
  * (c) float64 Jacobians of the halo exchange and of the space mean at a
    world of 2: analytic (backward) against central differences.
  * (d) ``PUNetTrainer(mesh=(1, 2)).fit(4)`` against ``fit(4)`` in one
    process: the parameters within (a)'s bounds, equal on both ranks; rank 0
    alone wrote the checkpoints and logged the panels, whole images
    gathered over the space axis.
  * (e) the refusals, each with ``pda``'s reason: patches too small for
    the halo path, a model without one (``UNet2d``), a row shard of fewer
    than 9 rows, a height the space axis does not divide; and
    ``mesh_from_arg("data=1,space=2")``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import torch_dp_worker as DW
import torch_space_worker as SW
from test_torch_parallel import _close, _pda_params, _same_on_every_rank
from torch_port_utils import FILTERS, LATENT

B, SEED, MC = 4, 3, 16
#: world -> (mesh shape, image height, cases, float64); the width is 64
WORLDS = {"1x2": ((1, 2), 160, ["supervised", "supervised_reg", "mt", "punet_val", "mt_val",
                                 "blocks", "jacobians", "fit"], False),
          "2x2": ((2, 2), 160, ["supervised", "mt", "punet_val", "mt_val", "blocks"], False),
          "1x4": ((1, 4), 288, ["supervised", "mt", "mt_val", "blocks"], False),
          "1x2-f64": ((1, 2), 160, ["supervised", "mt", "fixmatch", "fixmatch_val"], True)}
WIDTH = 64
SUPERVISED = ("supervised", "supervised_reg")
#: float64: the row-sharded step is the one-process step up to float64's
#: reassociation (float32's differences reach a few 1e-4 of a leaf where a
#: pre-activation within rounding of 0 takes the other side of a ReLU)
F64_TOL = 1e-10
BLOCK_H = 80  # the block check's image rows: 20 a shard at (1, 4), 10 at its second level


def batches(h: int, w: int, rng) -> dict:
    """The global batches of the train and validation cases (B images)."""
    x = rng.normal(size=(B, h, w, 1)).astype(np.float32)
    x1 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    x2 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    gt = (x > 0.5).astype(np.float32)
    t = torch.from_numpy
    return {"xy": (t(x), t(gt)), "dual": (t(x), t(x1), t(x2), t(gt))}


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_double(v) for v in tree)
    return tree.double()


def punet_spec(h: int, w: int, cases, noise=None, float64: bool = False) -> dict:
    """Weights (``pda``'s seeded small PUNet, the Fcomb scaled as
    ``tests/test_torch_parallel.py`` scales it: a consensus share inside (0,
    1)), global batches and noise, and the cases."""
    from pda_torch.models import state_dict_from_pda

    rng = np.random.default_rng(SEED)
    spec_batches = batches(h, w, rng)
    if noise is None:
        noise = {name: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for name, shape in (("eps_post", (B, LATENT)), ("eps_teacher", (MC, B, LATENT)),
                                     ("eps_weak", (MC, B, LATENT)), ("eps_mc", (MC, B, LATENT)),
                                     ("eps_mc8", (DW.N_MC_VAL, B, LATENT)))}
    if float64:
        spec_batches, noise = _double(spec_batches), _double(noise)
    return {"punet_cfg": dict(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3,
                              beta=1.0, rl_swap=True, consensus_masking=True),
            "punet_state": state_dict_from_pda(_pda_params()), "float64": float64,
            "batches": spec_batches, "noise": noise, "cases": list(cases)}


def _block_spec() -> dict:
    from pda_torch.models import blocks
    from pda_torch.models.punet import GaussianEncoder

    g = torch.Generator().manual_seed(11)
    mods = {"block": blocks.ConvBlock(SW.BLOCK_C, 4), "up_block": blocks.UpBlock(
        SW.BLOCK_C, SW.BLOCK_C, 4), "encoder": GaussianEncoder(SW.BLOCK_C, (4, 5), latent_dim=2)}
    out = {}
    for name, mod in mods.items():
        for p in mod.parameters():
            with torch.no_grad():
                p.copy_(0.5 * torch.randn(p.shape, generator=g))
        out[name] = {k: v.double() for k, v in mod.state_dict().items()}

    def image(h, w):
        return torch.randn(SW.BLOCK_B, h, w, SW.BLOCK_C, generator=g, dtype=torch.float64)

    return {**out, "x": image(BLOCK_H, SW.BLOCK_W), "up": image(BLOCK_H // 2, SW.BLOCK_W // 2),
            "skip": image(BLOCK_H, SW.BLOCK_W)}


@functools.lru_cache(maxsize=None)
def _spec(world: str) -> dict:
    _, h, cases, float64 = WORLDS[world]
    spec = punet_spec(h, WIDTH, cases, float64=float64)
    spec["blocks"] = _block_spec()
    spec["fit_patch"] = (h, WIDTH)
    return spec


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> each rank's results, one spawn a world."""
    return {world: SW.spawn(WORLDS[world][0], _spec(world), str(tmp_path_factory.mktemp(world)))
            for world in WORLDS}


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """world -> the single-process results on the global batch."""
    from torch_port_utils import numpy_augs

    with numpy_augs():
        return {world: SW.run_cases(_spec(world), None,
                                    root=str(tmp_path_factory.mktemp(f"one{world}")))
                for world in WORLDS}


TRAIN = [(w, c) for w, (_, _, cases, _) in WORLDS.items() for c in cases if c in DW.TRAIN]


@pytest.mark.parametrize("world,case", TRAIN, ids=[f"{c}-{w}" for w, c in TRAIN])
def test_row_sharded_train_step_matches_single_process(ranks, single, world, case):
    got, ref = ranks[world][0][case], single[world][case]
    f64 = WORLDS[world][3]
    for k, v in ref["aux"].items():
        _close(got["aux"][k], v, F64_TOL if f64 else 1e-5, f"aux {k}")
    bound = F64_TOL if f64 else 1e-5 if case in SUPERVISED else 1e-4
    for k, v in ref["params"].items():
        _close(got["params"][k], v, bound, f"param {k}")
    assert got["grads"].keys() == ref["grads"].keys()
    largest = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        err = float((got["grads"][k] - g).abs().max())
        tol = (F64_TOL if f64 else 1e-4) * max(float(g.abs().max()), 1e-3 * largest)
        assert err <= tol, f"grad {k}: {err:.3e}"
    for k, v in ref["teacher"].items():
        _close(got["teacher"][k], v, F64_TOL if f64 else 1e-4, f"teacher {k}")
    for part in ("params", "grads", "teacher"):
        _same_on_every_rank(ranks[world], case, part)


def test_l2_term_is_divided_by_the_world(ranks, single):
    """With the L2 term at weight 1 (it dominates the loss) the reported
    loss carries it whole and the gradients match: it enters the
    differentiated objective as ``reg / (N M)``; the summed gradients are
    not the ranks' mean."""
    got, ref = ranks["1x2"][0]["supervised_reg"], single["1x2"]["supervised_reg"]
    reg = ref["aux"]["loss"] - ref["aux"]["recon_loss"] - ref["aux"]["kl"]
    assert reg > 0.5 * ref["aux"]["loss"]
    _close(got["aux"]["loss"], ref["aux"]["loss"], 1e-5, "loss")
    gaps = [float((got["grads"][k] - g / 2).abs().max()) / max(float(g.abs().max()), 1e-12)
            for k, g in ref["grads"].items()]
    assert max(gaps) > 0.4


VAL = [(w, c) for w, (_, _, cases, _) in WORLDS.items() for c in cases if c in DW.VAL]


@pytest.mark.parametrize("world,case", VAL, ids=[f"{c}-{w}" for w, c in VAL])
def test_row_sharded_val_step_matches_single_process(ranks, single, world, case):
    ref = single[world][case]
    tol = F64_TOL if WORLDS[world][3] else 1e-4
    for res in ranks[world]:
        assert res[case].keys() == ref.keys()
        for k, v in ref.items():
            assert abs(res[case][k] - v) <= tol, (k, res[case][k], v)


def test_ranks_hold_their_grid_positions(ranks):
    """Global rank r is (r // M, r % M): the space neighbours are adjacent."""
    for world, results in ranks.items():
        n, m = WORLDS[world][0]
        for r, res in enumerate(results):
            assert res["mesh"]["shape"] == {"data": n, "space": m}
            assert res["mesh"]["index"] == (r // m, r % m)


BLOCK_ROUTES = [f"{r}{m}" for m in ("", "_mixed")
                for r in ("single", "with", "only", "dual", "upsample", "mean")]


BLOCK_WORLDS = [w for w, (_, _, cases, _) in WORLDS.items() if "blocks" in cases]


@pytest.mark.parametrize("world", BLOCK_WORLDS)
@pytest.mark.parametrize("route", BLOCK_ROUTES)
def test_row_sharded_block_is_the_whole_image_block(ranks, single, world, route):
    """Each rank's rows of every output and of its inputs' gradients are the
    whole image's (the first shard's top rows and the last's bottom rows are
    the image's edges), and its parameters' gradients summed over the space
    axis are the whole block's; the encoder's statistics are equal on every
    rank. float64, within 1e-12 of the largest."""
    m = WORLDS[world][0][1]
    ref = single[world]["blocks"][route]
    space_ranks = [ranks[world][r]["blocks"][route] for r in range(m)]  # data index 0
    for i, whole in enumerate(ref["out"]):
        if whole.ndim == 4:
            got = torch.cat([res["out"][i] for res in space_ranks], dim=1)
        else:
            got = space_ranks[0]["out"][i]
            for res in space_ranks[1:]:
                assert torch.equal(res["out"][i], got)
        _close(got, whole, 1e-12, f"{route} output {i}")
    for i, whole in enumerate(ref["inputs"]):
        if whole is None:
            assert all(res["inputs"][i] is None for res in space_ranks)
            continue
        _close(torch.cat([res["inputs"][i] for res in space_ranks], dim=1), whole, 1e-12,
               f"{route} input gradient {i}")
    for i, whole in enumerate(ref["params"]):
        if whole is None:
            continue
        _close(sum(res["params"][i] for res in space_ranks), whole, 1e-12,
               f"{route} parameter gradient {i}")


@pytest.mark.parametrize("what", ["halo", "mean"])
def test_exchange_jacobians_in_float64(ranks, what):
    for res in ranks["1x2"]:
        jac = res["jacobians"][what]
        assert jac["analytic"].abs().max() > 0.1
        torch.testing.assert_close(jac["analytic"], jac["numeric"], rtol=1e-7, atol=1e-7)


def test_trainer_fit_at_one_by_two(ranks, single):
    """``PUNetTrainer(mesh=(1, 2)).fit(4)`` against ``fit(4)`` in one
    process: parameters, losses and validations; rank 0 alone wrote the
    checkpoints and logged the panels, of whole images."""
    got, ref = [r["fit"] for r in ranks["1x2"]], single["1x2"]["fit"]
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
    assert got[1]["writes"] == [] and got[1]["panels"] == []
    assert got[0]["panels"] == ref["panels"] and len(ref["panels"]) >= 3
    assert {kind for kind, _ in ref["panels"]} == {"log_train", "log_validation"}


# -- refusals -------------------------------------------------------------------


def _pda_support_note(model, patch, val_patch, shape) -> str:
    """What ``pda``'s trainer prints where its halo path cannot serve: its
    ``_check_spatial_support`` on a (data, space) mesh of the CPU devices."""
    from pda.parallel import get_mesh_2d
    from pda.train.engine import Trainer

    t = object.__new__(Trainer)
    t.mesh = get_mesh_2d(*shape)
    t.model = model
    t.val_loader = [(np.zeros((1, *val_patch, 1), np.float32),)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t._check_spatial_support((np.zeros((1, *patch, 1), np.float32),))
    assert t._force_gspmd
    return out.getvalue()


def _fake_2d(shape=(1, 2), rank=0):
    from pda_torch.parallel import Mesh

    n, m = shape
    return Mesh(None, n * m, rank, torch.device("cpu"), "gloo", shape={"data": n, "space": m})


@pytest.mark.parametrize("patch,val_patch", [((64, 64), (160, 64)), ((160, 64), (48, 64)),
                                             ((168, 64), (160, 64))],
                         ids=["train-rows", "val-rows", "indivisible"])
def test_trainer_refuses_what_pdas_halo_path_refuses(patch, val_patch):
    """Where ``pda`` falls back to GSPMD the port raises with ``pda``'s
    reason, at set-up, before any collective; the validation loader's
    epoch is where it was."""
    from pda.models import ProbabilisticUnet as PdaPUNet
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.train import PUNetTrainer

    note = _pda_support_note(PdaPUNet(num_filters=FILTERS), patch, val_patch, (1, 2))
    reason = note.split(" — ", 1)[1].split("; the fused kernels", 1)[0]
    x = np.zeros((2, *patch, 1), np.float32)
    val = [(np.zeros((2, *val_patch, 1), np.float32),) * 2]
    model = ProbabilisticUnet(num_filters=FILTERS)
    trainer = PUNetTrainer("refused", model, [(x, x)], val, device="cpu", mesh=_fake_2d(),
                           logger=False)
    with pytest.raises(ValueError) as err:
        trainer.fit(1)
    assert reason in str(err.value) and "(data, space=2) mesh" in str(err.value)


def test_unet_refuses_row_sharding():
    """``UNet2d`` on a (data, space) mesh: the trainer refuses it as ``pda``
    falls back for it ("has no halo-exchange path"), and its forward under
    the row sharding raises ``pda``'s reason."""
    from pda.models import UNet2d as PdaUNet
    from pda_torch.models import UNet2d
    from pda_torch.models.blocks import space_sharding
    from pda_torch.models.unet import UNET_SPACE_REFUSAL
    from pda_torch.parallel import Mesh
    from pda_torch.train import UNetTrainer

    note = _pda_support_note(PdaUNet(depth=2, initial_features=4), (160, 64), (160, 64), (1, 2))
    assert "UNet2d has no halo-exchange path" in note
    model = UNet2d(depth=2, initial_features=4)
    x = np.zeros((2, 160, 64, 1), np.float32)
    trainer = UNetTrainer("refused", model, [(x, x)], [], device="cpu", mesh=_fake_2d(),
                          logger=False)
    with pytest.raises(ValueError, match="UNet2d has no halo-exchange path"):
        trainer.fit(1)
    with space_sharding(Mesh(None, 2, 0, torch.device("cpu"), "gloo")):
        with pytest.raises(ValueError) as err:
            model(torch.zeros(1, 16, 16, 1))
    assert str(err.value) == UNET_SPACE_REFUSAL
    assert UNET_SPACE_REFUSAL.startswith("UNet2d has no halo-exchange path (its half-pixel "
                                         "bilinear upsample and 2-conv blocks are not row-shard "
                                         "aware)")


def test_blocks_refuse_short_row_shards_and_other_depths():
    """Under the row sharding over 2 ranks a 3-conv block refuses a shard of
    fewer than 9 rows with ``pda``'s message (before any exchange), and a
    block of 2 convs refuses the sharding (``pda``'s assertion)."""
    from pda_torch.models import blocks
    from pda_torch.parallel import Mesh

    space = Mesh(None, 2, 0, torch.device("cpu"), "gloo")
    block = blocks.ConvBlock(1, 4)
    with blocks.space_sharding(space):
        with pytest.raises(ValueError) as err:
            block(torch.zeros(1, 8, 16, 1))
        assert str(err.value) == ("row shards of 8 rows are too small for the boundary fix "
                                  "(need >= 9); use fewer 'space' shards or larger images")
        with pytest.raises(ValueError, match="space sharding supports the 3-conv blocks only"):
            blocks.ConvBlock(1, 4, n_convs=2)(torch.zeros(1, 16, 16, 1))


def test_shard_batch_and_loader_cut_image_rows():
    """On a (data, space) mesh ``shard_batch`` and a ``Loader`` shard hand
    each rank its batch rows and its row shard of each image; a height the
    space axis does not divide raises with ``pda``'s message."""
    from pda.parallel import get_mesh_2d as jget_mesh_2d
    from pda.parallel import shard_batch as jshard_batch
    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.parallel import shard_batch

    x = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2, 1)
    for r in range(4):
        rows, flat = shard_batch(_fake_2d((2, 2), r), (x, np.arange(4)))
        np.testing.assert_array_equal(rows, x[2 * (r // 2):2 * (r // 2) + 2,
                                              3 * (r % 2):3 * (r % 2) + 3])
        np.testing.assert_array_equal(flat, np.arange(4)[2 * (r // 2):2 * (r // 2) + 2])
    odd = np.zeros((2, 5, 2, 1), np.float32)
    with pytest.raises(ValueError) as ref:
        jshard_batch(jget_mesh_2d(1, 2), (odd,))
    with pytest.raises(ValueError) as got:
        shard_batch(_fake_2d(), (odd,))
    assert str(got.value) == str(ref.value)

    raws, labels = make_dataset_arrays(2, (48, 48), seed=1)
    ds = ImageCollectionDataset(raws, labels, patch_shape=(16, 16), n_samples=8, seed=2,
                                raw_transform=None)
    whole = list(Loader(ds, 4, seed=3))
    for d in range(2):
        parts = []
        for s in range(2):
            ld = Loader(ds, 4, seed=3)
            ld.set_shard(d, 2, space=(s, 2))
            parts.append(list(ld))
        for i, batch in enumerate(whole):
            for f in range(2):
                np.testing.assert_array_equal(
                    np.concatenate([parts[0][i][f], parts[1][i][f]], axis=1),
                    batch[f][2 * d:2 * d + 2])
    ld = Loader(ds, 4, seed=3)
    ld.set_shard(0, 1, space=(0, 3))
    with pytest.raises(ValueError, match="image height 16 is not divisible by the mesh's "
                                         "'space' axis \\(3\\)"):
        next(iter(ld))


def test_mesh_from_arg_gives_the_two_d_mesh(monkeypatch):
    """``--mesh data=1,space=2`` in a launcher's world of 2 asks for the
    (1, 2) mesh on the CLI's device (recorded here in place of a process
    group); without a launcher it raises with the launch line, before any
    group is made."""
    import torch.distributed as dist

    from pda_torch import parallel
    from pda_torch.experiments.common import mesh_from_arg, standard_parser

    parser = standard_parser("mesh")
    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 2 -m pda_torch\.experiments"
                                         r"\.<cli> --mesh data=1,space=2"):
        mesh_from_arg(parser.parse_args(["--mesh", "data=1,space=2"]), "cpu")
    assert not dist.is_initialized()
    asked = []
    monkeypatch.setattr(parallel, "get_mesh_2d",
                        lambda n, m, **kw: asked.append((n, m, kw)) or _fake_2d((n, m)))
    mesh = mesh_from_arg(argparse.Namespace(mesh="data=1,space=2"), "cpu")
    assert asked == [(1, 2, {"device": "cpu"})] and mesh.shape == {"data": 1, "space": 2}


def test_world_of_one_two_d_mesh_is_bit_equal_to_no_mesh():
    """A (1, 1) mesh in this process (gloo, its groups of one rank): the
    supervised and Mean-Teacher steps bit-equal to no mesh."""
    from pda_torch.parallel import get_mesh_2d

    spec = punet_spec(32, 32, ["supervised", "mt", "mt_val"])
    mesh = get_mesh_2d(1, 1, device="cpu")
    try:
        assert (mesh.shape, mesh.space.world, mesh.axis("data").world) == (
            {"data": 1, "space": 1}, 1, 1)
        meshed, plain = SW.run_cases(spec, mesh), SW.run_cases(spec, None)
    finally:
        mesh.destroy()
    for case in spec["cases"]:
        got, ref = meshed[case], plain[case]
        for part in (ref if isinstance(ref, dict) else {}):
            if isinstance(ref[part], dict):
                for k in ref[part]:
                    a, b = got[part][k], ref[part][k]
                    assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, (case, k)
            else:
                assert got[part] == ref[part], (case, part)


def test_dp_check_on_a_space_mesh_matches_one_process():
    """``dp_check --space 2`` on the CPU (144^2, PUNet (4, 8, 12, 16)): two
    gloo ranks of a (1, 2) mesh against one process within its bounds, and
    each rank's halo exchanges a step counted (forward and backward)."""
    from pda_torch.tools import dp_check
    from test_torch_dev_tools import _run

    rc, res, out = _run("dp_check", "--hw", "144", "--filters", "4,8,12,16", "--world", "2",
                        "--space", "2")
    assert rc == 0 and res["ok"], out
    assert res["mesh"] == {"data": 1, "space": 2}
    for name in ("f32", "bf16"):
        assert all(res[name]["passed"].values()), res[name]
        halos = res[name]["halo"]
        assert halos[0]["exchanges"] == halos[1]["exchanges"] > 0
    assert res["f32"]["leaf"] <= dp_check.SPACE_F32_LEAF_TOL
    assert 1.0 - res["f32"]["cos"] <= dp_check.COS_TOL
    assert abs(res["f32"]["norm_ratio"] - 1.0) <= dp_check.F32_NORM_TOL
