"""The data-parallel cases of ``tests/test_torch_parallel.py``, run alike by
the test process with ``mesh=None`` (the single-process reference on the
global batch) and by each rank of a gloo world spawned on the CPU
(:func:`rank_main`), which keeps its rows of every batch.

This module imports torch, numpy and ``pda_torch`` only, so a spawned rank
starts without JAX. Every input (weights, global batches, global noise)
comes from the test process in one ``spec`` file; each case returns
tensors and floats that the test compares.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import os

import torch

N_MC_VAL = 8
SGD_LR = 1e-2
ADAM_LR = 1e-3
MOMENTUM = 0.999
SOURCE = (0.7, 0.3)  # FixMatch's source distribution [bg, fg]

#: train-step case -> (step factory, its keywords, batch key, noise keys, model, teacher)
TRAIN = {
    "supervised": ("make_supervised_punet_step", {}, "xy", ("eps_post",), "punet", False),
    "supervised_reg": ("make_supervised_punet_step", {}, "xy", ("eps_post",), "punet", False),
    "pseudo_punet": ("make_pseudo_punet_step", {}, "xyz", ("eps_post",), "punet", False),
    "mt": ("make_mean_teacher_step", {"momentum": MOMENTUM, "do_consensus_masking": True},
           "dual", ("eps_teacher", "eps_post"), "punet", True),
    "fixmatch": ("make_fixmatch_step", {"source_distribution": SOURCE,
                                        "do_consensus_masking": True},
                 "dual", ("eps_weak", "eps_post"), "punet", False),
    "adamt": ("make_adamt_step", {"momentum": MOMENTUM, "do_consensus_masking": True},
              "joint", ("eps_source", "eps_teacher", "eps_post"), "punet", True),
    "adamatch": ("make_adamatch_step", {"do_consensus_masking": True},
                 "joint", ("eps_source", "eps_weak", "eps_post"), "punet", False),
    "unet": ("make_supervised_unet_step", {}, "xy", (), "unet", False),
    "pseudo_unet": ("make_pseudo_unet_step", {}, "xyz", (), "unet", False),
}
#: validation case -> (step factory, its keywords, batch key, noise keys, model, teacher)
VAL = {
    "punet_val": ("make_punet_val_step", {}, "xy", ("eps_post", "eps_mc8"), "punet", False),
    "pseudo_punet_val": ("make_pseudo_punet_val_step", {}, "xyz", ("eps_post", "eps_mc8"),
                         "punet", False),
    "mt_val": ("make_mean_teacher_val_step", {"do_consensus_masking": True}, "dual",
               ("eps_teacher", "eps_post", "eps_mc"), "punet", True),
    "fixmatch_val": ("make_fixmatch_val_step", {"do_consensus_masking": True}, "dual",
                     ("eps_weak", "eps_post", "eps_mc"), "punet", False),
    "adamt_val": ("make_adamt_val_step", {"do_consensus_masking": True}, "target",
                  ("eps_teacher", "eps_post", "eps_mc"), "punet", True),
    "adamatch_val": ("make_adamatch_val_step", {"do_consensus_masking": True}, "target",
                     ("eps_weak", "eps_post", "eps_mc"), "punet", False),
    "unet_val": ("make_supervised_unet_val_step", {}, "xy", (), "unet", False),
    "pseudo_unet_val": ("make_pseudo_unet_val_step", {}, "xyz", (), "unet", False),
}
#: the noise names of the spec -> the step's keyword
NOISE_KW = {"eps_mc8": "eps_mc"}


def build_model(spec, kind: str):
    """The spec's model of ``kind``, in float64 where ``spec["float64"]``,
    computing in bf16 where ``spec["bf16"]``."""
    from pda_torch.models import ProbabilisticUnet, UNet2d

    if kind == "punet":
        model = ProbabilisticUnet(**spec["punet_cfg"])
        model.load_state_dict(spec["punet_state"])
    else:
        model = UNet2d(**spec["unet_cfg"])
        model.load_state_dict(spec["unet_state"])
    if spec.get("bf16"):
        model.dtype = torch.bfloat16
    return model.double() if spec.get("float64") else model


def _local(batch, mesh):
    from pda_torch.parallel import shard_batch

    return tuple(batch) if mesh is None else shard_batch(mesh, batch)


def _noise(spec, keys) -> dict:
    return {NOISE_KW.get(k, k): spec["noise"][k] for k in keys}


@contextlib.contextmanager
def _reg_weight(case: str):
    """``supervised_reg`` runs with the L2 term's weight at 1, so that the
    term's share of the gradient is seen (its division by the rank count)."""
    from pda_torch.train import steps

    old = steps.REG_WEIGHT
    if case == "supervised_reg":
        steps.REG_WEIGHT = 1.0
    try:
        yield
    finally:
        steps.REG_WEIGHT = old


def _named(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def train_case(case: str, spec, mesh=None, adam: bool = False) -> dict:
    """One train step from the spec's weights: aux, the parameters after the
    step, the (summed) gradients, the teacher. SGD (a step is lr * the
    gradient, so the parameters pin the summed gradient's scale), or with
    ``adam`` the port's Adam at ``ADAM_LR`` (``pda``'s test's)."""
    from pda_torch.train import adam as port_adam
    from pda_torch.train import create_train_state, steps

    factory, kw, batch, noise, kind, teacher = TRAIN[case]
    model = build_model(spec, kind)
    opt = (port_adam(model.parameters(), ADAM_LR) if adam
           else torch.optim.SGD(model.parameters(), lr=SGD_LR))
    state = create_train_state(model, opt, with_teacher=teacher)
    step = getattr(steps, factory)(mesh=mesh, **kw)
    with _reg_weight(case):
        _, aux = step(state, *_local(spec["batches"][batch], mesh), **_noise(spec, noise))
    return {"aux": {k: float(v) for k, v in aux.items()},
            "params": _named(state.model),
            "grads": {n: p.grad.detach().clone() for n, p in state.model.named_parameters()
                      if p.grad is not None},
            "teacher": _named(state.teacher) if teacher else {}}


def val_case(case: str, spec, mesh=None) -> dict:
    from pda_torch.train import create_train_state, steps

    factory, kw, batch, noise, kind, teacher = VAL[case]
    model = build_model(spec, kind)
    state = create_train_state(model, torch.optim.SGD(model.parameters(), lr=SGD_LR),
                               with_teacher=teacher)
    step = getattr(steps, factory)(mesh=mesh, **kw)
    _, metrics = step(state, *_local(spec["batches"][batch], mesh), **_noise(spec, noise))
    return {k: float(v) for k, v in metrics.items()}


def tiles_case(spec, mesh=None) -> dict:
    """``tiled_punet_probs`` of each spec frame with its global noise, padded
    on a mesh (without one, the noise of the frame's tiles)."""
    from pda_torch.infer.predict import tiled_punet_probs
    from pda_torch.infer.tiling import grid_shape

    model = build_model(spec, "punet")
    out = {}
    for name, (image, eps, n, block, halo) in spec["tiles"].items():
        if mesh is None:
            gy, gx = grid_shape(image.shape[:2], block)
            eps = eps[:, :gy * gx]
        out[name] = tiled_punet_probs(model, image, eps, n, block, halo, mesh=mesh)
    return out


def prediction_case(spec, root: str, mesh=None) -> dict:
    """``punet_prediction(mesh=)`` of the spec's frames, written as TIFFs to
    a folder of this rank's, into one output folder shared by the ranks.
    The noise of each frame is the spec's (``pda``'s draw, padded on a
    mesh), handed to ``tiled_punet_probs`` in place of the port's draw,
    which must have its shape. Records the files this process wrote."""
    from pda_torch.data.tiff import write_image
    from pda_torch.infer import predict

    p = spec["prediction"]
    in_dir = os.path.join(root, f"prediction_in{'' if mesh is None else mesh.rank}")
    os.makedirs(in_dir, exist_ok=True)
    for name, image in p["frames"].items():
        write_image(os.path.join(in_dir, f"{name}.tif"), image.numpy())
    noise, writes = iter(p["eps"]), []
    tiled, write = predict.tiled_punet_probs, predict._write_tiff

    def given_noise(model, image, eps, *args, **kw):
        given = next(noise)
        if mesh is None:
            given = given[:, :eps.shape[1]]
        assert eps.shape == given.shape, (eps.shape, given.shape)
        return tiled(model, image, given.to(eps.device), *args, **kw)

    predict.tiled_punet_probs = given_noise
    predict._write_tiff = lambda path, data: writes.append(os.path.basename(path)) or write(
        path, data)
    out_dir = os.path.join(root, "prediction")
    try:
        predict.punet_prediction(os.path.join(in_dir, "*.tif"), out_dir,
                                 build_model(spec, "punet"), prior_samples=p["n"],
                                 block_shape=p["block"], halo=p["halo"], verbose=False,
                                 mesh=mesh)
    finally:
        predict.tiled_punet_probs, predict._write_tiff = tiled, write
    return {"writes": writes, "in_dir": in_dir, "out_dir": out_dir, "returned": True}


def val_batch_1_case(spec, root: str, mesh) -> dict:
    """A trainer shaped as the CLIs build it (validation at batch 1) on a
    mesh of more than one rank: the refusal it raises, or None."""
    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.train import PUNetTrainer

    raws, labels = make_dataset_arrays(2, (64, 64), seed=3)
    ds = ImageCollectionDataset(raws, labels, patch_shape=(32, 32), n_samples=4, seed=1)
    model = build_model(spec, "punet")
    trainer = PUNetTrainer("dp-val1", model, Loader(ds, 2, seed=0), Loader(ds, 1, seed=1),
                           optimizer=torch.optim.SGD(model.parameters(), lr=SGD_LR),
                           device="cpu", mesh=mesh, save_root=root, seed=5)
    try:
        trainer.fit(2)
    except ValueError as e:
        return {"refused": str(e), "steps": len(trainer.history)}
    return {"refused": None, "steps": len(trainer.history)}


def fit_case(spec, root: str, mesh=None) -> dict:
    """``PUNetTrainer(mesh=).fit(4)`` on seeded synthetic patches (global
    batch 4, validation batch 2, SGD, panels every 2 steps), counting the
    checkpoint writes of this process."""
    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.train import PUNetTrainer, engine

    raws, labels = make_dataset_arrays(4, (64, 64), seed=3)

    def loader(k, batch, seed):
        ds = ImageCollectionDataset(raws[:k], labels[:k], patch_shape=(32, 32), n_samples=8,
                                    seed=k)
        return Loader(ds, batch, seed=seed)

    writes = []
    save = engine.save_checkpoint
    engine.save_checkpoint = lambda *a, **k: writes.append(k.get("which")) or save(*a, **k)
    try:
        model = build_model(spec, "punet")
        trainer = PUNetTrainer("dp-fit", model, loader(4, 4, 0), loader(2, 2, 1),
                               optimizer=torch.optim.SGD(model.parameters(), lr=SGD_LR),
                               device="cpu", mesh=mesh, save_root=root, log_image_interval=2,
                               seed=5)
        trainer.fit(4)
    finally:
        engine.save_checkpoint = save
    return {"params": _named(trainer.state.model), "writes": writes,
            "logger": trainer.logger is not None,
            "loss": [h["loss"] for _, h in trainer.history],
            "val": [v for _, v in trainer.val_history]}


def run_cases(spec, mesh=None, root=None) -> dict:
    out = {}
    for case in spec["cases"]:
        if case in TRAIN:
            out[case] = train_case(case, spec, mesh)
        elif case in VAL:
            out[case] = val_case(case, spec, mesh)
        elif case == "mt_adam":
            out[case] = train_case("mt", spec, mesh, adam=True)
        elif case == "tiles":
            out[case] = tiles_case(spec, mesh)
        elif case == "prediction":
            out[case] = prediction_case(spec, root, mesh)
        elif case == "fit":
            out[case] = fit_case(spec, os.path.join(root, "fit"), mesh)
        elif case == "val_batch_1":
            out[case] = (None if mesh is None
                         else val_batch_1_case(spec, os.path.join(root, "val1"), mesh))
        else:
            raise KeyError(case)
    return out


def rank_main(rank: int, world: int, store_path: str, spec_path: str, out_dir: str) -> None:
    """One rank of a gloo world on the CPU: every case of the spec on this
    rank's rows, the results saved as ``rank<r>.pt``."""
    import torch.distributed as dist

    from pda_torch.parallel import get_mesh

    os.environ["PDA_NATIVE_AUGS"] = "0"
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    mesh = get_mesh(world, device="cpu", rank=rank, world_size=world,
                    store=dist.FileStore(store_path, world))
    try:
        out = run_cases(spec, mesh, root=out_dir)
        out["fit_root"] = os.path.join(out_dir, "fit")
        out["mesh"] = {"world": mesh.world, "rank": mesh.rank, "backend": mesh.backend}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy()


def event_files(root: str) -> list:
    return sorted(glob.glob(os.path.join(root, "**", "events.out.tfevents.*"), recursive=True))


def spawn(world: int, spec: dict, tmp: str) -> list:
    """Every case of ``spec`` on a gloo world of ``world`` ranks (spawned
    processes, ``OMP_NUM_THREADS=2``): each rank's results."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(spec, spec_path)
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        mp.spawn(rank_main, args=(world, os.path.join(tmp, "store"), spec_path, tmp),
                 nprocs=world, join=True)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def copy_spec(spec: dict, cases) -> dict:
    out = copy.copy(spec)
    out["cases"] = list(cases)
    return out

