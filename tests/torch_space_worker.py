"""The (data, space) mesh's cases of ``tests/test_torch_space*.py``, run
alike by the test process with ``mesh=None`` (one process on the global
batch) and by each rank of a gloo world of N x M ranks spawned on the CPU
(:func:`rank_main`), which keeps its rows of every batch and its row shard
of every image.

Like ``tests/torch_dp_worker.py``, whose train, validation and tile cases
it runs, this module imports torch, numpy and ``pda_torch`` only, so a
spawned rank starts without JAX; every input comes from the test process
in one ``spec`` file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import torch_dp_worker as W

#: the blocks' check: batch, width and channels of its inputs, in float64
BLOCK_B, BLOCK_W, BLOCK_C = 2, 6, 3


def cotangent(y: torch.Tensor, row0: int) -> torch.Tensor:
    """A fixed cotangent of an NHWC output whose first row is the image's
    row ``row0``: a function of the global position, so that a row shard's
    is the whole image's rows."""
    b, h, w, c = y.shape
    grid = [torch.arange(n, dtype=y.dtype) for n in (b, h, w, c)]
    grid[1] = grid[1] + row0
    bb, hh, ww, cc = torch.meshgrid(*grid, indexing="ij")
    return torch.sin(0.3 * bb + 0.37 * hh + 0.11 * ww + 0.7 * cc)


def _blocks(spec, mesh) -> dict:
    """Every route of a 3-conv block (single, pooled "with" and "only",
    dual, each also in the mixed mode), the align-corners upsample and the
    encoders' spatial mean, on this rank's row shard of ``spec["blocks"]``'s
    float64 images under the row sharding (without a mesh: on the whole
    images): the outputs, and the gradients of ``sum(output * cotangent)``
    (of ``sum(output * w) / M`` for the encoder's replicated statistics)
    for the inputs and the parameters."""
    from pda_torch.models import blocks
    from pda_torch.models.punet import GaussianEncoder

    imgs = {k: spec["blocks"][k] for k in ("x", "up", "skip")}
    space = None if mesh is None else mesh.space
    n = 1 if space is None else space.world
    if mesh is not None:
        imgs = {k: v[:, mesh.image_rows(v.shape[1])] for k, v in imgs.items()}
    block = blocks.ConvBlock(BLOCK_C, 4).double()
    block.load_state_dict(spec["blocks"]["block"])
    upb = blocks.UpBlock(BLOCK_C, BLOCK_C, 4).double()
    upb.load_state_dict(spec["blocks"]["up_block"])
    enc = GaussianEncoder(BLOCK_C, (4, 5), latent_dim=2).double()
    enc.load_state_dict(spec["blocks"]["encoder"])
    s = 0 if space is None else space.rank
    out = {}
    for mixed in (False, True):
        os.environ["PDA_PALLAS_CONV_MODE"] = "mixed" if mixed else "full"
        for route in ("single", "with", "only", "dual", "upsample", "mean"):
            x, up_in, skip = (imgs[k].clone().requires_grad_() for k in ("x", "up", "skip"))
            params = [*block.parameters(), *upb.parameters(), *enc.parameters()]
            for p in params:
                p.grad = None
            with blocks.space_sharding(space):
                if route == "single":
                    ys = [block(x)]
                elif route in ("with", "only"):
                    got = block(x, pool_out=route)
                    ys = list(got) if route == "with" else [got]
                elif route == "dual":
                    ys = [upb(up_in, skip)]
                elif route == "upsample":
                    ys = [blocks.upsample_2x_align_corners_rows(up_in, space)]
                else:
                    ys = list(enc(x))
            loss = sum((y * cotangent(y, s * y.shape[1])).sum() if y.ndim == 4
                       else (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum() / n
                       for y in ys)
            loss.backward()
            out[f"{route}{'_mixed' if mixed else ''}"] = {
                "out": [y.detach() for y in ys],
                "inputs": [t.grad for t in (x, up_in, skip)],
                "params": [p.grad.clone() if p.grad is not None else None for p in params]}
    os.environ.pop("PDA_PALLAS_CONV_MODE", None)
    return out


def _exchange_jacobians(mesh) -> dict:
    """The Jacobians of the halo exchange (``halo_rows``, 4 rows) and of
    the space mean over the whole world's input, float64: analytic (each
    output element's one-hot cotangent, every rank backpropagating its part,
    the inputs' gradients summed over the ranks) and by central differences
    (every rank perturbing the same element of one global input)."""
    from pda_torch.parallel.space import halo_rows, space_mean

    space = mesh.space
    g = torch.Generator().manual_seed(1)
    cases = {"halo": (torch.randn(1, 6 * space.world, 3, 2, generator=g, dtype=torch.float64),
                      lambda t: halo_rows([t], 4, space)[0][0], True),
             "mean": (torch.randn(space.world, 2, 3, generator=g, dtype=torch.float64),
                      lambda t: space_mean(t, space), False)}
    out = {}
    for name, (xg, fn, rows) in cases.items():
        def local(t):
            return t[:, mesh.image_rows(t.shape[1])] if rows else t[space.rank]

        def global_out(t):
            with torch.no_grad():
                return space.all_gather(fn(local(t)).reshape(-1))

        n_out = global_out(xg).numel()
        numeric = torch.zeros(n_out, xg.numel(), dtype=torch.float64)
        for j in range(xg.numel()):
            step = torch.zeros(xg.numel(), dtype=torch.float64)
            step[j] = 1e-6
            step = step.view_as(xg)
            numeric[:, j] = (global_out(xg + step) - global_out(xg - step)) / 2e-6
        analytic = torch.zeros_like(numeric)
        mine = None
        for i in range(n_out):
            x = xg.clone().requires_grad_()
            y = fn(local(x)).reshape(-1)
            if mine is None:  # this rank's block of the gathered output
                counts = space.all_gather(torch.tensor([y.numel()]))
                start = int(counts[:space.rank].sum())
                mine = slice(start, start + y.numel())
            cot = torch.zeros(n_out, dtype=torch.float64)
            cot[i] = 1.0
            y.backward(cot[mine])
            analytic[i] = space.all_reduce(x.grad.reshape(-1))
        out[name] = {"numeric": numeric, "analytic": analytic}
    return out


def _fit(spec, root: str, mesh=None) -> dict:
    """``PUNetTrainer(mesh=).fit(4)`` on seeded synthetic patches of the
    spec's height (global batch 4, validation batch 2, SGD, panels every 2
    steps): the parameters, the losses, the validations, this process's
    checkpoint writes and the train panels' shapes it logged."""
    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.train import PUNetTrainer, engine

    h, w = spec["fit_patch"]
    raws, labels = make_dataset_arrays(4, (h + 32, w + 32), seed=3)

    def loader(k, batch, seed):
        ds = ImageCollectionDataset(raws[:k], labels[:k], patch_shape=(h, w), n_samples=8,
                                    seed=k)
        return Loader(ds, batch, seed=seed)

    writes, panels = [], []
    save = engine.save_checkpoint
    logs = {k: getattr(engine.TrainLogger, k) for k in ("log_train", "log_validation")}
    engine.save_checkpoint = lambda *a, **k: writes.append(k.get("which")) or save(*a, **k)

    def recorded(name):
        def log(self, step, scalars, images=None):
            if images:
                panels.append((name, {k: tuple(np.shape(v)) for k, v in images.items()}))
            return logs[name](self, step, scalars, images)
        return log

    for name in logs:
        setattr(engine.TrainLogger, name, recorded(name))
    try:
        model = W.build_model(spec, "punet")
        trainer = PUNetTrainer("space-fit", model, loader(4, 4, 0), loader(2, 2, 1),
                               optimizer=torch.optim.SGD(model.parameters(), lr=W.SGD_LR),
                               device="cpu", mesh=mesh, save_root=root, log_image_interval=2,
                               seed=5)
        trainer.fit(4)
    finally:
        engine.save_checkpoint = save
        for name, log in logs.items():
            setattr(engine.TrainLogger, name, log)
    return {"params": W._named(trainer.state.model), "writes": writes, "panels": panels,
            "loss": [h["loss"] for _, h in trainer.history],
            "val": [v for _, v in trainer.val_history]}


def run_cases(spec, mesh=None, root=None) -> dict:
    out = {}
    dp = [c for c in spec["cases"] if c in W.TRAIN or c in W.VAL or c in ("mt_adam", "tiles")]
    if dp:
        out.update(W.run_cases(W.copy_spec(spec, dp), mesh, root))
    for case in spec["cases"]:
        if case == "blocks":
            out[case] = _blocks(spec, mesh)
        elif case == "jacobians":
            out[case] = None if mesh is None else _exchange_jacobians(mesh)
        elif case == "fit":
            out[case] = _fit(spec, os.path.join(root, "fit"), mesh)
        elif case not in out:
            raise KeyError(case)
    return out


def rank_main(rank: int, shape: tuple, store_path: str, spec_path: str, out_dir: str) -> None:
    """One rank of a gloo (data, space) world on the CPU: every case of the
    spec, the results saved as ``rank<r>.pt``."""
    import torch.distributed as dist

    from pda_torch.parallel import get_mesh_2d

    os.environ["PDA_NATIVE_AUGS"] = "0"
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    world = shape[0] * shape[1]
    mesh = get_mesh_2d(*shape, device="cpu", rank=rank, world_size=world,
                       store=dist.FileStore(store_path, world))
    try:
        out = run_cases(spec, mesh, root=out_dir)
        out["fit_root"] = os.path.join(out_dir, "fit")
        out["mesh"] = {"shape": dict(mesh.shape), "rank": mesh.rank,
                       "index": (mesh.data_index, mesh.space_index)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy()


def spawn(shape: tuple, spec: dict, tmp: str) -> list:
    """Every case of ``spec`` on a gloo world of ``shape`` = (N, M) ranks
    (spawned processes, ``OMP_NUM_THREADS=1``): each rank's results."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(spec, spec_path)
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        mp.spawn(rank_main, args=(tuple(shape), os.path.join(tmp, "store"), spec_path, tmp),
                 nprocs=world, join=True)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
