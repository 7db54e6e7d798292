"""The whole pipeline on synthetic data, with a dice floor (``pda``'s
``development/e2e_drive.py``).

    python -m pda_torch.tools.e2e_drive [--root DIR] [--device cuda|cpu]

Six 64^2 frames of ``pda_torch/data/synthetic.py`` (seed 0) written as TIFFs
by the port's own codec (``pda_torch/data/tiff.py``), then: a PUNet (4, 8,
12, 16), latent 6, Fcomb 3, rl_swap, trained 150 steps by
``PUNetTrainer`` (batch 2, Adam 1e-3, a validation an epoch) with its
``best.pt``, ``latest.pt`` and logs; a ``MeanTeacherTrainer`` warm-started
from that checkpoint, 4 steps; tiled MC-4 prediction of every frame from the
best weights (64^2 blocks, 8-pixel halo); the pseudo-label and consensus
export (annotations and consensus trees, the consensus in {0, 1}); the dice
runner on the predictions, which must reach :data:`DICE_FLOOR`. On the card
these widths run the float32 kernels (their ``mma.sync`` bodies; the
``wgmma`` bodies are bf16's). Each stage raises on a fault; the last line
gives the dice, the seconds and the card. ``--root`` (default: a new
temporary folder, removed after) holds the tree.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from . import ab
from .common import add_device_arg, card, tool_device

FILTERS = (4, 8, 12, 16)
N_FRAMES, HW, STEPS, MT_STEPS, MC = 6, 64, 150, 4, 4
DICE_FLOOR = 0.5


def punet():
    from ..models import ProbabilisticUnet

    return ProbabilisticUnet(input_channels=1, num_classes=1, num_filters=FILTERS, latent_dim=6,
                             no_convs_fcomb=3, beta=1.0, rl_swap=True)


def write_frames(root: str):
    """The frames and their labels as TIFFs: (image folder, label folder, image
    paths, label paths)."""
    from ..data.synthetic import make_dataset_arrays
    from ..data.tiff import imwrite

    raws, labels = make_dataset_arrays(N_FRAMES, (HW, HW), seed=0)
    img_dir, lab_dir = os.path.join(root, "img"), os.path.join(root, "lab")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    ipaths, lpaths = [], []
    for i, (r, lab) in enumerate(zip(raws, labels)):
        ipaths.append(os.path.join(img_dir, f"im{i}.tif"))
        lpaths.append(os.path.join(lab_dir, f"im{i}.tif"))
        imwrite(ipaths[-1], r.astype(np.float32))
        imwrite(lpaths[-1], lab.astype(np.uint8))
    return img_dir, lab_dir, ipaths, lpaths


def drive(root: str, dev) -> dict:
    """Every stage in ``root``; returns the dice and the stages' seconds."""
    from ..data import (AdditiveGaussianNoise, Compose, DualImageCollectionDataset,
                        ImageCollectionDataset, Loader, standardize)
    from ..data.tiff import imread
    from ..eval import run_dice_evaluation
    from ..infer import punet_prediction, punet_pseudo_prediction
    from ..train import MeanTeacherTrainer, PUNetTrainer, checkpoint_dir, load_params

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    img_dir, lab_dir, ipaths, lpaths = write_frames(root)
    save_root = os.path.join(root, "runs")
    ds = ImageCollectionDataset(ipaths, lpaths, patch_shape=(HW, HW))
    loader = Loader(ds, batch_size=2, num_workers=0, shuffle=True, seed=0)
    tr = PUNetTrainer("src", punet(), loader, loader, save_root=save_root, learning_rate=1e-3,
                      device=dev)
    tr.fit(STEPS)
    ckpt = checkpoint_dir("src", save_root)
    for name in ("best.pt", "latest.pt"):
        if not os.path.exists(os.path.join(ckpt, name)):
            raise RuntimeError(f"e2e_drive: the source run wrote no {name}")
    if not glob.glob(os.path.join(save_root, "logs", "**", "*"), recursive=True):
        raise RuntimeError("e2e_drive: the source run wrote no logs")
    lap("source fit")

    aug = Compose(standardize, AdditiveGaussianNoise(scale=(0.0, 0.15)))
    dual = DualImageCollectionDataset(ipaths, lpaths, patch_shape=(HW, HW), augmentation1=aug,
                                      augmentation2=aug)
    mt = MeanTeacherTrainer("mt", punet(), Loader(dual, 2, num_workers=0, shuffle=True, seed=1),
                            Loader(dual, 1, num_workers=0, shuffle=False, seed=2),
                            save_root=save_root, learning_rate=1e-4, ckpt_model=ckpt,
                            ckpt_teacher=ckpt, device=dev)
    mt.fit(MT_STEPS)
    if not os.path.exists(os.path.join(checkpoint_dir("mt", save_root), "latest.pt")):
        raise RuntimeError("e2e_drive: the Mean Teacher run wrote no latest.pt")
    lap("mean teacher")

    model = punet()
    model.load_state_dict(load_params(ckpt))
    model = model.to(dev).eval()
    pred_dir = os.path.join(root, "pred") + os.sep
    punet_prediction(os.path.join(img_dir, "*.tif"), pred_dir, model, prior_samples=MC,
                     block_shape=(HW, HW), halo=(8, 8), verbose=False)
    preds = sorted(glob.glob(os.path.join(pred_dir, "*.tif")))
    p0 = imread(preds[0]) if preds else None
    if (len(preds) != N_FRAMES or p0.ndim != 2 or not 0.0 <= float(p0.min())
            or not float(p0.max()) <= 1.0):
        raise RuntimeError(f"e2e_drive: predictions {preds}")
    lap("prediction")

    pseudo_root = os.path.join(root, "pseudo") + os.sep
    punet_pseudo_prediction(img_dir, pseudo_root, model, prior_samples=MC, split_name="train",
                            verbose=False)
    ann, cons = (glob.glob(os.path.join(pseudo_root, tree, "**", "*.tif"), recursive=True)
                 for tree in ("annotations", "consensus"))
    if len(ann) != N_FRAMES or len(cons) != N_FRAMES:
        raise RuntimeError(f"e2e_drive: pseudo trees of {len(ann)} and {len(cons)} files")
    if not set(np.unique(imread(cons[0])).tolist()) <= {0, 1}:
        raise RuntimeError("e2e_drive: a consensus mask outside {0, 1}")
    lap("pseudo export")

    dice = run_dice_evaluation(os.path.join(lab_dir, "*.tif"), pred_dir)
    lap("dice")
    return {"dice": float(dice), "seconds": seconds}


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "e2e_drive")
    root = args.root or tempfile.mkdtemp(prefix="pda_torch_e2e_")
    wrappers = ab.kernel_wrappers()
    ab.reset_launches(wrappers)
    t0 = time.perf_counter()
    try:
        out = drive(root, dev)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    ok = math.isfinite(out["dice"]) and out["dice"] >= DICE_FLOOR
    result = {**out, "dice_floor": DICE_FLOOR, "total_seconds": time.perf_counter() - t0,
              "filters": list(FILTERS), "steps": STEPS,
              "launches": ab.read_launches(wrappers) if dev.type == "cuda" else None,
              "route": ("float32 kernels, mma.sync bodies" if dev.type == "cuda"
                        else "plain versions (CPU)"), "card": card(dev)}
    print("e2e_drive result " + json.dumps({**result, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
