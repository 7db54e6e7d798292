"""Dice evaluation runners (port of ``pda/eval/dice.py``): glob the
ground-truth files, find each one's prediction by the dataset's filename
remap, and return (and print) the mean dice.

The remaps and thresholds are ``pda``'s (and the reference's): lucchi
``mask{NNNN}.tif``, urocell ``_gt`` -> ``_image``, jsrt2's 6-character
annotation suffix, mitoem's ``im`` prefix; the prediction thresholded at 0.5
for LIVECell, the ground truth at 0 for lung and EM. numpy and imageio only,
on :func:`pda_torch.core.metrics.dice_score`; imageio is imported when a
file is read.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List, Optional

import numpy as np

from ..core.metrics import dice_score


def _imread(path: str) -> np.ndarray:
    import imageio.v3 as imageio

    return np.asarray(imageio.imread(path))


def _mean(scores: List[float]) -> float:
    return sum(scores) / len(scores) if scores else float("nan")


def run_dice_evaluation(gt_f_path: str, pred_path: str, subtype: Optional[str] = None,
                        verbose: bool = True) -> float:
    """LIVECell-style: the prediction thresholded at 0.5 against the
    binarized ground truth; ``subtype`` "lucchi" / "urocell" remap names."""
    scores: List[float] = []
    for my_path in sorted(glob(gt_f_path)):
        fname = os.path.basename(my_path)
        if subtype == "lucchi":
            fname = f"mask{int(fname[:-4]):04}.tif"
        elif subtype == "urocell":
            fname = fname.replace("_gt", "_image")
        pred = _imread(os.path.join(pred_path, f"{fname[:-4]}.tif"))
        gt = (_imread(my_path) > 0).astype("uint8")
        if subtype == "lucchi" and gt.ndim > 2:
            gt = gt[:, :, 0]
        scores.append(dice_score(pred, gt, threshold_seg=0.5))
    mean = _mean(scores)
    if verbose:
        print(f"Average Dice Score for '{subtype}' - {round(mean, 3)}")
    return mean


def run_lung_dice_evaluation(gt_f_path: str, pred_path: str, lung_domain: str,
                             verbose: bool = True) -> float:
    """Lung X-ray: ground truth thresholded at 0; for "jsrt2" the GT name
    loses its 6-character annotation suffix (the identity name where that
    prediction does not exist)."""
    scores: List[float] = []
    for my_path in sorted(glob(gt_f_path + "*")):
        imagename = os.path.basename(my_path)
        f_pred_path = os.path.join(pred_path, imagename[:-4] + ".tif")
        if lung_domain == "jsrt2":
            remapped = os.path.join(pred_path, imagename[:-10] + ".tif")
            if os.path.exists(remapped):
                f_pred_path = remapped
        pred = _imread(f_pred_path)
        gt = _imread(my_path)
        gt = np.where(gt != 0, 1, gt)
        scores.append(dice_score(pred, gt, threshold_gt=0))
    mean = _mean(scores)
    if verbose:
        print(f"Average Dice Score - {round(mean, 3)}")
    return mean


def run_em_dice_evaluation(gt_f_path: str, pred_path: str, model: str,
                           verbose: bool = True) -> float:
    """EM: ground truth thresholded at 0; ``model`` "vnc" / "lucchi" /
    "mitoem" remap names (any other keeps the GT's name)."""
    scores: List[float] = []
    for my_path in sorted(glob(gt_f_path + "*")):
        gt = _imread(my_path)
        gt = np.where(gt != 0, 1, gt)
        imagename = os.path.basename(my_path)
        if model == "vnc":
            f_pred_path = os.path.join(pred_path, imagename[:-4] + ".tif")
        elif model == "lucchi":
            f_pred_path = os.path.join(pred_path, f"mask{int(imagename[:-4]):04}.tif")
            if gt.ndim > 2:
                gt = gt[:, :, 0]
        elif model == "mitoem":
            f_pred_path = os.path.join(pred_path, "im" + imagename[3:])
        else:
            f_pred_path = os.path.join(pred_path, imagename)
        scores.append(dice_score(_imread(f_pred_path), gt, threshold_gt=0))
    mean = _mean(scores)
    if verbose:
        print(f"Average Dice Score - {round(mean, 3)}")
    return mean


def run_dice_evaluation_for_pseudo(gt_f_path: str, pred_path: str, consensus_mask_path: str,
                                   model: str = "punet", verbose: bool = True) -> float:
    """Dice on the pixels where the consensus mask is 1: the pseudo-labels'
    quality where they are confident. A "unet" prediction is named
    ``<stem>-c0.tif``."""
    scores: List[float] = []
    for my_path in sorted(glob(gt_f_path + "*.tif")):
        imagename = os.path.basename(my_path)
        if model == "unet":
            f_pred_path = os.path.join(pred_path, imagename[:-4] + "-c0.tif")
        else:
            f_pred_path = os.path.join(pred_path, imagename)
        pred = _imread(f_pred_path)
        gt = _imread(my_path)
        mask = _imread(os.path.join(consensus_mask_path, imagename)) == 1
        gt = np.where(gt != 0, 1, gt)
        scores.append(dice_score(pred[mask], gt[mask], threshold_gt=0))
    mean = _mean(scores)
    if verbose:
        print(f"Average Dice over all {model} Predictions is - {round(mean, 3)}")
    return mean
