"""Dice score (port of ``pda/core/metrics.py``): the numpy host version and
its torch twin for in-step validation metrics."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_EPS = 1e-7


def dice_score(segmentation: np.ndarray, groundtruth: np.ndarray,
               threshold_seg: Optional[float] = None,
               threshold_gt: Optional[float] = None) -> float:
    """Soft/hard dice between a segmentation and ground truth (numpy, host):
    optional thresholds binarize either input; score = 2 sum(gt seg) /
    (sum(gt) + sum(seg) + eps)."""
    if segmentation.shape != groundtruth.shape:
        raise ValueError(f"shapes differ: {segmentation.shape}, {groundtruth.shape}")
    seg = segmentation if threshold_seg is None else segmentation > threshold_seg
    gt = groundtruth if threshold_gt is None else groundtruth > threshold_gt
    nom = 2 * np.sum(np.asarray(gt, dtype=np.float64) * np.asarray(seg, dtype=np.float64))
    denom = np.sum(gt) + np.sum(seg)
    return float(nom) / float(denom + _EPS)


def dice_score_torch(segmentation: torch.Tensor, groundtruth: torch.Tensor,
                     threshold_seg: Optional[float] = None,
                     threshold_gt: Optional[float] = None, mesh=None) -> torch.Tensor:
    """Torch twin of :func:`dice_score`, float32, a 0-d tensor; on a data
    ``mesh`` the numerator and the denominator are summed over the ranks
    (on a 2-D mesh over data x space, ``pda``'s ``_with_space``) before the
    ratio, so the score is the global batch's."""
    seg = segmentation if threshold_seg is None else segmentation > threshold_seg
    gt = groundtruth if threshold_gt is None else groundtruth > threshold_gt
    seg, gt = seg.to(torch.float32), gt.to(torch.float32)
    if mesh is None:
        return 2.0 * torch.sum(gt * seg) / (torch.sum(gt) + torch.sum(seg) + _EPS)
    nom = mesh.all_reduce(2.0 * torch.sum(gt * seg))
    denom = mesh.all_reduce(torch.sum(gt) + torch.sum(seg))
    return nom / (denom + _EPS)
