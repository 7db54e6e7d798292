"""TensorBoard logging: scalar tags and image panels as the reference
loggers write them (port of ``pda/train/logging.py``).

Log dir ``./logs/<name>`` or ``<save_root>/logs/<name>``; scalar tags
``train/<metric>``, ``train/learning_rate`` and ``validation/<metric>``;
image panels every ``log_image_interval`` steps and at every validation.
Written to one TensorBoard event file per log dir by the port's own writer
(:mod:`.events`), with the records tensorboardX writes for ``pda``, flushed
after every validation and at ``close``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np

from .events import EventWriter


def _normalize(img: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Min-max normalize for display."""
    img = np.asarray(img, dtype=np.float32)
    img = img - img.min()
    return img / (img.max() + eps)


def make_grid(images, nrow: int = 4, padding: int = 4) -> np.ndarray:
    """Tile (H, W[, 1]) images into one grid, ``nrow`` to a row
    (torchvision ``make_grid``)."""
    imgs = [np.asarray(im, dtype=np.float32) for im in images]
    h, w = imgs[0].shape[:2]
    ncol = nrow
    nrow_ = (len(imgs) + ncol - 1) // ncol
    grid = np.zeros((nrow_ * h + (nrow_ + 1) * padding, ncol * w + (ncol + 1) * padding),
                    dtype=np.float32)
    for idx, im in enumerate(imgs):
        r, c = divmod(idx, ncol)
        y0, x0 = padding + r * (h + padding), padding + c * (w + padding)
        grid[y0: y0 + h, x0: x0 + w] = im.squeeze()
    return grid


class TrainLogger:
    """Scalars and image panels for any trainer."""

    #: the panel tags the matching trainer writes (the trainer's ``image_tags``)
    image_tags: tuple = ()
    #: tags min-max normalized for display: the raw-intensity input views;
    #: pseudo-labels, consensus, predictions and sample grids are written raw
    NORMALIZED_TAGS = frozenset({
        "input", "aug_inputs_1", "aug_inputs_2", "weak_aug", "weak_aug1", "weak_aug2",
        "strong_aug", "target_input", "target_inputs", "source_input",
    })

    def __init__(self, name: str, save_root: Optional[str] = None,
                 log_image_interval: int = 100):
        self.log_dir = (f"./logs/{name}" if save_root is None
                        else os.path.join(save_root, "logs", name))
        self.tb = EventWriter(self.log_dir)
        self.log_image_interval = log_image_interval

    def log_train(self, step: int, scalars: Mapping[str, float],
                  images: Optional[Mapping[str, np.ndarray]] = None):
        for tag, value in scalars.items():
            self.tb.add_scalar(f"train/{tag}", float(value), step)
        if images and step % self.log_image_interval == 0:
            self._add_images("train", step, images)

    def log_validation(self, step: int, scalars: Mapping[str, float],
                       images: Optional[Mapping[str, np.ndarray]] = None):
        for tag, value in scalars.items():
            self.tb.add_scalar(f"validation/{tag}", float(value), step)
        if images:
            self._add_images("validation", step, images)
        self.tb.flush()  # the file is readable after every epoch

    def _add_images(self, prefix: str, step: int, images: Mapping[str, np.ndarray]):
        for tag, img in images.items():
            img = np.asarray(img, dtype=np.float32)
            if img.ndim == 4:  # a batch: its first element
                img = img[0]
            if img.ndim == 3 and img.shape[-1] in (1, 3):  # HWC -> CHW
                img = np.moveaxis(img, -1, 0)
            elif img.ndim == 2:
                img = img[None]
            self.tb.add_image(f"{prefix}/{tag}",
                              _normalize(img) if tag in self.NORMALIZED_TAGS else img, step)

    def close(self):
        self.tb.close()


# One logger class per reference trainer, under the reference's names, so
# that ``logger=PUNetLogger`` works as there; the panels themselves come from
# the trainer's panel maker.


class PUNetLogger(TrainLogger):
    """Input (raw, not normalized), target, 16-sample grid."""

    image_tags = ("input", "target", "samples")
    NORMALIZED_TAGS = TrainLogger.NORMALIZED_TAGS - {"input"}


class PseudoLogger(TrainLogger):
    """Input, target, prediction (the PUNet variant: a sample grid)."""

    image_tags = ("input", "target", "prediction")


class MeanTeacherLogger(TrainLogger):
    """Input and both views, the teacher's pseudo-labels and consensus, the
    ground truth, the model's MC mean."""

    image_tags = ("input", "aug_inputs_1", "aug_inputs_2", "teacher_predictions",
                  "teacher_consensus", "ground_truth", "model_samples")


class FixMatchLogger(TrainLogger):
    """One grid of [weak, strong, pseudo-labels, prediction]."""

    image_tags = ("weak-strong-labels-pred",)


class AdaMTLogger(TrainLogger):
    """The target's input and weak views (two tags, where the reference
    writes both under one), the teacher's pseudo-labels and consensus, the
    target ground truth, the model's MC mean."""

    image_tags = ("target_inputs", "weak_aug1", "weak_aug2", "teacher_predictions",
                  "teacher_consensus", "target_ground_truth", "model_samples")


class AdaMatchLogger(TrainLogger):
    image_tags = ("target_inputs", "weak_aug", "strong_aug", "weak_model_predictions",
                  "weak_model_consensus", "target_ground_truth", "model_samples")
