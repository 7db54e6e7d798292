"""Checkpoints: best/latest files, teacher state, warm starts (port of
``pda/train/checkpoint.py``).

``<save_root>/checkpoints/<name>/{best,latest}.pt`` (``./checkpoints/<name>``
without a ``save_root``), each one ``torch.save`` dict in torch_em
DefaultTrainer's layout:

  model_state, optimizer_state, iteration, best_metric, current_metric,
  train_time; teacher_state (Mean Teacher, AdaMT); scheduler_state (with a
  plateau controller); generator_state and panel_generator_state, the noise
  generators' states (``pda``'s ``state.rng``)

so ``pda.models.convert.load_torch_checkpoint`` and
``load_torch_unet_checkpoint`` read a port checkpoint as they read a
reference one. A write is atomic: a tmp file named with the process id,
flushed and fsynced, then ``os.replace``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

BEST = "best"
LATEST = "latest"


def checkpoint_dir(name: str, save_root: Optional[str] = None) -> str:
    root = "./checkpoints" if save_root is None else os.path.join(save_root, "checkpoints")
    return os.path.join(root, name)


def checkpoint_path(directory: str, which: str = BEST) -> str:
    return os.path.join(directory, f"{which}.pt")


def checkpoint_exists(directory: str, which: str = BEST) -> bool:
    return os.path.exists(checkpoint_path(directory, which))


def _atomic_save(obj: Any, path: str) -> None:
    """Write to ``<path>.tmp.<pid>``, flush, fsync, then rename: a crash
    leaves the old file or the new one, never a torn one, and two runs that
    share a directory never write into one tmp file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory: str, state, *, which: str = LATEST,
                    current_metric: float = float("inf"), best_metric: float = float("inf"),
                    train_time: float = 0.0, extra: Optional[dict] = None) -> str:
    """Write ``<directory>/<which>.pt`` from a :class:`TrainState`; ``extra``
    adds entries (the scheduler's and the generators' states)."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, which)
    blob = {
        "model_state": state.model.state_dict(),
        "optimizer_state": state.optimizer.state_dict(),
        "iteration": int(state.step),
        "best_metric": float(best_metric),
        "current_metric": float(current_metric),
        "train_time": float(train_time),
    }
    if state.teacher is not None:
        blob["teacher_state"] = state.teacher.state_dict()
    blob.update(extra or {})
    _atomic_save(blob, path)
    return path


def load_checkpoint(directory: str, *, which: str = BEST,
                    map_location: Any = "cpu") -> dict:
    """The checkpoint's dict, its tensors on ``map_location``."""
    return torch.load(checkpoint_path(directory, which), map_location=map_location,
                      weights_only=True)


def restore_state(state, blob: dict) -> None:
    """Load a checkpoint's model, teacher and optimizer states and its
    iteration into ``state``, in place."""
    state.model.load_state_dict(blob["model_state"])
    if state.teacher is not None:
        state.teacher.load_state_dict(blob["teacher_state"])
    state.optimizer.load_state_dict(blob["optimizer_state"])
    state.step = int(blob["iteration"])


def load_params(path_or_dir: str, *, which: str = BEST, key: str = "model_state",
                map_location: Any = "cpu") -> dict:
    """A state dict from a checkpoint, the warm-start path: ``key`` is
    ``model_state`` or ``teacher_state``. ``path_or_dir`` is a ``.pt`` file
    or a checkpoint directory (then its ``which``)."""
    path = path_or_dir if path_or_dir.endswith(".pt") else checkpoint_path(path_or_dir, which)
    return torch.load(path, map_location=map_location, weights_only=True)[key]
