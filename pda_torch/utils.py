"""Small shared utilities (port of ``pda/utils.py``): the reference's
``DummyLoss``, ``clean_folder`` and the ``dice_score`` and ``my_standardize``
re-exports."""

from __future__ import annotations

import os

from .core.metrics import dice_score  # noqa: F401  (re-export)
from .data.transforms import standardize as my_standardize  # noqa: F401


class DummyLoss:
    """Placeholder loss object (reference prob_utils/my_utils/util.py:5-6):
    torch_em's trainer takes a loss even where the trainer computes its own,
    so reference-style call sites pass this one; calling it raises."""

    def __call__(self, *args, **kwargs):
        raise RuntimeError("DummyLoss is a placeholder and must not be called")


def clean_folder(folder_path: str) -> None:
    """Remove the files in a folder (reference my_models/utils.py:51-55):
    stale exports of an earlier run in a pseudo-label folder."""
    if not os.path.isdir(folder_path):
        return
    for filename in os.listdir(folder_path):
        myfile = os.path.join(folder_path, filename)
        if os.path.isfile(myfile):
            os.remove(myfile)
