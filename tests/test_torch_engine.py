"""The port's training engine against ``pda``'s, on the CPU: each trainer of
both through ``fit(4)`` (two epochs of two steps, a validation and
best/latest checkpoints each epoch, a plateau reduction at the second),
from the same weights (pda's initialised tree, bridged), on the same batches
(pda's ``Loader`` against the port's) and the same noise (the port's step
and panel callables take the normals of pda's key chain,
``torch_port_utils.PdaKeyChain``). Compared (``torch_port_utils``'s
``check_*``): every logged train and validation scalar (rel 1e-5), the final
student and teacher (abs 1e-6 where Adam's sign is defined, else within
steps x lr of the start), the iteration, the learning rate, the
checkpoints' bookkeeping, and the TensorBoard tags and panels as
tensorboardX writes them.

This file holds the UNet trainers; ``test_torch_engine_punet.py``,
``test_torch_engine_selftrain.py`` and ``test_torch_engine_joint.py`` the
same tests for the others (one file each, to keep every file's time short).
"""

import pytest

from torch_port_utils import (check_final_weights, check_iteration_lr_and_checkpoints,
                              check_tags_and_panels, check_train_scalars,
                              check_validation_scalars)

KINDS = ("unet", "pseudo_unet")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("engine"))


@pytest.mark.parametrize("kind", KINDS)
def test_engine_train_scalars_match_pda(kind, root):
    check_train_scalars(kind, root)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_validation_scalars_match_pda(kind, root):
    check_validation_scalars(kind, root)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_final_weights_match_pda(kind, root):
    check_final_weights(kind, root)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_iteration_lr_and_checkpoints_match_pda(kind, root):
    check_iteration_lr_and_checkpoints(kind, root)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_tags_and_panels_match_pda(kind, root):
    check_tags_and_panels(kind, root)
