"""The port's supervised and pseudo-label PUNet trainers against ``pda``'s through ``fit``: the
tests of ``test_torch_engine.py`` (see there) on these trainers."""

import pytest

from torch_port_utils import (check_final_weights, check_iteration_lr_and_checkpoints,
                              check_tags_and_panels, check_train_scalars,
                              check_validation_scalars)

KINDS = ("punet", "pseudo_punet")


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
