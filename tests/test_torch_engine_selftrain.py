"""The port's Mean Teacher and FixMatch trainers against ``pda``'s through ``fit``: the
tests of ``test_torch_engine.py`` (see there) on these trainers, on both packages'
numpy augmentations, and the Mean Teacher's also on their native libraries."""

import pytest

from torch_port_utils import (check_final_weights, check_iteration_lr_and_checkpoints,
                              check_tags_and_panels, check_train_scalars,
                              check_validation_scalars)

KINDS = ("mean_teacher", "fixmatch")


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


@pytest.mark.parametrize("check", [check_train_scalars, check_validation_scalars,
                                   check_final_weights, check_iteration_lr_and_checkpoints,
                                   check_tags_and_panels], ids=lambda c: c.__name__)
def test_engine_mean_teacher_on_native_views_matches_pda(check, root):
    """The Mean Teacher through ``fit(4)`` with both packages' native
    libraries: the native weak views, standardize and elastic warps."""
    check("mean_teacher", root, native=True)
