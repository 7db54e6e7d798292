"""The port's row-sharded supervised PUNet and Mean-Teacher steps on the
(2, 2) mesh (batch rows over ``data``, image rows over ``space``) against
``pda``'s ``shard_map`` step on the same mesh of the CPU's XLA devices:
``tests/test_torch_space_pda.py``'s cases and bounds, in a file of their
own so that the two meshes' compiles run side by side."""

from __future__ import annotations

import pytest

from test_torch_space_pda import STEPS, check_against_pda, port_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return port_ranks((2, 2), tmp_path_factory.mktemp("pda2x2"))


@pytest.mark.parametrize("case", list(STEPS))
def test_row_sharded_step_on_two_by_two_matches_pda_shard_map(ranks, case):
    check_against_pda(ranks[case], (2, 2), case)
