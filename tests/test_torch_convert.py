"""Weight bridge of the PyTorch port: pda params -> port -> pda, leaf for
leaf, and the port's own parameter names against pda's tree."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pda.models.convert import convert_punet_state_dict
from torch_port_utils import FILTERS, pda_punet, port_punet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("no_convs_fcomb", [3, 4])
def test_round_trip_pda_port_pda(no_convs_fcomb):
    _, params = pda_punet(no_convs_fcomb)
    port = port_punet(params, no_convs_fcomb)
    back = convert_punet_state_dict(
        port.state_dict(), num_filters=FILTERS, no_convs_fcomb=no_convs_fcomb)
    want, got = _leaves(params), _leaves(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].shape == got[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_init_matches_pda_tree():
    """The port's own init converts to a tree pda can apply: same leaf
    paths and shapes, so the state-dict names line up with pda's modules."""
    from pda_torch.models import ProbabilisticUnet

    _, params = pda_punet()
    port = ProbabilisticUnet(num_filters=FILTERS, latent_dim=6, no_convs_fcomb=3,
                             generator=torch.Generator().manual_seed(3))
    conv = convert_punet_state_dict(port.state_dict(), num_filters=FILTERS, no_convs_fcomb=3)
    want, got = _leaves(params), _leaves(conv)
    assert {k: v.shape for k, v in want.items()} == {k: v.shape for k, v in got.items()}
    # He-normal 3x3 kernels: std sqrt(2 / fan_in); biases within 2e-3
    w = port.unet.contracting_path[3].convs()[1].weight.detach()
    assert abs(float(w.std()) - (2.0 / (9 * FILTERS[3])) ** 0.5) < 0.05
    assert all(float(m.bias.detach().abs().max()) <= 2e-3 for m in port.unet.contracting_path[0].convs())
    head = port.prior.conv_layer.dense()  # (16, 12): orthonormal columns
    np.testing.assert_allclose((head.T @ head).detach().numpy(), np.eye(12), atol=1e-5)


def test_port_imports_no_jax():
    code = (
        "import sys, pda_torch, pda_torch.core, pda_torch.models, pda_torch.kernels, "
        "pda_torch.infer, pda_torch.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pda'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
