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
        "pda_torch.infer, pda_torch.train, pda_torch.eval, pda_torch.tools.profile, "
        "pda_torch.tools.bench_variants, pda_torch.data, pda_torch.data.loader, "
        "pda_torch.train.engine, pda_torch.train.checkpoint, pda_torch.train.logging, "
        "pda_torch.train.profiling, pda_torch.data.h5, pda_torch.data.png, "
        "pda_torch.data.builders.em, pda_torch.data.builders.prepare, "
        "pda_torch.experiments.mitoem_common, pda_torch.experiments.mitoem_da, "
        "pda_torch.experiments.mitoem_punet, pda_torch.experiments.mitoem_unet, "
        "pda_torch.experiments.mitoem_mt, pda_torch.experiments.mitoem_fm, "
        "pda_torch.experiments.mitoem_adamt, pda_torch.experiments.mitoem_adamatch, "
        "pda_torch.experiments.mitoem_prepare_data, pda_torch.experiments.livecell_da, "
        "pda_torch.data.blur, pda_torch.data.native, pda_torch.train.events, "
        "pda_torch.data.transforms, pda_torch.experiments.common, pda_torch.tools.ab, "
        "pda_torch.tools.common, pda_torch.tools.ab_step_check, pda_torch.tools.learning_smoke, "
        "pda_torch.tools.mt_smoke, pda_torch.tools.bench_loader, pda_torch.tools.e2e_drive, "
        "pda_torch.tools.plot_livecell, pda_torch.tools.colormaps, pda_torch.train.dcp_io, "
        "torch.distributed.checkpoint\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'pda', 'h5py', 'imageio', 'cv2',\n"
        "                                    'tensorboardX', 'tensorboard', 'orbax',\n"
        "                                    'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_livecell_punet_on_cpu_keeps_the_seed_weights():
    """Asked for the CPU, ``livecell_punet`` gives the seed-0 weights (the
    default generator), which it draws on the CPU whatever the device."""
    from pda_torch.models import ProbabilisticUnet, livecell_punet

    got = livecell_punet(device="cpu").state_dict()
    want = ProbabilisticUnet(input_channels=1, num_classes=1, num_filters=(64, 128, 256, 512),
                             latent_dim=6, no_convs_fcomb=3, beta=1.0, rl_swap=True,
                             generator=torch.Generator().manual_seed(0)).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "cpu" and torch.equal(v, want[k]), k


def test_livecell_punet_defaults_to_the_card(monkeypatch):
    """By default the flagship is built on the card; without one it raises
    (no quiet fall-back to the CPU)."""
    from pda_torch.models import livecell_punet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        livecell_punet()
