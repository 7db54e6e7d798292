"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU. Run them on a machine with
one: ``python -m pytest tests/test_torch_cuda.py -q``. Shapes are small and
ragged on purpose (odd H/W, channel counts that do not fill a tile); the
serving path's full widths are checked by ``chip_smoke.py``. Both TF32
switches are off, so the plain versions compute in full float32.
"""

import numpy as np
import pytest
import torch

from pda_torch.kernels.conv_block import (conv_block_fwd, conv_block_fwd_dual,
                                          conv_block_fwd_dual_plain, conv_block_fwd_plain)
from pda_torch.kernels.mc_consensus import mc_consensus, mc_consensus_plain, mc_logits_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(gen, cin, c, dev):
    out = []
    for ci in (cin, c, c):
        out.append((torch.randn(3, 3, ci, c, generator=gen) * (2.0 / (9 * ci)) ** 0.5).to(dev))
        out.append((torch.randn(c, generator=gen) * 0.1).to(dev))
    return out


def _assert_rel(out, ref, rel=1e-4):
    err = float((out - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err


@pytest.mark.parametrize("b,h,w,cin,c", [
    (2, 9, 13, 1, 64), (1, 17, 33, 2, 40), (2, 8, 16, 70, 128), (1, 5, 3, 8, 8),
])
def test_conv_block_kernel_matches_plain(dev, b, h, w, cin, c):
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    ws = _weights(gen, cin, c, dev)
    before = conv_block_fwd.launches
    with torch.no_grad():
        out = conv_block_fwd(x, *ws)
    torch.cuda.synchronize()
    assert conv_block_fwd.launches == before + 1
    _assert_rel(out, conv_block_fwd_plain(x, *ws))


@pytest.mark.parametrize("b,h,w,ca,cb,c", [(2, 10, 12, 13, 7, 24), (1, 16, 16, 64, 32, 64)])
def test_dual_conv_block_kernel_matches_plain(dev, b, h, w, ca, cb, c):
    gen = torch.Generator().manual_seed(ca)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
    ws = _weights(gen, ca + cb, c, dev)
    with torch.no_grad():
        out = conv_block_fwd_dual(xa, xb, *ws)
    torch.cuda.synchronize()
    _assert_rel(out, conv_block_fwd_dual_plain(xa, xb, *ws))


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("n_mid", [0, 1, 2])
@pytest.mark.parametrize("masking", [False, True])
def test_mc_consensus_kernel_matches_plain(dev, c, n_mid, masking):
    gen = torch.Generator().manual_seed(c + n_mid)
    feat = (torch.randn(2, 33, 17, c, generator=gen) * 2).to(dev)
    z = torch.randn(5, 2, c, generator=gen).to(dev)
    mid_w = (torch.randn(n_mid, c, c, generator=gen) / c ** 0.5).to(dev)
    mid_b = (torch.randn(n_mid, c, generator=gen) * 0.1).to(dev)
    last_w = (torch.randn(c, 1, generator=gen) / c ** 0.5 * 3).to(dev)
    last_b = torch.randn(1, generator=gen).to(dev)
    args = (feat, z, mid_w, mid_b, last_w, last_b)
    with torch.no_grad():
        mean, cons = mc_consensus(*args, masking=masking)
    torch.cuda.synchronize()
    ref_mean, ref_cons = mc_consensus_plain(*args, masking)
    assert float((mean - ref_mean).abs().max()) <= 1e-5
    logits = mc_logits_plain(*args)
    near = ((logits.abs() - np.log(9.0)).abs() < 1e-4).any(dim=0)
    assert not ((cons != ref_cons) & ~near).any()


def test_wrappers_refuse_mixed_devices_and_autograd(dev):
    x = torch.zeros(1, 4, 4, 2, device=dev)
    ws = _weights(torch.Generator().manual_seed(0), 2, 8, dev)
    with pytest.raises(ValueError):
        conv_block_fwd(x, ws[0].cpu(), *ws[1:])
    with pytest.raises(RuntimeError, match="forward-only"):
        conv_block_fwd(x, ws[0].requires_grad_(), *ws[1:])
