"""The float32 ConvBlock's weight copy with its 3xTF32 split
(``conv_block.tf32_planes_plain``, the plain version of
``csrc/tf32_planes.cu``): the kernel and its hi and lo planes in the order
the layer bodies read them (HWOI for the forward, HWIO for the dgrad), held
bit for bit against ``tf32x3.split_tf32x3`` and, as hi + lo, against the
kernel in float64."""

import numpy as np
import pytest
import torch

from pda_torch.kernels import conv_block as kconv
from pda_torch.kernels.tf32x3 import round_tf32, split_tf32x3


def _kernel(seed, ci, c):
    """A seeded HWIO kernel whose magnitudes span many binades."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 3, ci, c)) * np.exp(6 * rng.standard_normal((3, 3, ci, c)))
    return torch.from_numpy(w.astype(np.float32))


@pytest.mark.parametrize("hwoi", [True, False])
@pytest.mark.parametrize("ci,c", [(1, 64), (5, 7), (64, 128), (768, 256)])
def test_planes_are_the_kernel_and_its_split_in_reading_order(hwoi, ci, c):
    w = _kernel(ci * 1000 + c, ci, c)
    planes = kconv.tf32_planes_plain(w, hwoi)
    k = w.permute(0, 1, 3, 2) if hwoi else w
    assert planes.shape == (3, 3, 3, *k.shape[2:]) and planes.is_contiguous()
    hi, lo = split_tf32x3(k.contiguous())
    for plane, ref in zip(planes, (k, hi, lo)):
        assert torch.equal(plane.view(torch.int32), ref.contiguous().view(torch.int32))
    # the forward reads [tap][n = Cout][k = Cin], the dgrad [tap][n = Cin][k = Cout]
    assert torch.equal(planes[0, 1, 2, 0], w[1, 2, :, 0] if hwoi else w[1, 2, 0, :])


@pytest.mark.parametrize("hwoi", [True, False])
def test_hi_plus_lo_is_the_kernel_within_2_to_the_minus_22(hwoi):
    w = _kernel(7, 96, 64)
    _, hi, lo = kconv.tf32_planes_plain(w, hwoi)
    k = (w.permute(0, 1, 3, 2) if hwoi else w).double()
    err = (hi.double() + lo.double() - k).abs()
    assert bool((err <= 2.0 ** -22 * k.abs()).all()), float((err / k.abs()).max())
    # each plane is a TF32 value: its low 13 mantissa bits are zero
    for p in (hi, lo):
        assert torch.equal(p, round_tf32(p))
        assert int((p.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_planes_pass_inf_and_nan_and_keep_signed_zeros():
    w = torch.zeros(3, 3, 2, 4)
    w.view(-1)[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
    k, hi, lo = kconv.tf32_planes_plain(w, hwoi=False)
    assert torch.equal(hi.view(-1)[:2], w.view(-1)[:2]) and bool(hi.view(-1)[2].isnan())
    assert hi.view(-1)[3].item() == 0.0 and torch.signbit(hi.view(-1)[3])
    assert torch.equal(k.view(torch.int32), w.view(torch.int32))


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    w = _kernel(3, 16, 24)
    for hwoi in (True, False):
        assert torch.equal(kconv.tf32_planes(w, hwoi), kconv.tf32_planes_plain(w, hwoi))
