"""Conv building blocks of the PUNet (port of ``pda/models/blocks.py``), NHWC.

Parameters are held in the reference torch layout (``weight`` (O, I, kh, kw)
and ``bias``, inside ``layers`` Sequentials with the parameterless pool/ReLU
modules at their reference indices), so ``state_dict()`` carries the names
that ``pda.models.convert`` documents. The compute never calls those
Sequentials: a ConvBlock runs as one call of the fused ConvBlock kernel
(:mod:`pda_torch.kernels.conv_block`), the plain PyTorch version on CPU
tensors.

Initialization follows ``pda`` (reference my_models/utils.py:17-28), each
draw from an explicit ``torch.Generator``:
  * conv kernels: He normal (fan_in, ReLU gain), untruncated
  * biases: normal truncated at 2 sigma, sigma = 1e-3
  * Fcomb / Gaussian-head kernels: orthogonal (gain 1)
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv_block import conv_block_fwd, conv_block_fwd_dual

#: convs per block; the fused kernels implement exactly this depth
N_CONVS = 3


def he_normal(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """He/Kaiming normal for a torch-layout kernel (O, I, kh, kw)."""
    fan_in = math.prod(shape[1:])
    return torch.randn(tuple(shape), generator=generator) * math.sqrt(2.0 / fan_in)


def orthogonal(n_in: int, n_out: int, generator: torch.Generator) -> torch.Tensor:
    """(n_in, n_out) matrix with orthonormal columns (or rows if n_in < n_out)."""
    a = torch.randn(max(n_in, n_out), min(n_in, n_out), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q if n_in >= n_out else q.t()).to(torch.float32)


def trunc_normal_bias(n: int, generator: torch.Generator, std: float = 1e-3) -> torch.Tensor:
    """Normal draws resampled until within 2 sigma, times ``std``."""
    z = torch.randn(n, generator=generator)
    bad = z.abs() > 2.0
    while bad.any():
        z[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = z.abs() > 2.0
    return z * std


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool of (B, H, W, C); H and W must be even."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"avg_pool_2x2 needs even spatial dims, got {tuple(x.shape)}")
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def upsample_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsampling of (B, H, W, C), ``align_corners=True``."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                       align_corners=True)
    return up.permute(0, 2, 3, 1).contiguous()


class ConvParams(nn.Module):
    """Weight (O, I, k, k) and bias (O,) of one conv, torch ``Conv2d``
    layout. A parameter holder only: the blocks read it, nothing calls it.

    ``init``: "he" (3x3 convs) or "orthogonal" (1x1 convs used as Dense
    layers); ``row_blocks`` splits the Dense input rows into blocks that are
    each initialized orthogonal on their own (the Fcomb's feature and latent
    halves, two separate Dense layers in ``pda``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 init: str = "he", row_blocks: Tuple[int, ...] = ()):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.init = init
        self.row_blocks = row_blocks or (in_channels,)

    def reset_parameters(self, generator: torch.Generator) -> None:
        o = self.weight.shape[0]
        with torch.no_grad():
            if self.init == "he":
                self.weight.copy_(he_normal(self.weight.shape, generator))
            else:
                dense = torch.cat([orthogonal(n, o, generator) for n in self.row_blocks])
                self.weight.copy_(dense.t()[:, :, None, None])
            self.bias.copy_(trunc_normal_bias(o, generator))

    def hwio(self) -> torch.Tensor:
        """The kernel in ``pda``'s HWIO layout, contiguous."""
        return self.weight.permute(2, 3, 1, 0).contiguous()

    def dense(self) -> torch.Tensor:
        """A 1x1 conv's kernel as an (in, out) matrix."""
        return self.weight[:, :, 0, 0].t()


def _weights(convs: Sequence[ConvParams]):
    out = []
    for c in convs:
        out += [c.hwio(), c.bias.contiguous()]
    return out


def _conv_layers(in_channels: int, features: int) -> list:
    mods, cin = [], in_channels
    for _ in range(N_CONVS):
        mods += [ConvParams(cin, features, 3), nn.ReLU()]
        cin = features
    return mods


def conv_block(x: torch.Tensor, convs: Sequence[ConvParams], pool: bool) -> torch.Tensor:
    """[2x2 avg pool] + the fused 3 x (conv3x3 + bias + ReLU) on (B, H, W, C)."""
    if pool:
        x = avg_pool_2x2(x)
    return conv_block_fwd(x.contiguous(), *_weights(convs))


class ConvBlock(nn.Module):
    """[AvgPool] + 3 x (Conv3x3 + ReLU): reference ``DownConvBlock``
    (``layers`` = [pool,] conv, relu, conv, relu, conv, relu)."""

    def __init__(self, in_channels: int, features: int, pool: bool = False):
        super().__init__()
        self.pool = pool
        self.layers = nn.Sequential(
            *([nn.AvgPool2d(2)] if pool else []), *_conv_layers(in_channels, features))

    def convs(self) -> list:
        return [m for m in self.layers if isinstance(m, ConvParams)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_block(x, self.convs(), self.pool)


class UpBlock(nn.Module):
    """Bilinear x2 upsample + skip concat + ConvBlock (reference
    ``UpConvBlock``). The concat [upsample | skip] is read by the dual-input
    kernel and never built on the card."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.conv_block = ConvBlock(in_channels + skip_channels, features)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        up = upsample_2x_align_corners(x)
        if up.shape[1:3] != bridge.shape[1:3]:
            raise ValueError(
                f"skip-connection shape mismatch: {tuple(up.shape)} vs {tuple(bridge.shape)}")
        return conv_block_fwd_dual(up, bridge.contiguous(),
                                   *_weights(self.conv_block.convs()))


class EncoderPyramid(nn.Module):
    """Contracting pyramid of ConvBlocks, a pool before every block but the
    first: reference ``Encoder``, whose ``layers`` is ONE Sequential with the
    pools interleaved."""

    def __init__(self, in_channels: int, num_filters: Sequence[int]):
        super().__init__()
        self.depth = len(num_filters)
        mods, cin = [], in_channels
        for i, feats in enumerate(num_filters):
            if i > 0:
                mods.append(nn.AvgPool2d(2))
            mods += _conv_layers(cin, feats)
            cin = feats
        self.layers = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [m for m in self.layers if isinstance(m, ConvParams)]
        for i in range(self.depth):
            x = conv_block(x, convs[N_CONVS * i:N_CONVS * (i + 1)], pool=i > 0)
        return x
