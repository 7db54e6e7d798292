"""Conv building blocks of the PUNet (port of ``pda/models/blocks.py``), NHWC.

Parameters are held in the reference torch layout (``weight`` (O, I, kh, kw)
and ``bias``, inside ``layers`` Sequentials with the parameterless pool/ReLU
modules at their reference indices), so ``state_dict()`` carries the names
that ``pda.models.convert`` documents. The compute never calls those
Sequentials: a ConvBlock of 3 convs (every experiment's) runs as one call
of the fused ConvBlock kernel (:mod:`pda_torch.kernels.conv_block`), the
plain PyTorch version on CPU tensors, and its gradient as one call of the
fused backward. A block of any other depth runs conv + bias + ReLU layer by
layer under autograd (``F.conv2d``, cuDNN on the card), as ``pda`` runs it
with plain autodiff convs: ``pda`` has no kernel for that depth either. The
pool and the upsample are PyTorch ops that autograd differentiates.

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

#: convs per block by default; the fused kernels implement exactly this depth
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


def _conv_layers(in_channels: int, features: int, n_convs: int = N_CONVS) -> list:
    mods, cin = [], in_channels
    for _ in range(n_convs):
        mods += [ConvParams(cin, features, 3), nn.ReLU()]
        cin = features
    return mods


def conv_relu_layers(x: torch.Tensor, convs: Sequence[ConvParams]) -> torch.Tensor:
    """n x (conv3x3 SAME + bias + ReLU) on (B, H, W, C), layer by layer: the
    path of a block whose depth the fused kernels do not take."""
    h = x.permute(0, 3, 1, 2)
    for c in convs:
        h = F.relu(F.conv2d(h, c.weight, c.bias, padding=1))
    return h.permute(0, 2, 3, 1).contiguous()


def conv_block(x: torch.Tensor, convs: Sequence[ConvParams], pool: bool) -> torch.Tensor:
    """[2x2 avg pool] + n x (conv3x3 + bias + ReLU) on (B, H, W, C): the
    fused kernel at 3 convs, :func:`conv_relu_layers` at any other depth."""
    if pool:
        x = avg_pool_2x2(x)
    if len(convs) != N_CONVS:
        return conv_relu_layers(x, convs)
    return conv_block_fwd(x.contiguous(), *_weights(convs))


class ConvBlock(nn.Module):
    """[AvgPool] + n_convs x (Conv3x3 + ReLU): reference ``DownConvBlock``
    (``layers`` = [pool,] conv, relu, conv, relu, conv, relu at 3 convs)."""

    def __init__(self, in_channels: int, features: int, pool: bool = False,
                 n_convs: int = N_CONVS):
        super().__init__()
        self.pool = pool
        self.layers = nn.Sequential(
            *([nn.AvgPool2d(2)] if pool else []),
            *_conv_layers(in_channels, features, n_convs))

    def convs(self) -> list:
        return [m for m in self.layers if isinstance(m, ConvParams)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_block(x, self.convs(), self.pool)


class UpBlock(nn.Module):
    """Bilinear x2 upsample + skip concat + ConvBlock (reference
    ``UpConvBlock``). The concat [upsample | skip] is read by the dual-input
    kernel and never built on the card."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 n_convs: int = N_CONVS):
        super().__init__()
        self.conv_block = ConvBlock(in_channels + skip_channels, features, n_convs=n_convs)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        up = upsample_2x_align_corners(x)
        if up.shape[1:3] != bridge.shape[1:3]:
            raise ValueError(
                f"skip-connection shape mismatch: {tuple(up.shape)} vs {tuple(bridge.shape)}")
        convs = self.conv_block.convs()
        if len(convs) != N_CONVS:
            return conv_relu_layers(torch.cat([up, bridge], dim=-1), convs)
        return conv_block_fwd_dual(up, bridge.contiguous(), *_weights(convs))


class EncoderPyramid(nn.Module):
    """Contracting pyramid of ConvBlocks, a pool before every block but the
    first: reference ``Encoder``, whose ``layers`` is ONE Sequential with the
    pools interleaved."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], n_convs: int = N_CONVS):
        super().__init__()
        self.depth = len(num_filters)
        self.n_convs = n_convs
        mods, cin = [], in_channels
        for i, feats in enumerate(num_filters):
            if i > 0:
                mods.append(nn.AvgPool2d(2))
            mods += _conv_layers(cin, feats, n_convs)
            cin = feats
        self.layers = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [m for m in self.layers if isinstance(m, ConvParams)]
        n = self.n_convs
        for i in range(self.depth):
            x = conv_block(x, convs[n * i:n * (i + 1)], pool=i > 0)
        return x
