"""UNet backbones (port of ``pda/models/unet.py``), NHWC at the public entries.

  * :class:`PUNetBackbone` — the 4-level UNet inside the PUNet: AvgPool
    down, bilinear align-corners up, ``n_convs`` convs a block, and no head
    unless ``num_classes`` is set (the Fcomb is the PUNet's head).
  * :class:`UNet2d` — the standalone supervised segmentation UNet, torch_em's
    ``UNet2d`` (the plain-UNet experiments): (InstanceNorm -> conv3x3 ->
    ReLU) x 2 blocks, max-pool down, bilinear (``align_corners=False``) x2 +
    1x1 sampler up, 1x1 head, optional sigmoid.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import N_CONVS, ComputeDtype, ConvBlock, ConvParams, UpBlock, dense, pool_out_plan


class PUNetBackbone(ComputeDtype, nn.Module):
    """4-level UNet, AvgPool down, bilinear align-corners up, no head
    (reference ``apply_last_layer=False``: the Fcomb is the head). Returns
    the last decoder map, ``num_filters[0]`` channels; with ``num_classes``
    set, the 1x1 head ``last_layer`` (He-normal kernel, truncated-normal
    bias; ``pda``'s ``unet/Conv_0``) maps it to ``num_classes`` channels.

    ``upsampling_path[0]`` is the DEEPEST up block, as in the reference and
    in ``pda`` (flax names ``UpBlock_{i}`` in creation order, deepest first).
    Parameters are drawn from ``generator`` (default: a CPU generator seeded
    0); a :class:`~pda_torch.models.punet.ProbabilisticUnet` redraws them
    from its own. ``dtype``: the compute dtype (float32, or bf16 with float32
    parameters, :mod:`.blocks`).
    """

    def __init__(self, input_channels: int = 1,
                 num_filters: Sequence[int] = (64, 128, 256, 512), n_convs: int = N_CONVS,
                 num_classes: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = tuple(num_filters)
        cins = (input_channels, *nf[:-1])
        self.contracting_path = nn.ModuleList(
            ConvBlock(cin, f, pool=i > 0, n_convs=n_convs)
            for i, (cin, f) in enumerate(zip(cins, nf)))
        self.upsampling_path = nn.ModuleList(
            UpBlock(nf[i + 1], nf[i], nf[i], n_convs=n_convs) for i in range(len(nf) - 2, -1, -1))
        self.last_layer = (None if num_classes is None
                           else ConvParams(nf[0], num_classes, 1, init="he"))
        self.dtype = dtype
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, ConvParams):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # every 3-conv level but the last returns (skip, pooled) from one
        # block call whose backward reads both cotangents (blocks.conv_block)
        skips, pooled = [], False
        plan = pool_out_plan(len(self.contracting_path), len(self.contracting_path[0].convs()))
        for block, fuse in zip(self.contracting_path, plan):
            out = block(x, pool=block.pool and not pooled, pool_out="with" if fuse else None)
            skip, x = out if fuse else (out, out)
            skips.append(skip)
            pooled = fuse
        for up, bridge in zip(self.upsampling_path, reversed(skips[:-1])):
            x = up(x, bridge)
        if self.last_layer is not None:
            x = dense(x, self.last_layer.dense(), self.last_layer.bias, self.dtype)
        return x


class _DoubleConv(nn.Module):
    """torch_em ``ConvBlock2d``: (InstanceNorm -> Conv3x3 -> ReLU) x 2 on
    NCHW, ``block`` = [norm, conv, relu, norm, conv, relu] (convs at 1 and
    4), or [conv, relu, conv, relu] without a norm. The norm is PyTorch's
    parameterless ``InstanceNorm2d`` (no affine, eps 1e-5, biased variance
    over H and W per sample and channel; ``pda``'s ``GroupNorm(group_size=1)``)."""

    def __init__(self, in_channels: int, features: int, norm: Optional[str] = "InstanceNorm"):
        super().__init__()
        if norm not in (None, "InstanceNorm"):
            raise ValueError(f"norm must be 'InstanceNorm' or None, got {norm!r}")
        mods, cin = [], in_channels
        for _ in range(2):
            if norm:
                mods.append(nn.InstanceNorm2d(cin, eps=1e-5, affine=False))
            mods += [nn.Conv2d(cin, features, 3, padding=1), nn.ReLU()]
            cin = features
        self.block = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _Upsampler(nn.Module):
    """torch_em ``Upsampler2d``: bilinear x2 (``align_corners=False``, half-
    pixel centers), then the 1x1 ``conv``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False))


class _Encoder(nn.Module):
    def __init__(self, in_channels: int, feats: Sequence[int], norm):
        super().__init__()
        cins = (in_channels, *feats[:-1])
        self.blocks = nn.ModuleList(_DoubleConv(ci, f, norm) for ci, f in zip(cins, feats))


class _Decoder(nn.Module):
    """``samplers[i]`` and ``blocks[i]``: index 0 is the DEEPEST level (flax
    creates ``pda``'s decoder deepest first, and torch_em orders it so)."""

    def __init__(self, feats: Sequence[int], norm):
        super().__init__()
        levels = range(len(feats) - 2, -1, -1)
        self.samplers = nn.ModuleList(_Upsampler(feats[i + 1], feats[i]) for i in levels)
        self.blocks = nn.ModuleList(_DoubleConv(2 * feats[i], feats[i], norm) for i in levels)


class UNet2d(nn.Module):
    """Standalone 2D segmentation UNet, torch_em's ``UNet2d`` (reference
    LIVECell/livecell_unet.py, MitoEM/mitoem_unet.py), on (B, H, W, C).

    ``depth`` encoder blocks of ``initial_features * gain**i`` features, 2x2
    max pool down, a base block at ``initial_features * gain**depth``, then
    per level (deepest first) bilinear x2 + 1x1 sampler conv, concat
    [up | skip] and a block; a 1x1 ``out_conv`` and an optional sigmoid, all
    in float32. H and W must divide 2**depth.

    ``pda`` runs this model on XLA convolutions with no Pallas kernel, so the
    port runs it on ``F.conv2d`` (cuDNN on the card) and PyTorch's norm,
    pool and interpolation, with no kernel of its own either. Parameter
    names are torch_em's (``encoder.blocks.{i}.block.{1,4}``,
    ``base.block.{1,4}``, ``decoder.samplers.{i}.conv``,
    ``decoder.blocks.{i}.block.{1,4}``, ``out_conv``), so
    ``pda.models.convert.convert_unet_state_dict`` maps port -> ``pda`` and
    :func:`pda_torch.models.convert.unet_state_dict_from_pda` the other way.
    Weights are drawn from ``generator`` (default: a CPU generator seeded 0):
    LeCun-normal kernels (std 1/sqrt(fan_in), ``pda``'s flax default, here
    untruncated) and zero biases."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, depth: int = 4,
                 initial_features: int = 64, gain: int = 2,
                 final_activation: Optional[str] = "sigmoid",
                 norm: Optional[str] = "InstanceNorm",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        feats = [initial_features * gain ** i for i in range(depth + 1)]
        self.depth = depth
        self.final_activation = final_activation
        self.encoder = _Encoder(in_channels, feats[:-1], norm)
        self.base = _DoubleConv(feats[-2], feats[-1], norm)
        self.decoder = _Decoder(feats, norm)
        self.out_conv = nn.Conv2d(feats[0], out_channels, 1)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = math.prod(m.weight.shape[1:])
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   / math.sqrt(fan_in))
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        skips = []
        for block in self.encoder.blocks:
            h = block(h)
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = self.base(h)
        for sampler, block, skip in zip(self.decoder.samplers, self.decoder.blocks,
                                        reversed(skips)):
            h = block(torch.cat([sampler(h), skip], dim=1))
        h = self.out_conv(h)
        if (self.final_activation or "").lower() == "sigmoid":
            h = torch.sigmoid(h)
        return h.permute(0, 2, 3, 1).contiguous()
