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

from .blocks import (N_CONVS, ComputeDtype, ConvBlock, ConvParams, UpBlock, dense, pool_out_plan,
                     space_axis)

_BF16 = torch.bfloat16
#: ``pda``'s reason (``UNet2d.__call__``) for refusing image rows sharded
#: over a space axis
UNET_SPACE_REFUSAL = ("UNet2d has no halo-exchange path (its half-pixel bilinear upsample and "
                      "2-conv blocks are not row-shard aware); pda runs it on a spatial mesh "
                      "through GSPMD, which the port does not have: use a data mesh")


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


def _norm_bf16(x: torch.Tensor) -> torch.Tensor:
    """``pda``'s ``GroupNorm(group_size=1, dtype=bf16)`` on NCHW: float32
    statistics over H and W per sample and channel (flax's fast variance,
    E[x^2] - E[x]^2 clipped at 0, biased; eps 1e-5), the normalized value
    computed in float32 and rounded to bf16 once."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp(min=0.0)
    return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(_BF16)


def _upsample_bf16(x: torch.Tensor) -> torch.Tensor:
    """``pda``'s bf16 upsample: bilinear x2 (half-pixel centers) in float32,
    rounded to bf16."""
    return F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                         align_corners=False).to(_BF16)


def _conv_bf16(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """flax's ``Conv(dtype=bf16)`` in ``pda``: bf16 operands, float32 sums,
    the sum rounded to bf16 with no bias, then the bf16 bias added in bf16, a
    second rounding (``F.conv2d``'s own bias would round once on the CPU)."""
    y = F.conv2d(x.to(_BF16), conv.weight.to(_BF16), None, padding=conv.padding)
    return y + conv.bias.to(_BF16).view(1, -1, 1, 1)


class _DoubleConv(ComputeDtype, nn.Module):
    """torch_em ``ConvBlock2d``: (InstanceNorm -> Conv3x3 -> ReLU) x 2 on
    NCHW, ``block`` = [norm, conv, relu, norm, conv, relu] (convs at 1 and
    4), or [conv, relu, conv, relu] without a norm. The norm is PyTorch's
    parameterless ``InstanceNorm2d`` (no affine, eps 1e-5, biased variance
    over H and W per sample and channel; ``pda``'s ``GroupNorm(group_size=1)``).
    In bf16 each layer rounds where ``pda``'s does (:func:`_norm_bf16`,
    :func:`_conv_bf16`, the ReLU in bf16)."""

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
        self.dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype != _BF16:
            return self.block(x)
        for m in self.block:
            if isinstance(m, nn.InstanceNorm2d):
                x = _norm_bf16(x)
            elif isinstance(m, nn.Conv2d):
                x = _conv_bf16(x, m)
            else:
                x = F.relu(x)
        return x


class _Upsampler(ComputeDtype, nn.Module):
    """torch_em ``Upsampler2d``: bilinear x2 (``align_corners=False``, half-
    pixel centers), then the 1x1 ``conv``; in bf16 :func:`_upsample_bf16`,
    then :func:`_conv_bf16`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)
        self.dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype != _BF16:
            return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear",
                                           align_corners=False))
        return _conv_bf16(_upsample_bf16(x), self.conv)


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


class UNet2d(ComputeDtype, nn.Module):
    """Standalone 2D segmentation UNet, torch_em's ``UNet2d`` (reference
    LIVECell/livecell_unet.py, MitoEM/mitoem_unet.py), on (B, H, W, C).

    ``depth`` encoder blocks of ``initial_features * gain**i`` features, 2x2
    max pool down, a base block at ``initial_features * gain**depth``, then
    per level (deepest first) bilinear x2 + 1x1 sampler conv, concat
    [up | skip] and a block; a 1x1 ``out_conv`` and an optional sigmoid.
    H and W must divide 2**depth.

    ``dtype``: the compute dtype, float32 or bf16 (``pda``'s
    ``UNet2d(dtype=...)``, which ``Trainer(mixed_precision=True)`` sets);
    the parameters stay float32. In bf16 the model rounds where ``pda``'s
    does (``pda/models/unet.py``): each norm once, each conv's sum and then
    its bias add, the pool and the concat in bf16, the upsample in float32
    rounded to bf16, the head conv in bf16 cast to float32 before the
    sigmoid. The output is float32 in either dtype.

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
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = [initial_features * gain ** i for i in range(depth + 1)]
        self.depth = depth
        self.final_activation = final_activation
        self.encoder = _Encoder(in_channels, feats[:-1], norm)
        self.base = _DoubleConv(feats[-2], feats[-1], norm)
        self.decoder = _Decoder(feats, norm)
        self.out_conv = nn.Conv2d(feats[0], out_channels, 1)
        self.dtype = dtype
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
        if space_axis() is not None:
            raise ValueError(UNET_SPACE_REFUSAL)
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
        h = self.out_conv(h) if self.dtype != _BF16 else _conv_bf16(h, self.out_conv).float()
        if (self.final_activation or "").lower() == "sigmoid":
            h = torch.sigmoid(h)
        return h.permute(0, 2, 3, 1).contiguous()
