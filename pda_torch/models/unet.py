"""The UNet inside the PUNet (port of ``pda/models/unet.py`` PUNetBackbone), NHWC."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import ConvBlock, UpBlock


class PUNetBackbone(nn.Module):
    """4-level UNet, AvgPool down, bilinear align-corners up, no head
    (reference ``apply_last_layer=False``: the Fcomb is the head). Returns
    the last decoder map, ``num_filters[0]`` channels.

    ``upsampling_path[0]`` is the DEEPEST up block, as in the reference and
    in ``pda`` (flax names ``UpBlock_{i}`` in creation order, deepest first).
    """

    def __init__(self, input_channels: int = 1,
                 num_filters: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        nf = tuple(num_filters)
        cins = (input_channels, *nf[:-1])
        self.contracting_path = nn.ModuleList(
            ConvBlock(cin, f, pool=i > 0) for i, (cin, f) in enumerate(zip(cins, nf)))
        self.upsampling_path = nn.ModuleList(
            UpBlock(nf[i + 1], nf[i], nf[i]) for i in range(len(nf) - 2, -1, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for block in self.contracting_path:
            x = block(x)
            skips.append(x)
        for up, bridge in zip(self.upsampling_path, reversed(skips[:-1])):
            x = up(x, bridge)
        return x
