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
upsample is a PyTorch op that autograd differentiates.

The 2x2 pools of the contracting pyramids: a 3-conv block whose output feeds
a pool (every level but the last of :class:`~.unet.PUNetBackbone`, of the
prior's and of the posterior's :class:`EncoderPyramid`) runs as
:func:`~pda_torch.kernels.conv_block.conv_block_fwd_pool`, the block and the
pool of its output, whose backward is one fused backward launch that reads
the pooled cotangent (``pda``'s ``gpf``): the backbone's "with" variant
(the skip and the pooled map), the encoders' "only" variant; the next
block then takes the pooled map and pools nothing itself. ``pda`` fuses
only level 0, because its lane packing gates the fusion
(``packed_pool_out_eligible``); the port fuses every pooled level, the same
function: 9 blocks of a PUNet student pass. A block of another depth, and
:func:`conv_block` / :class:`ConvBlock` called alone, pool their input under
autograd, as ``pda``'s unfused path does.

``PDA_PALLAS_CONV_MODE``, read at each call as ``pda``'s ``ConvBlock``
reads it: ``"mixed"`` runs every 3-conv block (single, dual and pooled) in
``pda``'s memory-lean mode (``conv3_relu_mixed``): the forward as ``pda``'s
XLA convs (cuDNN on the card), only the input and h3 kept, the fused
backward recomputing h1 and h2 (:mod:`pda_torch.kernels.conv_block`); any
other value, or none, the default path.

Compute dtype: every module here carries ``dtype`` (float32, or bf16 for
``pda``'s bf16 configuration; :class:`ComputeDtype`). The parameters stay
float32. A bf16 block casts its input to bf16 (``pda``'s
``x.astype(self.dtype)``) and runs the bf16 kernels, which round as
``pda``'s Pallas kernels do (:mod:`pda_torch.kernels.conv_block`); the
pool, the upsample and the Dense layers follow ``pda``'s XLA code in bf16
(:func:`avg_pool_2x2`, :func:`upsample_2x_align_corners`, :func:`dense`).

Initialization follows ``pda`` (reference my_models/utils.py:17-28), each
draw from an explicit ``torch.Generator``:
  * conv kernels: He normal (fan_in, ReLU gain), untruncated
  * biases: normal truncated at 2 sigma, sigma = 1e-3
  * Fcomb / Gaussian-head kernels: orthogonal (gain 1)
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv_block import (autodiff_conv_relu, avg_pool_2x2, conv_block_fwd,
                                  conv_block_fwd_dual, conv_block_fwd_dual_mixed,
                                  conv_block_fwd_mixed, conv_block_fwd_pool)

#: convs per block by default; the fused kernels implement exactly this depth
N_CONVS = 3
#: the compute dtypes a model takes: float32, or ``pda``'s bf16 configuration
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16


class ComputeDtype:
    """Mixin of the modules that carry a compute ``dtype``. Setting it on a
    module sets it on every such module inside (a model is in one dtype, as
    ``pda``'s ``clone(dtype=...)`` makes it); the parameters are untouched."""

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @dtype.setter
    def dtype(self, value: torch.dtype) -> None:
        if value not in COMPUTE_DTYPES:
            raise ValueError(f"dtype must be float32 or bfloat16, got {value}")
        for m in self.modules():
            if isinstance(m, ComputeDtype):
                m._dtype = value


def compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a bf16 compute dtype; in float32 unchanged (so a float64
    reference run of a float32 model stays float64)."""
    return x.to(dtype) if dtype == _BF16 else x


def dense(x: torch.Tensor, w: torch.Tensor, b=None, dtype: torch.dtype = torch.float32):
    """``x @ w + b``; in bf16 as flax's ``Dense(dtype=bf16)`` in ``pda``: bf16
    operands, the product rounded to bf16, then the bias (rounded to bf16)
    added in bf16. Returns bf16 there, else x's dtype."""
    if dtype != _BF16:
        return x @ w if b is None else x @ w + b
    y = (x.to(_BF16).float() @ w.to(_BF16).float()).to(_BF16)
    return y if b is None else y + b.to(_BF16)


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


def mixed_mode() -> bool:
    """Whether ``PDA_PALLAS_CONV_MODE`` is ``"mixed"`` now (``pda`` reads it
    at each block call; any other value is its default, ``"full"``)."""
    return os.environ.get("PDA_PALLAS_CONV_MODE", "full") == "mixed"


def _upsample_matrix(n: int) -> torch.Tensor:
    """(2n, n) align-corners bilinear interpolation matrix (``pda``'s
    ``blocks._upsample_matrix``): row t holds the lerp weights (1 - frac,
    frac) at columns (lo, hi)."""
    t = torch.arange(2 * n, dtype=torch.float64) * ((n - 1) / (2 * n - 1))
    lo = t.floor().long()
    hi = (lo + 1).clamp(max=n - 1)
    frac = (t - lo).float()
    mat = torch.zeros(2 * n, n)
    rows = torch.arange(2 * n)
    mat.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    mat.index_put_((rows, hi), frac, accumulate=True)
    return mat


def upsample_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsampling of (B, H, W, C), ``align_corners=True``. In
    bf16 as ``pda`` upsamples bf16: two contractions with the interpolation
    matrices in bf16, rows then columns, each summed in float32 and rounded
    to bf16."""
    if x.dtype == _BF16:
        _, h, w, _ = x.shape
        wh = _upsample_matrix(h).to(_BF16).float().to(x.device)
        ww = _upsample_matrix(w).to(_BF16).float().to(x.device)
        x = torch.einsum("Hh,bhwc->bHwc", wh, x.float()).to(_BF16)
        return torch.einsum("Ww,bhwc->bhWc", ww, x.float()).to(_BF16).contiguous()
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
    path of a block whose depth the fused kernels do not take. A bf16 ``x``
    as ``pda``'s autodiff convs compute it: the conv of bf16 operands
    rounded to bf16, then the bias (in bf16) added in bf16."""
    h = x.permute(0, 3, 1, 2)
    for c in convs:
        h = autodiff_conv_relu(h, c.weight, c.bias)
    return h.permute(0, 2, 3, 1).contiguous()


def conv_block(x: torch.Tensor, convs: Sequence[ConvParams], pool: bool,
               dtype: torch.dtype = torch.float32, pool_out: Optional[str] = None):
    """[2x2 avg pool] + n x (conv3x3 + bias + ReLU) on (B, H, W, C), the
    pool in x's dtype, the convs in ``dtype``: the fused kernel at 3 convs
    (its mixed mode under ``PDA_PALLAS_CONV_MODE=mixed``),
    :func:`conv_relu_layers` at any other depth.

    ``pool_out`` (``pda``'s ConvBlock argument; 3 convs only): ``"only"``
    returns the 2x2 average pool of the block's output instead of the
    output, ``"with"`` the pair ``(output, pooled)``; one call of
    :func:`~pda_torch.kernels.conv_block.conv_block_fwd_pool`, whose backward
    reads the pool's cotangent in the fused backward launch."""
    if pool_out not in (None, "only", "with") or (pool_out and len(convs) != N_CONVS):
        raise ValueError(f"pool_out takes None, or 'only' or 'with' on a {N_CONVS}-conv "
                         f"block, got {pool_out!r} on {len(convs)} convs")
    if pool:
        x = avg_pool_2x2(x)
    x = compute(x, dtype)
    if len(convs) != N_CONVS:
        return conv_relu_layers(x, convs)
    if pool_out is not None:
        return conv_block_fwd_pool(x.contiguous(), *_weights(convs),
                                   keep_full=pool_out == "with", mixed=mixed_mode())
    block = conv_block_fwd_mixed if mixed_mode() else conv_block_fwd
    return block(x.contiguous(), *_weights(convs))


def pool_out_plan(depth: int, convs_per_block: int) -> list:
    """Which blocks of a contracting pyramid of ``depth`` levels pool their
    own output (fused): every 3-conv block but the last, each feeding the
    next level, which then pools nothing itself."""
    return [i < depth - 1 and convs_per_block == N_CONVS for i in range(depth)]


class ConvBlock(ComputeDtype, nn.Module):
    """[AvgPool] + n_convs x (Conv3x3 + ReLU): reference ``DownConvBlock``
    (``layers`` = [pool,] conv, relu, conv, relu, conv, relu at 3 convs)."""

    def __init__(self, in_channels: int, features: int, pool: bool = False,
                 n_convs: int = N_CONVS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pool = pool
        self.layers = nn.Sequential(
            *([nn.AvgPool2d(2)] if pool else []),
            *_conv_layers(in_channels, features, n_convs))

    def convs(self) -> list:
        return [m for m in self.layers if isinstance(m, ConvParams)]

    def forward(self, x: torch.Tensor, pool: Optional[bool] = None,
                pool_out: Optional[str] = None):
        """The block on ``x``; ``pool`` overrides the block's own input pool
        (False where the block before already pooled its output);
        ``pool_out``: :func:`conv_block`'s."""
        return conv_block(x, self.convs(), self.pool if pool is None else pool, self.dtype,
                          pool_out)


class UpBlock(ComputeDtype, nn.Module):
    """Bilinear x2 upsample + skip concat + ConvBlock (reference
    ``UpConvBlock``). The concat [upsample | skip] is read by the dual-input
    kernel and never built on the card."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 n_convs: int = N_CONVS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_block = ConvBlock(in_channels + skip_channels, features, n_convs=n_convs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        up = upsample_2x_align_corners(x)
        if up.shape[1:3] != bridge.shape[1:3]:
            raise ValueError(
                f"skip-connection shape mismatch: {tuple(up.shape)} vs {tuple(bridge.shape)}")
        up, bridge = compute(up, self.dtype).contiguous(), compute(bridge, self.dtype)
        convs = self.conv_block.convs()
        if len(convs) != N_CONVS:
            return conv_relu_layers(torch.cat([up, bridge], dim=-1), convs)
        block = conv_block_fwd_dual_mixed if mixed_mode() else conv_block_fwd_dual
        return block(up, bridge.contiguous(), *_weights(convs))


class EncoderPyramid(ComputeDtype, nn.Module):
    """Contracting pyramid of ConvBlocks, a pool before every block but the
    first: reference ``Encoder``, whose ``layers`` is ONE Sequential with the
    pools interleaved."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], n_convs: int = N_CONVS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
        pooled = False
        for i, fuse in enumerate(pool_out_plan(self.depth, n)):
            x = conv_block(x, convs[n * i:n * (i + 1)], pool=i > 0 and not pooled,
                           dtype=self.dtype, pool_out="only" if fuse else None)
            pooled = fuse
        return x
