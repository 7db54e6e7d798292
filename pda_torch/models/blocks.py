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

Row sharding (the (``data``, ``space``) mesh, :mod:`pda_torch.parallel`):
inside :func:`space_sharding` (the steps enter it on a 2-D mesh, as
``pda``'s engine enters its trace-time context) the image rows are sharded
over the space axis. A 3-conv block then extends its row shard by
:data:`HALO` rows from each neighbour (:func:`~pda_torch.parallel.space.halo_rows`),
runs the kernel route it runs unsharded on the extended rows
(:func:`conv_block_rows`) and crops; a shard at the image's edge is
extended on its inner side only, where the kernel's own SAME padding is the
unsharded block's (``pda`` extends it by zeros and recomputes its
``_EDGE_FIX`` rows from a strip). The align-corners upsample takes one row
from each neighbour (:func:`upsample_2x_align_corners_rows`). A block of
another depth raises.

Initialization follows ``pda`` (reference my_models/utils.py:17-28), each
draw from an explicit ``torch.Generator``:
  * conv kernels: He normal (fan_in, ReLU gain), untruncated
  * biases: normal truncated at 2 sigma, sigma = 1e-3
  * Fcomb / Gaussian-head kernels: orthogonal (gain 1)
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv_block import (autodiff_conv_relu, avg_pool_2x2, conv_block_fwd,
                                  conv_block_fwd_dual, conv_block_fwd_dual_mixed,
                                  conv_block_fwd_mixed, conv_block_fwd_pool)
from ..parallel.space import halo_rows

#: convs per block by default; the fused kernels implement exactly this depth
N_CONVS = 3
#: the compute dtypes a model takes: float32, or ``pda``'s bf16 configuration
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
#: rows a row shard takes from each neighbour before a 3-conv block: its
#: three convs reach 3 rows; even, so a pooled output crops by HALO / 2
HALO = 4
#: the fewest rows of a row shard at any block: ``pda``'s boundary-fix
#: minimum (``blocks._conv3_space_sharded``), kept so that the port accepts
#: and refuses the geometries ``pda``'s halo path does
MIN_SHARD_ROWS = 9

_SPACE = None


@contextlib.contextmanager
def space_sharding(space):
    """Image rows (H of NHWC) are sharded over ``space`` (a mesh's space
    axis, :meth:`pda_torch.parallel.Mesh.axis`) while the block runs
    (``pda``'s ``space_sharding``)."""
    global _SPACE
    prev, _SPACE = _SPACE, space
    try:
        yield
    finally:
        _SPACE = prev


def space_axis():
    """The space axis the rows are sharded over now, or None."""
    return _SPACE


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


def _upsample_matrix(n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(2n, n) align-corners bilinear interpolation matrix (``pda``'s
    ``blocks._upsample_matrix``): row t holds the lerp weights (1 - frac,
    frac) at columns (lo, hi), in float32 as ``pda``'s (or in ``dtype``)."""
    t = torch.arange(2 * n, dtype=torch.float64) * ((n - 1) / (2 * n - 1))
    lo = t.floor().long()
    hi = (lo + 1).clamp(max=n - 1)
    frac = (t - lo).to(dtype)
    mat = torch.zeros(2 * n, n, dtype=dtype)
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


@functools.lru_cache(maxsize=64)
def _upsample_rows_matrix(hl: int, n: int, s: int, dtype: torch.dtype) -> torch.Tensor:
    """Row shard ``s`` of ``n``'s block (2 hl, hl + 2) of the (2H, H)
    interpolation matrix, H = n hl, zero-padded by a column on each side."""
    m_full = F.pad(_upsample_matrix(hl * n, dtype), (1, 1))
    return m_full[2 * hl * s:2 * hl * (s + 1), hl * s:hl * s + hl + 2].contiguous()


def upsample_2x_align_corners_rows(x: torch.Tensor, space) -> torch.Tensor:
    """The align-corners x2 upsample of a row shard (``pda``'s
    ``upsample_2x_align_corners_sharded``): the shard's 2h output rows
    interpolate input rows ``[s h - 1, (s + 1) h]``, one row from each
    neighbour (a zero row at the image's edge, where its weight is 0), by
    the shard's block of the (2H, H + 2) interpolation matrix zero-padded by
    a column on each side, then the columns; a contraction in float32 too
    (``F.interpolate``'s CUDA backward adds with atomics), in bf16 as
    :func:`upsample_2x_align_corners` rounds. A space axis of 1 is the
    unsharded upsample."""
    if space is None or space.world == 1:
        return upsample_2x_align_corners(x)
    b, hl, w, c = x.shape
    s = space.rank
    (ext,), top, bottom = halo_rows((x,), 1, space)
    zero = x.new_zeros((b, 1, w, c))
    ext = torch.cat([*([] if top else [zero]), ext, *([] if bottom else [zero])], dim=1)
    # float32 weights, as pda's; a float64 reference run's in float64
    mdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    m_loc, ww = _upsample_rows_matrix(hl, space.world, s, mdt), _upsample_matrix(w, mdt)
    if x.dtype == _BF16:
        m_loc, ww = (m.to(_BF16).float().to(x.device) for m in (m_loc, ww))
        y = torch.einsum("Hh,bhwc->bHwc", m_loc, ext.float()).to(_BF16)
        return torch.einsum("Ww,bhwc->bhWc", ww, y.float()).to(_BF16).contiguous()
    m_loc, ww = (m.to(x.device, x.dtype) for m in (m_loc, ww))
    y = torch.einsum("Hh,bhwc->bHwc", m_loc, ext)
    return torch.einsum("Ww,bhwc->bhWc", ww, y).contiguous()


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
        if _SPACE is not None:
            raise ValueError("space sharding supports the 3-conv blocks only")
        return conv_relu_layers(x, convs)
    (x,), top, bottom = _extend((x,))
    return conv_block_rows(x, _weights(convs), top, bottom, pool_out=pool_out,
                           mixed=mixed_mode())


def _extend(xs) -> tuple:
    """``xs`` extended by :data:`HALO` rows from each space neighbour under
    :func:`space_sharding` (``(extended, top, bottom)``), else as they are;
    raises, with ``pda``'s reason, on a row shard of fewer than
    :data:`MIN_SHARD_ROWS` rows."""
    if _SPACE is None or _SPACE.world == 1:
        return tuple(xs), 0, 0
    h = xs[0].shape[1]
    if h < MIN_SHARD_ROWS:
        raise ValueError(f"row shards of {h} rows are too small for the boundary fix (need >= "
                         f"{MIN_SHARD_ROWS}); use fewer 'space' shards or larger images")
    ext, top, bottom = halo_rows(xs, HALO, _SPACE)
    return tuple(ext), top, bottom


def _crop(t: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    return t if top == bottom == 0 else t[:, top:t.shape[1] - bottom]


def conv_block_rows(x: torch.Tensor, weights, top: int = 0, bottom: int = 0, *,
                    xb: Optional[torch.Tensor] = None, pool_out: Optional[str] = None,
                    mixed: bool = False):
    """The fused 3-conv block (kernel weights ``[w1, b1, w2, b2, w3, b3]``,
    HWIO) on rows already extended by ``top`` rows above and ``bottom``
    below the shard's own, cropped back to the shard's rows: the single
    block, on ``[x | xb]`` with ``xb`` (the dual kernel), the pooled
    ``"with"``/``"only"`` block (:func:`conv_block`'s ``pool_out``, the
    pooled map cropped by half as many rows), each in the mixed mode with
    ``mixed``. With no extension it is the unsharded block."""
    if xb is not None:
        block = conv_block_fwd_dual_mixed if mixed else conv_block_fwd_dual
        return _crop(block(x.contiguous(), xb.contiguous(), *weights), top, bottom)
    if pool_out is None:
        block = conv_block_fwd_mixed if mixed else conv_block_fwd
        return _crop(block(x.contiguous(), *weights), top, bottom)
    out = conv_block_fwd_pool(x.contiguous(), *weights, keep_full=pool_out == "with",
                              mixed=mixed)
    if pool_out == "with":
        h3, pooled = out
        return _crop(h3, top, bottom), _crop(pooled, top // 2, bottom // 2)
    return _crop(out, top // 2, bottom // 2)


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
    kernel and never built on the card; row-sharded, the pair is extended
    in one exchange (``pda`` extends the concat: the same function)."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 n_convs: int = N_CONVS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_block = ConvBlock(in_channels + skip_channels, features, n_convs=n_convs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        up = upsample_2x_align_corners_rows(x, _SPACE)
        if up.shape[1:3] != bridge.shape[1:3]:
            raise ValueError(
                f"skip-connection shape mismatch: {tuple(up.shape)} vs {tuple(bridge.shape)}")
        up, bridge = compute(up, self.dtype).contiguous(), compute(bridge, self.dtype)
        convs = self.conv_block.convs()
        if len(convs) != N_CONVS:
            if _SPACE is not None:
                raise ValueError("space sharding supports the 3-conv blocks only")
            return conv_relu_layers(torch.cat([up, bridge], dim=-1), convs)
        (up, bridge), top, bottom = _extend((up, bridge))
        return conv_block_rows(up, _weights(convs), top, bottom, xb=bridge, mixed=mixed_mode())


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
