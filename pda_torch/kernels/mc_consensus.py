"""Kernel 3: the fused Monte-Carlo Fcomb tail + consensus.

Port of ``pda/kernels/mc_consensus.py`` ``mc_consensus_decode``. Given the
shared Fcomb feature term ``(B, H, W, C)`` and the S latent terms
``z @ W_z + b_z`` ``(S, B, C)``, it returns the pseudo-label (mean sigmoid
over the S decoded samples) and the consensus (confident-band fraction, or
unanimity with ``masking``), each ``(B, H, W, 1)`` float32, without writing
the ``S x B x H x W x C`` hidden stack to device memory.

On a CPU tensor the wrapper runs the plain PyTorch version (the batched
Fcomb tail + :func:`pda_torch.core.consensus.consensus_from_logits`); on a
CUDA tensor it launches ``csrc/mc_consensus.cu`` on the current stream, or
raises. A float32 ``feat_term`` runs ``mc_consensus_wgmma_tf32<C, NMID>``:
Hopper's ``wgmma``, each mid layer one 3xTF32 chain a sample over a
warpgroup's 64-pixel tile (A split in registers, the feature rows held in
registers across the S samples, W split once a block into hi and lo planes
in shared memory), three warpgroups an SM taking turns on the tensor cores,
one wave of persistent blocks (:func:`one_wave_grid`), the last layer on the
FMA pipes: float32 accuracy. It is built for every width C that is a
multiple of 8 up to 64; the wrapper zero-pads any other C up to 64 to the
next of them. One class only. Every float32 launch is on that body and
counts in ``launches_wgmma_f32`` as well as in ``launches``.

bf16 (``pda``'s bf16 configuration): a bf16 ``feat_term`` runs the bf16
body ``mc_consensus_wgmma<C, NMID>`` (C a multiple of 16; Hopper's
``wgmma``, two samples in flight a warpgroup, the last layer on the tensor
cores too), at the rounding points of ``pda``'s kernel
(``pda/kernels/mc_consensus.py`` ``_kernel``): the float32 latent row
rounded to bf16, ``h = relu(feat + z)`` rounded to bf16 (one rounding of
the exact sum, which is what ``pda``'s float32 add and rounding give:
:func:`packed_entry`), each mid layer on bf16 operands (the float32 kernels
cast inside, ``pda``'s ``mid_kernels.astype(dtype)``) summed in float32
with the float32 bias, ReLU and one rounding to bf16, the last layer a
float32 sum of bf16 products plus the float32 bias: float32 logits, whose
sigmoid mean and consensus are taken in float32. :func:`mc_logits_plain`
computes the same on any device. Outputs are float32 in both dtypes. Every
bf16 launch is on that body and counts in ``launches_wgmma_bf16`` as well
as in ``launches_bf16``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.consensus import LOWER_THRESHOLD, UPPER_THRESHOLD, consensus_from_logits
from . import _build
from .conv_block import FWD_MODES, bf16_operand, count_launch, plain_acc, runs_plain

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _F,
             _I, _VP)
#: feature widths the kernel is instantiated for; any other C up to the
#: largest is zero-padded to the next of them (:func:`_pad_width`)
KERNEL_WIDTHS = tuple(range(8, 65, 8))
#: ... for the bf16 instance (its k-step takes 16 channels)
KERNEL_WIDTHS_BF16 = tuple(range(16, 65, 16))
MAX_WIDTH = KERNEL_WIDTHS[-1]
_BF16 = torch.bfloat16
_THREADS = 128  # csrc/mc_consensus.cu mcw::THREADS: a warpgroup, a 64-pixel tile
_TILE = 64  # pixels a warpgroup's tile
_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_LAST_N = 8  # csrc/mc_consensus.cu mcw::LAST_N: the bf16 last layer's N (and B operands)


def mc_logits_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b) -> torch.Tensor:
    """(S, B, H, W, n_out) logits of the Fcomb tail for every sample; with a
    bf16 ``feat_term`` at the bf16 kernel's rounding points (the products
    summed in ``conv_block.plain_acc``), float32 logits."""
    if feat_term.dtype == _BF16:
        acc = plain_acc(feat_term)
        z = z_terms.to(_BF16).to(acc)[:, :, None, None, :]
        h = F.relu(feat_term.to(acc)[None] + z).to(_BF16).to(acc)
        for w, b in zip(mid_w, mid_b):
            h = F.relu(h @ bf16_operand(w, acc) + b.to(acc)).to(_BF16).to(acc)
        return (h @ bf16_operand(last_w, acc) + last_b.to(acc)).float()
    h = F.relu(feat_term[None] + z_terms[:, :, None, None, :])
    for w, b in zip(mid_w, mid_b):
        h = F.relu(h @ w + b)
    return h @ last_w + last_b


def mc_consensus_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b,
                       masking: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3."""
    logits = mc_logits_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b)
    return consensus_from_logits(logits, masking=masking)


def _smem_bytes(c: int, s: int, n_mid: int, dtype=torch.float32) -> int:
    """The kernel's shared memory (``mcw::LayoutF32``): each mid layer's W
    split into a TF32 hi and a lo plane (8 bytes a weight), the mid biases,
    the last weights and this image's S latent terms, float32. In bf16
    (``mcw::Layout``) each mid layer's W as bf16, the last layer's 8 B
    operands (C x 8 bf16 each, w_last in column c of the c-th), each latent
    row as bf16 pairs padded to whole 16-byte loads for each of a warp's four
    lane quads, the mid biases."""
    if dtype == _BF16:
        z_words = -(-(c // 8) // 4) * 4  # mcw::z_words
        return (2 * n_mid * c * c + 2 * _LAST_N * _LAST_N * c + 16 * z_words * s
                + 4 * n_mid * c)
    return 8 * n_mid * c * c + 4 * (n_mid * c + c + s * c)


def one_wave_grid(hw: int, b: int, resident: int) -> Tuple[int, int]:
    """The grid both bodies launch (``csrc/mc_consensus.cu`` ``one_wave``):
    (64-pixel tiles a block, blocks an image), so that the batch's tiles
    spread over the ``resident`` blocks the card holds at once and each
    block sets up its shared memory once for all its tiles. Block x of an
    image takes its tiles [x T, (x + 1) T), the last block the rest."""
    tiles = -(-hw // _TILE)
    per_block = -(-(tiles * b) // resident)
    return per_block, -(-tiles // per_block)


def padded_width(c: int, dtype=torch.float32) -> int:
    """The width the kernel runs a C-channel tail at: the next multiple of 8
    (bf16: of 16, the bf16 fragment's k-step)."""
    k = 16 if dtype == _BF16 else 8
    return -(-c // k) * k


def _pad_width(cp: int, feat, z_terms, mid_w, mid_b, last_w):
    """Zero channels up to ``cp``: a zero channel stays relu(0 + 0) = 0
    through every layer (zero rows and columns of mid_w, zero bias) and meets
    a zero row of last_w, so it adds nothing to the logit."""
    p = cp - feat.shape[-1]
    return (F.pad(feat, (0, p)), F.pad(z_terms, (0, p)), F.pad(mid_w, (0, p, 0, p)),
            F.pad(mid_b, (0, p)), F.pad(last_w, (0, 0, 0, p)))


def _launch(feat, z_terms, mid_w, mid_b, last_w, last_b, masking):
    dev = feat.device
    if feat.ndim != 4 or z_terms.ndim != 3 or mid_w.ndim != 3:
        raise ValueError(
            "expected feat_term (B, H, W, C), z_terms (S, B, C), mid_w (n_mid, C, C)"
        )
    b, h, w, c = feat.shape
    s, n_mid = z_terms.shape[0], mid_w.shape[0]
    if not 1 <= c <= MAX_WIDTH:
        raise ValueError(f"mc_consensus kernel takes 1 <= C <= {MAX_WIDTH}, got {c}")
    if s < 1:
        raise ValueError("mc_consensus needs at least one sample")
    _build.check_tensor("feat_term", feat, (b, h, w, c), dev, _build.FLOAT32_BF16)
    dtype = feat.dtype
    cp = padded_width(c, dtype)
    if _smem_bytes(cp, s, n_mid, dtype) > _MAX_SMEM:
        raise ValueError(f"S={s}, n_mid={n_mid} at C={c} exceed the kernel's shared memory")
    for name, t, shape in (
        ("z_terms", z_terms, (s, b, c)), ("mid_w", mid_w, (n_mid, c, c)),
        ("mid_b", mid_b, (n_mid, c)), ("last_w", last_w, (c, 1)), ("last_b", last_b, (1,)),
    ):
        _build.check_tensor(name, t, shape, dev)
    _build.check_forward_only("mc_consensus", feat, z_terms, mid_w, mid_b, last_w, last_b)
    if cp != c:
        feat, z_terms, mid_w, mid_b, last_w = _pad_width(cp, feat, z_terms, mid_w, mid_b,
                                                         last_w)
    if dtype == _BF16:  # the kernels as the bf16 instance reads them
        mid_w, last_w = mid_w.to(dtype), last_w.to(dtype)
    if feat.data_ptr() % (8 if dtype == torch.float32 else 4):
        raise ValueError("feat_term must be 8-byte aligned (4 in bf16: the kernel reads "
                         "channel pairs)")
    mean = torch.empty((b, h, w, 1), device=dev, dtype=torch.float32)
    cons = torch.empty_like(mean)
    if mean.numel() == 0:
        return mean, cons
    fn = _build.entry("pda_mc_consensus" + ("_bf16" if dtype == _BF16 else ""), _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            feat.data_ptr(), z_terms.data_ptr(), mid_w.data_ptr(), mid_b.data_ptr(),
            last_w.data_ptr(), last_b.data_ptr(), mean.data_ptr(), cons.data_ptr(),
            b, h * w, cp, s, n_mid,
            math.log(UPPER_THRESHOLD / (1.0 - UPPER_THRESHOLD)),
            math.log(LOWER_THRESHOLD / (1.0 - LOWER_THRESHOLD)),
            int(masking), stream,
        )
    _build.check(code, "mc_consensus")
    return mean, cons


def mc_consensus(feat_term, z_terms, mid_w, mid_b, last_w, last_b,
                 masking: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: (pseudo, consensus), each (B, H, W, 1) float32.

    feat_term (B, H, W, C) float32 or bf16 (the bf16 instance); z_terms
    (S, B, C); mid_w (n_mid, C, C) as (in, out) matrices in the Fcomb's layer
    order; mid_b (n_mid, C); last_w (C, 1); last_b (1,), all float32. One
    class, and on the card C <= 64
    (:data:`MAX_WIDTH`); :func:`pda_torch.models.punet.mc_pseudo` sends any
    other tail through the plain version."""
    if runs_plain(feat_term, "mc_consensus"):
        return mc_consensus_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b, masking)
    out = _launch(feat_term, z_terms, mid_w, mid_b, last_w, last_b, masking)
    count_launch(mc_consensus, feat_term.dtype, FWD_MODES)
    return out


#: launches of the CUDA kernel since the count was last set to 0: its
#: float32 instance (``launches``), its bf16 instance (``launches_bf16``)
#: and of those the launches on the ``wgmma`` bodies (``launches_wgmma_f32``,
#: ``launches_wgmma_bf16``: all of them)
mc_consensus.launches = mc_consensus.launches_bf16 = 0
mc_consensus.launches_wgmma_f32 = mc_consensus.launches_wgmma_bf16 = 0


def packed_entry_plain(f: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``relu(f + z)`` of two bf16 tensors as ``pda`` forms the bf16 tail's
    layer entry: the float32 sum rounded to bf16, then ReLU."""
    return F.relu(f.float() + z.float()).to(_BF16)


def packed_entry(f: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The bf16 tail's layer entry as the ``wgmma`` body forms it (one
    ``fma.rn.relu.bf16x2`` of ``f * 1 + z`` a channel pair), on two bf16
    tensors of one shape with an even number of elements: the card's check
    that it rounds as :func:`packed_entry_plain`. On a CPU tensor, the
    plain version."""
    if runs_plain(f, "packed_entry"):
        return packed_entry_plain(f, z)
    for name, t in (("f", f), ("z", z)):
        _build.check_tensor(name, t, f.shape, f.device, (_BF16,))
    if f.numel() % 2:
        raise ValueError("packed_entry takes an even number of elements (bf16 pairs)")
    out = torch.empty_like(f)
    fn = _build.entry("pda_mc_bf16_entry", (_VP, _VP, _VP, _I, _VP))
    with torch.cuda.device(f.device):
        code = fn(f.data_ptr(), z.data_ptr(), out.data_ptr(), f.numel() // 2,
                  torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(code, "packed_entry")
    return out
