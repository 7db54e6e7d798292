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
raises. The kernel runs the mid layers on the tensor cores in 3xTF32 (one
small GEMM a sample, each warp's 16 feature rows held in registers across
the S samples), so it keeps float32 accuracy. It is built for every width C
that is a multiple of 8 up to 64; the wrapper zero-pads any other C up to 64
to the next of them. One class only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.consensus import LOWER_THRESHOLD, UPPER_THRESHOLD, consensus_from_logits
from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _F,
             _I, _VP)
#: feature widths the kernel is instantiated for; any other C up to the
#: largest is zero-padded to the next of them (:func:`_pad_width`)
KERNEL_WIDTHS = tuple(range(8, 65, 8))
MAX_WIDTH = KERNEL_WIDTHS[-1]
_THREADS = 256  # csrc/mc_consensus.cu THREADS: a warp a 16-pixel tile
_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90


def mc_logits_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b) -> torch.Tensor:
    """(S, B, H, W, n_out) logits of the Fcomb tail for every sample."""
    h = F.relu(feat_term[None] + z_terms[:, :, None, None, :])
    for w, b in zip(mid_w, mid_b):
        h = F.relu(h @ w + b)
    return h @ last_w + last_b


def mc_consensus_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b,
                       masking: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3."""
    logits = mc_logits_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b)
    return consensus_from_logits(logits, masking=masking)


def _smem_bytes(c: int, s: int, n_mid: int) -> int:
    """The kernel's shared memory: each mid layer's W split into TF32 hi and
    lo, with n_mid >= 2 a hidden layer per thread, the mid biases, the last
    weights and this image's S latent terms."""
    hidden = _THREADS * c // 2 if n_mid >= 2 else 0  # 16 rows x C a warp
    return 4 * (2 * n_mid * c * c + hidden + n_mid * c + c + s * c)


def padded_width(c: int) -> int:
    """The width the kernel runs a C-channel tail at: the next multiple of 8."""
    return -(-c // 8) * 8


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
    cp = padded_width(c)
    if _smem_bytes(cp, s, n_mid) > _MAX_SMEM:
        raise ValueError(f"S={s}, n_mid={n_mid} at C={c} exceed the kernel's shared memory")
    for name, t, shape in (
        ("feat_term", feat, (b, h, w, c)), ("z_terms", z_terms, (s, b, c)),
        ("mid_w", mid_w, (n_mid, c, c)), ("mid_b", mid_b, (n_mid, c)),
        ("last_w", last_w, (c, 1)), ("last_b", last_b, (1,)),
    ):
        _build.check_tensor(name, t, shape, dev)
    _build.check_forward_only("mc_consensus", feat, z_terms, mid_w, mid_b, last_w, last_b)
    if cp != c:
        feat, z_terms, mid_w, mid_b, last_w = _pad_width(cp, feat, z_terms, mid_w, mid_b,
                                                         last_w)
    if feat.data_ptr() % 8:
        raise ValueError("feat_term must be 8-byte aligned (the kernel reads it as float2)")
    mean = torch.empty((b, h, w, 1), device=dev, dtype=torch.float32)
    cons = torch.empty_like(mean)
    if mean.numel() == 0:
        return mean, cons
    fn = _build.entry("pda_mc_consensus", _ARGTYPES)
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

    feat_term (B, H, W, C); z_terms (S, B, C); mid_w (n_mid, C, C) as
    (in, out) matrices in the Fcomb's layer order; mid_b (n_mid, C);
    last_w (C, 1); last_b (1,). One class, and on the card C <= 64
    (:data:`MAX_WIDTH`); :func:`pda_torch.models.punet.mc_pseudo` sends any
    other tail through the plain version."""
    if feat_term.device.type == "cpu":
        return mc_consensus_plain(feat_term, z_terms, mid_w, mid_b, last_w, last_b, masking)
    if feat_term.device.type != "cuda":
        raise ValueError(f"mc_consensus runs on cpu or cuda, not {feat_term.device}")
    out = _launch(feat_term, z_terms, mid_w, mid_b, last_w, last_b, masking)
    mc_consensus.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
mc_consensus.launches = 0
