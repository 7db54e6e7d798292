"""Kernels 1 and 2: the fused ConvBlock forward, single and dual input.

``conv_block_fwd(x, w1, b1, w2, b2, w3, b3)`` computes
``relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3)`` with 3x3 SAME
(zero-padded) convolutions: ``pda``'s ``conv3_relu`` (``pda/models/blocks.py``)
and its Pallas kernels (``pda/kernels/conv_block.py``,
``conv_block_packed.py``). ``conv_block_fwd_dual(xa, xb, ...)`` is the same
block on the channel concat ``[xa | xb]``, which the kernel reads from the
two tensors without building it (the decoder's ``[upsample | skip]``).

Tensors are NHWC float32, weights HWIO ``(3, 3, Cin, C)`` as in ``pda``,
biases ``(C,)``. On a CPU tensor the wrappers run the plain PyTorch
version (``*_plain``); on a CUDA tensor they launch the hand-written kernel
from ``csrc/conv_block_fwd.cu`` on the current stream, or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
             _I, _I, _I, _I, _VP)


def _conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One NCHW SAME conv + bias + ReLU with an HWIO weight."""
    return F.relu(F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1))


def conv_block_fwd_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of kernel 1."""
    h = x.permute(0, 3, 1, 2)
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = _conv_relu(h, w, b)
    return h.permute(0, 2, 3, 1).contiguous()


def conv_block_fwd_dual_plain(xa, xb, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of kernel 2: the block on ``cat([xa, xb])``."""
    return conv_block_fwd_plain(torch.cat([xa, xb], dim=-1), w1, b1, w2, b2, w3, b3)


def _launch(xa: torch.Tensor, xb: Optional[torch.Tensor], w1, b1, w2, b2, w3,
            b3) -> torch.Tensor:
    dev = xa.device
    if xa.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(xa.shape)}")
    bsz, h, w, ca = xa.shape
    cb = 0 if xb is None else xb.shape[-1]
    c = w1.shape[-1]
    _build.check_tensor("xa" if xb is not None else "x", xa, (bsz, h, w, ca), dev)
    if xb is not None:
        _build.check_tensor("xb", xb, (bsz, h, w, cb), dev)
    for name, t, shape in (
        ("w1", w1, (3, 3, ca + cb, c)), ("b1", b1, (c,)),
        ("w2", w2, (3, 3, c, c)), ("b2", b2, (c,)),
        ("w3", w3, (3, 3, c, c)), ("b3", b3, (c,)),
    ):
        _build.check_tensor(name, t, shape, dev)
    _build.check_forward_only("conv_block_fwd", xa, xb, w1, b1, w2, b2, w3, b3)
    out = torch.empty((bsz, h, w, c), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    h1 = torch.empty_like(out)
    h2 = torch.empty_like(out)
    fn = _build.entry("pda_conv_block_fwd", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(xa.data_ptr(), None if xb is None else xb.data_ptr(), ca, cb,
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  w3.data_ptr(), b3.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                  out.data_ptr(), bsz, h, w, c, stream)
    _build.check(code, "conv_block_fwd")
    return out


def conv_block_fwd(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Kernel 1: the fused ConvBlock forward, (B, H, W, Cin) -> (B, H, W, C)."""
    if x.device.type == "cpu":
        return conv_block_fwd_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_fwd runs on cpu or cuda, not {x.device}")
    out = _launch(x, None, w1, b1, w2, b2, w3, b3)
    conv_block_fwd.launches += 1
    return out


def conv_block_fwd_dual(xa, xb, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Kernel 2: the fused ConvBlock forward on ``[xa | xb]`` (channels)."""
    if xa.device.type == "cpu":
        return conv_block_fwd_dual_plain(xa, xb, w1, b1, w2, b2, w3, b3)
    if xa.device.type != "cuda":
        raise ValueError(f"conv_block_fwd_dual runs on cpu or cuda, not {xa.device}")
    out = _launch(xa, xb, w1, b1, w2, b2, w3, b3)
    conv_block_fwd_dual.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
conv_block_fwd.launches = 0
conv_block_fwd_dual.launches = 0
