"""Kernels 1 and 2, the fused ConvBlock forward (single and dual input),
and their backward.

``conv_block_fwd(x, w1, b1, w2, b2, w3, b3)`` computes
``relu(conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3)`` with 3x3 SAME
(zero-padded) convolutions: ``pda``'s ``conv3_relu`` (``pda/models/blocks.py``)
and its Pallas kernels (``pda/kernels/conv_block.py``,
``conv_block_packed.py``). ``conv_block_fwd_dual(xa, xb, ...)`` is the same
block on the channel concat ``[xa | xb]``, which the kernel reads from the
two tensors without building it (the decoder's ``[upsample | skip]``).

Both are differentiable. Each is a ``torch.autograd.Function`` whose forward
keeps h1, h2 and the output h3 (``pda``'s ``save_intermediates=True``) and
whose backward is :func:`conv_block_bwd` / :func:`conv_block_bwd_dual`, the
fused ConvBlock backward of ``csrc/conv_block_bwd.cu`` (``pda``'s
``conv_block_bwd*.py`` and ``conv_block_packed_bwd*.py``). dx is computed
only when autograd asks for it: an entry block, whose input is the image,
takes none (``pda``'s ``need_dx=False``).

Tensors are NHWC float32, weights HWIO ``(3, 3, Cin, C)`` as in ``pda``,
biases ``(C,)``. On a CPU tensor the wrappers run the plain PyTorch
versions (``*_plain``); on a CUDA tensor they launch the hand-written kernels
on the current stream, or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = (_VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                 _I, _I, _I, _I, _VP)
# x, Cin, w1..w3, h1..h3, g, dx, dw1, db1, .., db3, dh2, dh1, wt, work, B, H, W, C, need_dx
_BWD_ARGTYPES = (_VP, _I, *[_VP] * 18, *[_I] * 5, _VP)
# xa, xb, Ca, Cb, w1..w3, h1..h3, g, dxa, dxb, dw1, .., db3, dh2, dh1, wt, work, B, H, W, C
_BWD_DUAL_ARGTYPES = (_VP, _VP, _I, _I, *[_VP] * 19, *[_I] * 4, _VP)


def _conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One NCHW SAME conv + bias + ReLU with an HWIO weight."""
    return F.relu(F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1))


def _plain_layers(x, w1, b1, w2, b2, w3, b3) -> list:
    """[h1, h2, h3] of the plain forward, each an NCHW view."""
    hs, h = [], x.permute(0, 3, 1, 2)
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = _conv_relu(h, w, b)
        hs.append(h)
    return hs


def conv_block_fwd_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of kernel 1."""
    return _plain_layers(x, w1, b1, w2, b2, w3, b3)[-1].permute(0, 2, 3, 1).contiguous()


def conv_block_fwd_dual_plain(xa, xb, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of kernel 2: the block on ``cat([xa, xb])``."""
    return conv_block_fwd_plain(torch.cat([xa, xb], dim=-1), w1, b1, w2, b2, w3, b3)


def _wgrad_plain(h_in: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """``pda``'s ``_wgrad``: ``dW[ky, kx] = sum over B, H, W of the input
    shifted by (ky-1, kx-1), zero-padded, times da``; NHWC in, HWIO out.
    (cuDNN's float32 wgrad is about 1e-4 of its largest value off a float64
    reference at the MT step's shapes; these matmuls, about 1e-6.)"""
    h, w, ci = h_in.shape[1:]
    xp = F.pad(h_in, (0, 0, 1, 1, 1, 1))
    da2 = da.reshape(-1, da.shape[-1])
    return torch.stack([torch.stack([xp[:, ky:ky + h, kx:kx + w].reshape(-1, ci).t() @ da2
                                     for kx in range(3)]) for ky in range(3)])


def conv_block_bwd_plain(g, x, h1, h2, h3, w1, w2, w3, need_dx: bool = True):
    """Plain PyTorch version of the ConvBlock backward: ``pda``'s hand VJP
    (``blocks.py`` ``_conv3_bwd``). For layer 3, 2, 1: the ReLU mask
    ``da = dh * [h > 0]``, the weight gradient summed over B, H, W
    (:func:`_wgrad_plain`), the bias gradient ``sum(da)``, and the dgrad, a
    SAME conv of ``da`` with the kernel flipped in space and its in/out
    channels swapped.

    Returns ``(dx or None, dw1, db1, dw2, db2, dw3, db3)``: dx NHWC, dW HWIO."""
    dout, grads = g, []
    for k, (h_out, h_in, w) in enumerate(((h3, h2, w3), (h2, h1, w2), (h1, x, w1))):
        da = torch.where(h_out > 0, dout, 0.0)
        grads = [_wgrad_plain(h_in, da), da.sum(dim=(0, 1, 2))] + grads
        dout = (F.conv2d(da.permute(0, 3, 1, 2), w.flip(0, 1).permute(2, 3, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
                if k < 2 or need_dx else None)
    dx = None if dout is None else dout.contiguous()
    return (dx, *grads)


def conv_block_bwd_dual_plain(g, xa, xb, h1, h2, h3, w1, w2, w3):
    """Plain PyTorch version of the dual backward: the block's backward on
    ``cat([xa, xb])``, dx split back. Returns ``(dxa, dxb, dw1, .., db3)``."""
    dx, *grads = conv_block_bwd_plain(g, torch.cat([xa, xb], dim=-1), h1, h2, h3,
                                      w1, w2, w3)
    ca = xa.shape[-1]
    return (dx[..., :ca].contiguous(), dx[..., ca:].contiguous(), *grads)


def _check_block(xa: torch.Tensor, xb: Optional[torch.Tensor], w1, w2, w3, b=()):
    """Check the block's input and weights; return (B, H, W, Ca, Cb, C)."""
    dev = xa.device
    if xa.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(xa.shape)}")
    bsz, h, w, ca = xa.shape
    cb = 0 if xb is None else xb.shape[-1]
    c = w1.shape[-1]
    _build.check_tensor("xa" if xb is not None else "x", xa, (bsz, h, w, ca), dev)
    if xb is not None:
        _build.check_tensor("xb", xb, (bsz, h, w, cb), dev)
    for name, t, shape in (("w1", w1, (3, 3, ca + cb, c)), ("w2", w2, (3, 3, c, c)),
                           ("w3", w3, (3, 3, c, c))):
        _build.check_tensor(name, t, shape, dev)
    for j, t in enumerate(b):
        _build.check_tensor(f"b{j + 1}", t, (c,), dev)
    return bsz, h, w, ca, cb, c


def _launch(xa: torch.Tensor, xb: Optional[torch.Tensor], w1, b1, w2, b2, w3, b3):
    """(h1, h2, h3) of the forward kernel."""
    dev = xa.device
    bsz, h, w, ca, cb, c = _check_block(xa, xb, w1, w2, w3, (b1, b2, b3))
    h1, h2, h3 = (torch.empty((bsz, h, w, c), device=dev, dtype=torch.float32)
                  for _ in range(3))
    if h3.numel() == 0:
        return h1, h2, h3
    fn = _build.entry("pda_conv_block_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(xa.data_ptr(), None if xb is None else xb.data_ptr(), ca, cb,
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  w3.data_ptr(), b3.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                  h3.data_ptr(), bsz, h, w, c, stream)
    _build.check(code, "conv_block_fwd")
    return h1, h2, h3


def _launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx: bool):
    """(dxa or None, dxb or None, dw1, db1, dw2, db2, dw3, db3) of the
    backward kernel; the dual entry (xb given) always computes dxa, dxb."""
    dev = xa.device
    bsz, h, w, ca, cb, c = _check_block(xa, xb, w1, w2, w3)
    for name, t in (("g", g), ("h1", h1), ("h2", h2), ("h3", h3)):
        _build.check_tensor(name, t, (bsz, h, w, c), dev)
    need_dx = need_dx or xb is not None
    dxa = torch.empty_like(xa) if need_dx else None
    dxb = None if xb is None else torch.empty_like(xb)
    grads = [torch.empty_like(w1), w1.new_empty(c), torch.empty_like(w2), w1.new_empty(c),
             torch.empty_like(w3), w1.new_empty(c)]
    if g.numel() == 0:
        return tuple(None if t is None else t.zero_() for t in (dxa, dxb, *grads))
    n_work = _build.entry("pda_conv_block_bwd_work", (_I,) * 5, ctypes.c_longlong)(
        bsz, h, w, ca + cb, c)
    work = w1.new_empty(n_work)
    wt = w1.new_empty(9 * max(ca + cb, c) * c)
    dh2, dh1 = torch.empty_like(h1), torch.empty_like(h1)
    tail = [t.data_ptr() for t in (w1, w2, w3, h1, h2, h3, g)]
    outs = [t.data_ptr() for t in (*grads, dh2, dh1, wt, work)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if xb is None:
            fn = _build.entry("pda_conv_block_bwd", _BWD_ARGTYPES)
            code = fn(xa.data_ptr(), ca, *tail, None if dxa is None else dxa.data_ptr(),
                      *outs, bsz, h, w, c, int(need_dx), stream)
        else:
            fn = _build.entry("pda_conv_block_bwd_dual", _BWD_DUAL_ARGTYPES)
            code = fn(xa.data_ptr(), xb.data_ptr(), ca, cb, *tail, dxa.data_ptr(),
                      dxb.data_ptr(), *outs, bsz, h, w, c, stream)
    _build.check(code, "conv_block_bwd")
    return (dxa, dxb, *grads)


def _device(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def _nhwc(hs) -> tuple:
    return tuple(h.permute(0, 2, 3, 1).contiguous() for h in hs)


class _ConvBlock(torch.autograd.Function):
    """Kernel 1 with the fused backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        if _device(x, "conv_block_fwd") == "cpu":
            h1, h2, h3 = _nhwc(_plain_layers(x, w1, b1, w2, b2, w3, b3))
        else:
            h1, h2, h3 = _launch(x, None, w1, b1, w2, b2, w3, b3)
            conv_block_fwd.launches += 1
        ctx.save_for_backward(x, h1, h2, h3, w1, w2, w3)
        return h3

    @staticmethod
    def backward(ctx, g):
        x, h1, h2, h3, w1, w2, w3 = ctx.saved_tensors
        return conv_block_bwd(g.contiguous(), x, h1, h2, h3, w1, w2, w3,
                              need_dx=ctx.needs_input_grad[0])


class _ConvBlockDual(torch.autograd.Function):
    """Kernel 2 with the fused dual backward."""

    @staticmethod
    def forward(ctx, xa, xb, w1, b1, w2, b2, w3, b3):
        if _device(xa, "conv_block_fwd_dual") == "cpu":
            h1, h2, h3 = _nhwc(_plain_layers(torch.cat([xa, xb], dim=-1),
                                             w1, b1, w2, b2, w3, b3))
        else:
            h1, h2, h3 = _launch(xa, xb, w1, b1, w2, b2, w3, b3)
            conv_block_fwd_dual.launches += 1
        ctx.save_for_backward(xa, xb, h1, h2, h3, w1, w2, w3)
        return h3

    @staticmethod
    def backward(ctx, g):
        xa, xb, h1, h2, h3, w1, w2, w3 = ctx.saved_tensors
        dxa, dxb, *grads = conv_block_bwd_dual(g.contiguous(), xa, xb, h1, h2, h3, w1, w2, w3)
        need = ctx.needs_input_grad
        return (dxa if need[0] else None, dxb if need[1] else None, *grads)


def conv_block_fwd(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Kernel 1: the fused ConvBlock forward, (B, H, W, Cin) -> (B, H, W, C);
    differentiable through :func:`conv_block_bwd`."""
    return _ConvBlock.apply(x, w1, b1, w2, b2, w3, b3)


def conv_block_fwd_dual(xa, xb, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Kernel 2: the fused ConvBlock forward on ``[xa | xb]`` (channels);
    differentiable through :func:`conv_block_bwd_dual`."""
    return _ConvBlockDual.apply(xa, xb, w1, b1, w2, b2, w3, b3)


def conv_block_bwd(g, x, h1, h2, h3, w1, w2, w3, need_dx: bool = True):
    """The fused ConvBlock backward from the saved h1, h2, h3 and the
    cotangent ``g`` of h3: ``(dx or None, dw1, db1, dw2, db2, dw3, db3)``."""
    if _device(g, "conv_block_bwd") == "cpu":
        return conv_block_bwd_plain(g, x, h1, h2, h3, w1, w2, w3, need_dx)
    dx, _, *grads = _launch_bwd(g, x, None, h1, h2, h3, w1, w2, w3, need_dx)
    conv_block_bwd.launches += 1
    return (dx, *grads)


def conv_block_bwd_dual(g, xa, xb, h1, h2, h3, w1, w2, w3):
    """The fused backward of the block on ``[xa | xb]``:
    ``(dxa, dxb, dw1, db1, dw2, db2, dw3, db3)``."""
    if _device(g, "conv_block_bwd_dual") == "cpu":
        return conv_block_bwd_dual_plain(g, xa, xb, h1, h2, h3, w1, w2, w3)
    out = _launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, True)
    conv_block_bwd_dual.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
conv_block_fwd.launches = 0
conv_block_fwd_dual.launches = 0
conv_block_bwd.launches = 0
conv_block_bwd_dual.launches = 0
