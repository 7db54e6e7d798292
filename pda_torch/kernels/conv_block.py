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
fused ConvBlock backward of ``csrc/conv_block_bwd.cuh`` (``pda``'s
``conv_block_bwd*.py`` and ``conv_block_packed_bwd*.py``): its wgrad and
dgrad run on the tensor cores in 3xTF32 (:mod:`.tf32x3`), float32-accurate.
dx is computed only when autograd asks for it: an entry block, whose input
is the image, takes none (``pda``'s ``need_dx=False``).

Two more modes of the same backward, as ``pda``'s kernels have them:

* the pooled cotangent (``pda``'s ``gpf``): :func:`conv_block_fwd_pool` is
  the block followed by the 2x2 average pool of its output
  (:func:`avg_pool_2x2`), returning the pooled map ("only") or the block's
  output and the pooled map ("with": the backbone's skip and the next
  level's input). Its backward hands both cotangents to one
  :func:`conv_block_bwd` launch (``gp=``), which forms
  ``round(g + 0.25 * gp[p / 2])`` under the ReLU mask, so neither the pool's
  transposed cotangent nor its sum with the skip's exists in memory;
* recompute (``pda``'s ``PDA_PALLAS_CONV_MODE=mixed``, ``conv3_relu_mixed``):
  :func:`conv_block_fwd_mixed` / :func:`conv_block_fwd_dual_mixed` run the
  forward as ``pda``'s XLA forward, conv + bias + ReLU layer by layer
  (:func:`autodiff_layers`, cuDNN on the card), and keep only the input and
  h3; their backward rebuilds h1 and h2 inside the backward's entry (``h1``,
  ``h2`` None, the biases ``b1``, ``b2`` given) with the forward kernel's
  layer bodies, for the memory between the forward and the backward.

The forward's layers run on the tensor cores in 3xTF32 too, so on the card
the forward is about 1e-6 of its largest value off a float64 reference, no
longer bit-equal to cuDNN's float32 FMAs. Every forward layer whose channel
counts are multiples of 8 (with 16-byte-aligned tensors) runs on Hopper's
asynchronous path (``csrc/conv3x3_wgmma_tf32.cuh`` in float32: TMA,
``wgmma`` on TF32 hi/lo planes, float32 sums in registers;
``csrc/conv3x3_wgmma.cuh`` in bf16), and so does the recompute of h1, h2;
a single-input first layer with 1 or 2 channels (the image, or image +
mask) runs on the FMA pipes, and any other layer on the ``mma.sync`` body
(``csrc/conv3x3_tc.cuh``). The backward's dgrad runs on the same bodies
(their epilogue the ReLU mask and the ``dxa | dxb`` split), by the same
shape rule. Its wgrad: in bf16 on ``csrc/wgrad_wgmma.cuh`` (``wgmma`` with
both operands transposed, float32 sums in registers), in float32 on
``csrc/wgrad_wgmma_tf32.cuh`` (TMA, the landed tiles transposed and split
into K-major TF32 hi/lo planes in shared memory, 3xTF32 ``wgmma``), by the
same shape rule; a single-input entry layer of 1 or 2 channels on the FMA
pipes; any other layer on ``mma.sync`` (``wgrad_tc``). :func:`wgrad_kernel`
runs one layer's wgrad alone. A launch whose every such layer took the
``wgmma`` bodies
also counts in ``launches_wgmma_bf16`` or ``launches_wgmma_f32``
(:func:`count_name`). In float32 the kernels read the wrapper's per-call
copy of each weight as three planes (:func:`tf32_planes`): the kernel, then
its 3xTF32 hi and lo.

Tensors are NHWC float32 or bf16, weights HWIO ``(3, 3, Cin, C)`` float32
as in ``pda``, biases ``(C,)`` float32; the forward kernel reads an HWOI copy
(:func:`_fwd_kernel`), the dgrad the HWIO kernel (:func:`_dgrad_kernel`).
On a CPU tensor the wrappers run the plain PyTorch versions
(``*_plain``); on a CUDA tensor they launch the hand-written kernels on the
current stream, or raise (float16, float64 and any other dtype too), unless
the caller asks for the plain versions on the card (:func:`plain_versions`,
an A/B check's plain leg).

bf16 (``pda``'s bf16 configuration, ``ProbabilisticUnet(dtype=bf16)``): the
kernels follow the rounding points of ``pda``'s Pallas kernels
(``pda/kernels/conv_block.py`` ``_kernel``, ``conv_block_bwd.py``): the
activations and the kernels (cast from the float32 weights inside the
wrapper, ``pda``'s ``w.astype(dtype)``) are bf16, products accumulate in
float32, the bias is added in float32, then the ReLU, and each layer's
output is rounded to bf16 once; in the backward, da and dx are bf16 (the
mask, the dgrad's float32 sums rounded once), dW and db float32, so
autograd hands float32 gradients to the float32 parameters. The plain
versions compute exactly that (bf16-rounded operands, the products summed in
float32 on the card and in float64 on the CPU, :func:`plain_acc`, or in
what :func:`plain_sums` sets, one rounding a layer); ``pda``'s XLA path rounds elsewhere (the conv's sum to
bf16, then the bias added in bf16), so the port is held to ``pda``'s
kernels, interpreted on the CPU, not to that path.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .tf32x3 import split_tf32x3

_VP = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = (_VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                 _I, _I, _I, _I, _VP)
# x, Cin, w1..w3, f1, b1, f2, b2, h1..h3, g, gp, dx, dw1, db1, .., db3, da1, da2, work,
# B, H, W, C, need_dx, recompute
_BWD_ARGTYPES = (_VP, _I, *[_VP] * 22, *[_I] * 6, _VP)
# xa, xb, Ca, Cb, w1..w3, f1, b1, f2, b2, h1..h3, g, gp, dxa, dxb, dw1, .., db3, da1,
# da2, work, B, H, W, C, recompute
_BWD_DUAL_ARGTYPES = (_VP, _VP, _I, _I, *[_VP] * 23, *[_I] * 5, _VP)


_BF16 = torch.bfloat16


#: the dtype the bf16 plain versions sum in while :func:`plain_sums` holds
#: (None: :func:`plain_acc`'s default)
_PLAIN_SUMS: Optional[torch.dtype] = None
#: True while :func:`plain_versions` holds
_PLAIN_VERSIONS = False


def plain_acc(t: torch.Tensor) -> torch.dtype:
    """The dtype a bf16 plain version sums in: float32 on the card (the
    kernels' sums) and float64 on the CPU (exact sums of the bf16 products,
    each rounded to bf16 once), or what :func:`plain_sums` set."""
    return _PLAIN_SUMS or (torch.float64 if t.device.type == "cpu" else torch.float32)


@contextlib.contextmanager
def plain_sums(dtype: torch.dtype):
    """While the block runs, the bf16 plain versions sum in ``dtype`` on
    every device (a check's second summation order)."""
    global _PLAIN_SUMS
    before, _PLAIN_SUMS = _PLAIN_SUMS, dtype
    try:
        yield
    finally:
        _PLAIN_SUMS = before


@contextlib.contextmanager
def plain_versions():
    """While the block runs, every kernel wrapper runs its plain version on
    a CUDA tensor too and counts no launch: the plain leg of an A/B check
    on the card. Outside it a CUDA tensor always launches the kernel."""
    global _PLAIN_VERSIONS
    before, _PLAIN_VERSIONS = _PLAIN_VERSIONS, True
    try:
        yield
    finally:
        _PLAIN_VERSIONS = before


def runs_plain(t: torch.Tensor, what: str) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: on a CPU
    tensor, or under :func:`plain_versions`; a CUDA tensor launches the
    kernel; any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cpu" or _PLAIN_VERSIONS


def bf16_operand(w: torch.Tensor, acc: torch.dtype = torch.float32) -> torch.Tensor:
    """A float32 weight as the bf16 kernels read it (rounded to bf16), in
    ``acc`` for the plain versions' sums."""
    return w.to(_BF16).to(acc)


def conv_relu_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One NCHW SAME conv + bias + ReLU with an HWIO weight; a bf16 ``x``
    as the bf16 kernel computes it (bf16 operands, the products summed in
    :func:`plain_acc`, the float32 bias, one rounding to bf16)."""
    if x.dtype == _BF16:
        acc = plain_acc(x)
        y = F.conv2d(x.to(acc), bf16_operand(w, acc).permute(3, 2, 0, 1), b.to(acc),
                     padding=1)
        return F.relu(y).to(_BF16)
    return F.relu(F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1))


def _plain_layers(x, *weights) -> list:
    """[h1, h2, h3] of the plain forward (or [h1, h2] given w1, b1, w2, b2),
    each an NCHW view."""
    hs, h = [], x.permute(0, 3, 1, 2)
    for w, b in zip(weights[::2], weights[1::2]):
        h = conv_relu_layer(h, w, b)
        hs.append(h)
    return hs


def autodiff_conv_relu(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One NCHW SAME conv + bias + ReLU with an OIHW weight, as ``pda``'s
    autodiff convs compute it (``jnp.maximum(_conv_same(h, w) + b, 0)``):
    in bf16 the conv of bf16 operands rounded to bf16, then the bias (in
    bf16) added in bf16. ``F.conv2d``: cuDNN on the card, in bf16 there (its
    float32 sums rounded to bf16 once: the same rounding point, which the
    CPU gives with a float32 conv of the bf16 values)."""
    if h.dtype == _BF16:
        wb = w.to(_BF16)
        y = (F.conv2d(h, wb, padding=1) if h.is_cuda
             else F.conv2d(h.float(), wb.float(), padding=1).to(_BF16))
        return F.relu(y + b.to(_BF16)[:, None, None])
    return F.relu(F.conv2d(h, w, b, padding=1))


def autodiff_layers(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The block as ``pda``'s XLA forward computes it (:func:`autodiff_conv_relu`
    a layer, HWIO kernels), NHWC: the forward of the mixed mode."""
    h = x.permute(0, 3, 1, 2)
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = autodiff_conv_relu(h, w.permute(3, 2, 0, 1), b)
    return h.permute(0, 2, 3, 1).contiguous()


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool of (B, H, W, C); H and W must be even.
    In bf16 as ``pda``'s flat pipeline pools, the path its bf16 models take
    wherever its kernels run (``flat_ops.pool_flat_packed``,
    ``pool_flat``): the row pairs summed and rounded to bf16, the column
    pairs summed and rounded, times 0.25 (exact). (Its image-path
    ``avg_pool_2x2``, flax's window sum in bf16, rounds after each of the
    four adds instead.)"""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"avg_pool_2x2 needs even spatial dims, got {tuple(x.shape)}")
    x6 = x.reshape(b, h // 2, 2, w // 2, 2, c)
    if x.dtype != _BF16:
        return x6.mean(dim=(2, 4))
    rows = (x6[:, :, 0].float() + x6[:, :, 1].float()).to(_BF16)
    return (rows[..., 0, :].float() + rows[..., 1, :].float()).to(_BF16) * 0.25


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


def masked_cotangent_plain(g, gp, h3) -> torch.Tensor:
    """Plain version of the backward's first pass: ``[h3 > 0] * g`` or, with
    the pooled cotangent ``gp`` (B, H/2, W/2, C), ``[h3 > 0] * round(g +
    0.25 * gp[p / 2])`` (``g`` may be None): the pool's transpose, then the
    add, in :func:`plain_acc` in bf16, rounded once (float32 as autograd of
    the pool and the add computes it)."""
    if gp is None:
        return torch.where(h3 > 0, g, 0.0)
    acc = plain_acc(gp) if gp.dtype == _BF16 else gp.dtype
    v = 0.25 * gp.to(acc).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if g is not None:
        v = g.to(acc) + v
    return torch.where(h3 > 0, v.to(h3.dtype), 0.0)


def conv_block_bwd_plain(g, x, h1, h2, h3, w1, w2, w3, need_dx: bool = True, *, gp=None,
                         b1=None, b2=None):
    """Plain PyTorch version of the ConvBlock backward: ``pda``'s hand VJP
    (``blocks.py`` ``_conv3_bwd``). For layer 3, 2, 1: the ReLU mask
    ``da = dh * [h > 0]``, the weight gradient summed over B, H, W
    (:func:`_wgrad_plain`), the bias gradient ``sum(da)``, and the dgrad, a
    SAME conv of ``da`` with the kernel flipped in space and its in/out
    channels swapped. With the pooled cotangent ``gp`` (``g`` may then be
    None), layer 3's da is :func:`masked_cotangent_plain`'s; with ``h1``,
    ``h2`` None (recompute), they are rebuilt from ``x`` with the biases
    ``b1``, ``b2`` as the forward kernel computes them.

    Returns ``(dx or None, dw1, db1, dw2, db2, dw3, db3)``: dx NHWC, dW HWIO.
    In bf16 (``g``, ``x``, h1..h3 bf16, the weights float32) as the bf16
    kernel computes it: the wgrad and the bias gradient of the bf16 values
    and the dgrad of bf16 operands (the kernel rounded to bf16) summed in
    :func:`plain_acc`, the dgrad rounded to bf16 once, so da and dx are bf16
    and dW, db float32."""
    if h1 is None:
        h1, h2 = _nhwc(_plain_layers(x, w1, b1, w2, b2))
    bf16 = h3.dtype == _BF16
    acc = plain_acc(h3)
    dout, grads = masked_cotangent_plain(g, gp, h3), []
    for k, (h_out, h_in, w) in enumerate(((h3, h2, w3), (h2, h1, w2), (h1, x, w1))):
        da = dout if k == 0 else torch.where(h_out > 0, dout, 0.0)
        if bf16:
            da, h_in, w = da.to(acc), h_in.to(acc), bf16_operand(w, acc)
            grads = [_wgrad_plain(h_in, da).float(), da.sum(dim=(0, 1, 2)).float()] + grads
        else:
            grads = [_wgrad_plain(h_in, da), da.sum(dim=(0, 1, 2))] + grads
        dout = (F.conv2d(da.permute(0, 3, 1, 2), w.flip(0, 1).permute(2, 3, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
                if k < 2 or need_dx else None)
        if bf16 and dout is not None:
            dout = dout.to(_BF16)
    dx = None if dout is None else dout.contiguous()
    return (dx, *grads)


def conv_block_bwd_dual_plain(g, xa, xb, h1, h2, h3, w1, w2, w3, *, gp=None, b1=None,
                              b2=None):
    """Plain PyTorch version of the dual backward: the block's backward on
    ``cat([xa, xb])``, dx split back. Returns ``(dxa, dxb, dw1, .., db3)``."""
    dx, *grads = conv_block_bwd_plain(g, torch.cat([xa, xb], dim=-1), h1, h2, h3,
                                      w1, w2, w3, gp=gp, b1=b1, b2=b2)
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
    _build.check_tensor("xa" if xb is not None else "x", xa, (bsz, h, w, ca), dev,
                        _build.FLOAT32_BF16)
    if xb is not None:
        _build.check_tensor("xb", xb, (bsz, h, w, cb), dev, (xa.dtype,))
    for name, t, shape in (("w1", w1, (3, 3, ca + cb, c)), ("w2", w2, (3, 3, c, c)),
                           ("w3", w3, (3, 3, c, c))):
        _build.check_tensor(name, t, shape, dev)
    for j, t in enumerate(b):
        _build.check_tensor(f"b{j + 1}", t, (c,), dev)
    return bsz, h, w, ca, cb, c


def _hwoi(w: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel ``(3, 3, Cin, C)`` as the contiguous HWOI copy
    ``(3, 3, C, Cin)`` the forward kernel reads: its reduction index (Cin)
    contiguous, as the tensor-core tiles take it."""
    return w.permute(0, 1, 3, 2).contiguous()


def tf32_planes_plain(w: torch.Tensor, hwoi: bool) -> torch.Tensor:
    """Plain version of the float32 kernels' weight copy
    (``csrc/tf32_planes.cu``): an HWIO kernel ``(3, 3, Cin, C)`` as three
    planes ``(3, 3, 3, R, K)`` in the order the layer bodies read them, the
    kernel itself (as HWOI with ``hwoi``, r = C and k = Cin: the forward's;
    else as it is, r = Cin and k = C: the dgrad's), then its
    :func:`~.tf32x3.split_tf32x3` ``hi`` and ``lo``."""
    k = (w.permute(0, 1, 3, 2) if hwoi else w).contiguous()
    return torch.stack([k, *split_tf32x3(k)])


def tf32_planes(w: torch.Tensor, hwoi: bool) -> torch.Tensor:
    """:func:`tf32_planes_plain` by the CUDA kernel on a CUDA tensor (one
    read of ``w``, three planes written), the plain version on a CPU one."""
    if runs_plain(w, "tf32_planes"):
        return tf32_planes_plain(w, hwoi)
    _build.check_tensor("w", w, w.shape, w.device)
    ci, c = w.shape[2:]
    r, k = (c, ci) if hwoi else (ci, c)
    out = w.new_empty((3, 3, 3, r, k))
    fn = _build.entry("pda_tf32_planes", (_VP, _VP, _I, _I, _I, _VP))
    with torch.cuda.device(w.device):
        code = fn(w.data_ptr(), out.data_ptr(), r, k, int(hwoi),
                  torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(code, "tf32_planes")
    return out


def _fwd_kernel(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The copy of an HWIO kernel that the forward's layers read: in bf16
    the HWOI copy rounded to bf16; in float32 its three planes
    (:func:`tf32_planes`, HWOI), the 3xTF32 wgmma body's hi and lo after the
    kernel."""
    return _hwoi(w.to(dtype)) if dtype == _BF16 else tf32_planes(w, hwoi=True)


def _dgrad_kernel(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """... and that the backward's dgrad reads: the HWIO kernel itself (in
    bf16 rounded), in float32 as three planes (:func:`tf32_planes`)."""
    return w.to(dtype) if dtype == _BF16 else tf32_planes(w, hwoi=False)


def _suffix(dtype: torch.dtype) -> str:
    """The C entries' suffix of a dtype's instance."""
    return "_bf16" if dtype == _BF16 else ""


def _launch(xa: torch.Tensor, xb: Optional[torch.Tensor], w1, b1, w2, b2, w3, b3):
    """(h1, h2, h3) of the forward kernel, in x's dtype (float32 or bf16)."""
    dev, dtype = xa.device, xa.dtype
    bsz, h, w, ca, cb, c = _check_block(xa, xb, w1, w2, w3, (b1, b2, b3))
    h1, h2, h3 = (torch.empty((bsz, h, w, c), device=dev, dtype=dtype) for _ in range(3))
    if h3.numel() == 0:
        return h1, h2, h3
    fn = _build.entry("pda_conv_block_fwd" + _suffix(dtype), _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        w1, w2, w3 = (_fwd_kernel(t, dtype) for t in (w1, w2, w3))
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(xa.data_ptr(), None if xb is None else xb.data_ptr(), ca, cb,
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  w3.data_ptr(), b3.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                  h3.data_ptr(), bsz, h, w, c, stream)
    _build.check(code, "conv_block_fwd")
    return h1, h2, h3


def _launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx: bool, workspaces=None, *,
                gp=None, b1=None, b2=None):
    """(dxa or None, dxb or None, dw1, db1, dw2, db2, dw3, db3) of the
    backward kernel; the dual entry (xb given) always computes dxa, dxb. In
    x's dtype (float32 or bf16: dx too), dW and db float32. ``workspaces``:
    the two (B, H, W, C) buffers of the layers' masked cotangents, which
    then hold da_1 and da_2 after the call (allocated here if None).
    ``gp``: the cotangent of the 2x2 average pool of h3, (B, H/2, W/2, C),
    beside ``g`` or instead of it (``g`` None). ``h1``, ``h2`` None: the
    kernel recomputes them from x into buffers of this call, with the
    forward's layers and the biases ``b1``, ``b2``."""
    dev, dtype = xa.device, xa.dtype
    bsz, h, w, ca, cb, c = _check_block(xa, xb, w1, w2, w3)
    recompute = h1 is None or h2 is None
    if recompute and (h1 is not None or h2 is not None or b1 is None or b2 is None):
        raise ValueError("recompute takes h1 = h2 = None and the biases b1, b2")
    if g is None and gp is None:
        raise ValueError("the backward needs the cotangent g, the pooled gp or both")
    if gp is not None and (h % 2 or w % 2):
        raise ValueError(f"a pooled cotangent needs even H and W, got {h}x{w}")
    for name, t, shape in (("g", g, (bsz, h, w, c)), ("gp", gp, (bsz, h // 2, w // 2, c)),
                           ("h1", h1, (bsz, h, w, c)), ("h2", h2, (bsz, h, w, c)),
                           ("h3", h3, (bsz, h, w, c))):
        if t is not None:
            _build.check_tensor(name, t, shape, dev, (dtype,))
    if recompute:
        for name, t in (("b1", b1), ("b2", b2)):
            _build.check_tensor(name, t, (c,), dev)
    need_dx = need_dx or xb is not None
    dxa = torch.empty_like(xa) if need_dx else None
    dxb = None if xb is None else torch.empty_like(xb)
    grads = [torch.empty_like(w1), w1.new_empty(c), torch.empty_like(w2), w1.new_empty(c),
             torch.empty_like(w3), w1.new_empty(c)]
    if h3.numel() == 0:
        return tuple(None if t is None else t.zero_() for t in (dxa, dxb, *grads))
    # the chunk count of the wgrad, so the workspace, depends on the card
    suffix = _suffix(dtype)
    n_work = _build.entry("pda_conv_block_bwd_work" + suffix, (_I,) * 5, ctypes.c_longlong)
    # da_3, da_2, da_1 (each layer's masked output cotangent) in two buffers
    da1, da2 = workspaces or (torch.empty_like(h3), torch.empty_like(h3))
    for name, t in (("da1", da1), ("da2", da2)):
        _build.check_tensor(name, t, (bsz, h, w, c), dev, (dtype,))
    with torch.cuda.device(dev):
        kernels = [_dgrad_kernel(t, dtype) for t in (w1, w2, w3)]  # as the dgrad reads them
        if recompute:  # as the forward's layers read them; h1, h2 of this call
            fwd = [_fwd_kernel(w1, dtype), b1, _fwd_kernel(w2, dtype), b2]
            h1, h2 = torch.empty_like(h3), torch.empty_like(h3)
        else:
            fwd = [None] * 4
        ptr = [None if t is None else t.data_ptr() for t in (*kernels, *fwd, h1, h2, h3, g, gp)]
        work = w1.new_empty(n_work(bsz, h, w, ca + cb, c))
        outs = [t.data_ptr() for t in (*grads, da1, da2, work)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if xb is None:
            fn = _build.entry("pda_conv_block_bwd" + suffix, _BWD_ARGTYPES)
            code = fn(xa.data_ptr(), ca, *ptr, None if dxa is None else dxa.data_ptr(),
                      *outs, bsz, h, w, c, int(need_dx), int(recompute), stream)
        else:
            fn = _build.entry("pda_conv_block_bwd_dual" + suffix, _BWD_DUAL_ARGTYPES)
            code = fn(xa.data_ptr(), xb.data_ptr(), ca, cb, *ptr, dxa.data_ptr(),
                      dxb.data_ptr(), *outs, bsz, h, w, c, int(recompute), stream)
    _build.check(code, "conv_block_bwd")
    return (dxa, dxb, *grads)


def masked_cotangent_kernel(g, gp, h3) -> torch.Tensor:
    """The backward kernel's first pass alone on CUDA tensors (the C entry
    ``pda_masked_cotangent``): da_3 of :func:`masked_cotangent_plain`, for a
    check against it. Counts no launch: the backward's wrappers count theirs."""
    dev, dtype = h3.device, h3.dtype
    bsz, h, w, c = h3.shape
    _build.check_tensor("h3", h3, (bsz, h, w, c), dev, _build.FLOAT32_BF16)
    for name, t, shape in (("g", g, (bsz, h, w, c)), ("gp", gp, (bsz, h // 2, w // 2, c))):
        if t is not None:
            _build.check_tensor(name, t, shape, dev, (dtype,))
    da = torch.empty_like(h3)
    fn = _build.entry("pda_masked_cotangent" + _suffix(dtype), (_VP,) * 4 + (_I,) * 4 + (_VP,))
    with torch.cuda.device(dev):
        code = fn(*(None if t is None else t.data_ptr() for t in (g, gp, h3, da)), bsz, h, w, c,
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "masked_cotangent")
    return da


#: the wgrad bodies by the code ``pda_wgrad_route`` returns (:func:`wgrad_route`)
WGRAD_ROUTES = {0: "tc", 1: "wgmma", 2: "entry"}


def wgrad_plain(x, da, xb=None) -> tuple:
    """One layer's weight gradient, ``(dW, db)`` (HWIO, float32) of the
    input ``x`` (or ``[x | xb]``) and the layer's output cotangent ``da``, as
    the plain backward forms it (:func:`_wgrad_plain`; sums in
    :func:`plain_acc` in bf16)."""
    h_in = x if xb is None else torch.cat([x, xb], dim=-1)
    acc = plain_acc(da) if da.dtype == _BF16 else da.dtype
    return (_wgrad_plain(h_in.to(acc), da.to(acc)).float(),
            da.to(acc).sum(dim=(0, 1, 2)).float())


def wgrad_route(x, da, xb=None) -> str:
    """The body one layer's wgrad takes on the card, as the backward's entries
    decide it by shape and alignment: "wgmma" (``csrc/wgrad_wgmma_tf32.cuh``,
    bf16 ``csrc/wgrad_wgmma.cuh``), "entry" (a single input of 1 or 2
    channels, ``wgrad_entry``) or "tc" (``wgrad_tc``)."""
    fn = _build.entry("pda_wgrad_route" + _suffix(da.dtype), (_VP, _VP, _I, _I, _VP, _I))
    return WGRAD_ROUTES[fn(x.data_ptr(), None if xb is None else xb.data_ptr(), x.shape[-1],
                           0 if xb is None else xb.shape[-1], da.data_ptr(), da.shape[-1])]


def wgrad_kernel(x, da, xb=None) -> tuple:
    """One layer's wgrad alone on CUDA tensors (the C entry ``pda_wgrad``,
    the body :func:`wgrad_route` names): ``(dW, db)`` of
    :func:`wgrad_plain`, for a check against it or a benchmark. Counts no
    launch: the backward's wrappers count theirs."""
    dev, dtype = da.device, da.dtype
    bsz, h, w, cout = da.shape
    _build.check_tensor("da", da, (bsz, h, w, cout), dev, _build.FLOAT32_BF16)
    _build.check_tensor("x", x, (bsz, h, w, x.shape[-1]), dev, (dtype,))
    if xb is not None:
        _build.check_tensor("xb", xb, (bsz, h, w, xb.shape[-1]), dev, (dtype,))
    ca, cb = x.shape[-1], 0 if xb is None else xb.shape[-1]
    dw = torch.empty(3, 3, ca + cb, cout, device=dev)
    db = torch.empty(cout, device=dev)
    suffix = _suffix(dtype)
    n_work = _build.entry("pda_wgrad_work" + suffix, (_I,) * 5, ctypes.c_longlong)
    fn = _build.entry("pda_wgrad" + suffix, (_VP, _VP, _I, _I, *[_VP] * 4, *[_I] * 4, _VP))
    with torch.cuda.device(dev):
        work = torch.empty(n_work(bsz, h, w, ca + cb, cout), device=dev)
        code = fn(x.data_ptr(), None if xb is None else xb.data_ptr(), ca, cb, da.data_ptr(),
                  dw.data_ptr(), db.data_ptr(), work.data_ptr(), bsz, h, w, cout,
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "wgrad")
    return dw, db


def count_name(mode: str, dtype: torch.dtype) -> str:
    """The count of launches in ``mode`` ("" for all of them) of a wrapper's
    ``dtype`` instance: ``launches``, ``launches_pool``, ...; in bf16
    ``launches_bf16``, ``launches_pool_bf16``, ...; a route
    (:data:`FWD_MODES`) is counted apart for each dtype:
    ``launches_wgmma_bf16``, ``launches_wgmma_f32``."""
    name = f"launches_{mode}" if mode else "launches"
    if dtype == _BF16:
        return name + "_bf16"
    return name + "_f32" if mode in FWD_MODES else name


def count_launch(wrapper, dtype: torch.dtype, modes=()) -> None:
    """One launch of ``wrapper``'s kernel in ``dtype``: its float32 count
    (``launches``) or its bf16 count (``launches_bf16``); a launch in a mode
    ("pool", "recompute", "wgmma") also adds one to each of its modes'
    counts (:func:`count_name`)."""
    for name in (count_name(m, dtype) for m in ("", *modes)):
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _nhwc(hs) -> tuple:
    return tuple(h.permute(0, 2, 3, 1).contiguous() for h in hs)


def _block_forward(ctx, xs, weights, mixed: bool, name: str) -> torch.Tensor:
    """h3 of the block on ``[xs]`` (one or two inputs), with what its
    backward needs saved: the inputs, h1, h2, h3 and the kernels from the
    forward kernel (or its plain version on the CPU); under ``mixed``, the
    output of :func:`autodiff_layers` (``pda``'s XLA forward, no launch of
    ours), and only the inputs, h3, the kernels and b1, b2."""
    w1, b1, w2, b2, w3, b3 = weights
    ctx.mixed, ctx.n_inputs = mixed, len(xs)
    if mixed:
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        h3 = autodiff_layers(x, *weights)
        ctx.save_for_backward(*xs, h3, w1, w2, w3, b1, b2)
        return h3
    if runs_plain(xs[0], name):
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        h1, h2, h3 = _nhwc(_plain_layers(x, *weights))
    else:
        h1, h2, h3 = _launch(xs[0], xs[1] if len(xs) > 1 else None, *weights)
        count_launch(conv_block_fwd if len(xs) == 1 else conv_block_fwd_dual, xs[0].dtype,
                     _fwd_modes(xs, w1.shape[-1]))
    ctx.save_for_backward(*xs, h1, h2, h3, w1, w2, w3)
    return h3


def _block_backward(ctx, g, gp=None) -> tuple:
    """The gradients of the block's inputs and weights from the cotangent
    of h3 and/or of its pool, through one fused backward call."""
    n = ctx.n_inputs
    xs, rest = ctx.saved_tensors[:n], ctx.saved_tensors[n:]
    if ctx.mixed:
        h3, w1, w2, w3, b1, b2 = rest
        h1 = h2 = None
    else:
        h1, h2, h3, w1, w2, w3 = rest
        b1 = b2 = None
    g = None if g is None else g.contiguous()
    gp = None if gp is None else gp.contiguous()
    need = ctx.needs_input_grad[-6 - n:-6]
    if n == 1:
        dx, *grads = conv_block_bwd(g, xs[0], h1, h2, h3, w1, w2, w3, need_dx=need[0],
                                    gp=gp, b1=b1, b2=b2)
        return (dx, *grads)
    dxa, dxb, *grads = conv_block_bwd_dual(g, *xs, h1, h2, h3, w1, w2, w3, gp=gp, b1=b1,
                                           b2=b2)
    return (dxa if need[0] else None, dxb if need[1] else None, *grads)


class _ConvBlock(torch.autograd.Function):
    """Kernel 1 with the fused backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        return _block_forward(ctx, (x,), (w1, b1, w2, b2, w3, b3), False, "conv_block_fwd")

    @staticmethod
    def backward(ctx, g):
        return _block_backward(ctx, g)


class _ConvBlockDual(torch.autograd.Function):
    """Kernel 2 with the fused dual backward."""

    @staticmethod
    def forward(ctx, xa, xb, w1, b1, w2, b2, w3, b3):
        return _block_forward(ctx, (xa, xb), (w1, b1, w2, b2, w3, b3), False,
                              "conv_block_fwd_dual")

    @staticmethod
    def backward(ctx, g):
        return _block_backward(ctx, g)


class _ConvBlockMixed(torch.autograd.Function):
    """``pda``'s ``conv3_relu_mixed``: the forward's plain layers, saving x
    and h3 only; the fused backward recomputes h1 and h2."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        return _block_forward(ctx, (x,), (w1, b1, w2, b2, w3, b3), True, "conv_block_fwd")

    @staticmethod
    def backward(ctx, g):
        return _block_backward(ctx, g)


class _ConvBlockDualMixed(torch.autograd.Function):
    """The mixed mode of the block on ``[xa | xb]``: saves xa, xb and h3."""

    @staticmethod
    def forward(ctx, xa, xb, w1, b1, w2, b2, w3, b3):
        return _block_forward(ctx, (xa, xb), (w1, b1, w2, b2, w3, b3), True,
                              "conv_block_fwd_dual")

    @staticmethod
    def backward(ctx, g):
        return _block_backward(ctx, g)


class _ConvBlockPool(torch.autograd.Function):
    """The block, then the 2x2 average pool of its output; the backward
    takes the pool's cotangent (and the output's, with ``keep_full``) in one
    fused backward call. ``mixed``: the forward and the saved tensors of
    :class:`_ConvBlockMixed`."""

    @staticmethod
    def forward(ctx, keep_full, mixed, x, w1, b1, w2, b2, w3, b3):
        ctx.set_materialize_grads(False)
        h3 = _block_forward(ctx, (x,), (w1, b1, w2, b2, w3, b3), mixed, "conv_block_fwd")
        pooled = avg_pool_2x2(h3)
        return (h3, pooled) if keep_full else pooled

    @staticmethod
    def backward(ctx, *grads):
        g, gp = grads if len(grads) == 2 else (None, grads[0])
        if g is None and gp is None:
            return (None,) * 9
        return (None, None, *_block_backward(ctx, g, gp))


def conv_block_fwd(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Kernel 1: the fused ConvBlock forward, (B, H, W, Cin) -> (B, H, W, C);
    differentiable through :func:`conv_block_bwd`."""
    return _ConvBlock.apply(x, w1, b1, w2, b2, w3, b3)


def conv_block_fwd_dual(xa, xb, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Kernel 2: the fused ConvBlock forward on ``[xa | xb]`` (channels);
    differentiable through :func:`conv_block_bwd_dual`."""
    return _ConvBlockDual.apply(xa, xb, w1, b1, w2, b2, w3, b3)


def conv_block_fwd_mixed(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The ConvBlock in ``pda``'s mixed mode: :func:`autodiff_layers`
    forward, saving x and h3; differentiable through :func:`conv_block_bwd`
    with recompute."""
    return _ConvBlockMixed.apply(x, w1, b1, w2, b2, w3, b3)


def conv_block_fwd_dual_mixed(xa, xb, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The block on ``[xa | xb]`` in the mixed mode, saving xa, xb and h3;
    differentiable through :func:`conv_block_bwd_dual` with recompute."""
    return _ConvBlockDualMixed.apply(xa, xb, w1, b1, w2, b2, w3, b3)


def conv_block_fwd_pool(x, w1, b1, w2, b2, w3, b3, keep_full: bool, mixed: bool = False):
    """The ConvBlock, then :func:`avg_pool_2x2` of its output: the pooled
    map, or with ``keep_full`` ``(h3, pooled)``; differentiable through one
    :func:`conv_block_bwd` call that takes the pool's cotangent (``gp``).
    ``mixed``: the forward and the recompute backward of
    :func:`conv_block_fwd_mixed`."""
    return _ConvBlockPool.apply(keep_full, mixed, x, w1, b1, w2, b2, w3, b3)


def conv_block_bwd(g, x, h1, h2, h3, w1, w2, w3, need_dx: bool = True, *, gp=None, b1=None,
                   b2=None):
    """The fused ConvBlock backward from the saved h1, h2, h3 and the
    cotangent ``g`` of h3: ``(dx or None, dw1, db1, dw2, db2, dw3, db3)``.
    ``gp``: the cotangent of h3's 2x2 average pool, beside ``g`` or instead
    of it (``g`` None). ``h1``, ``h2`` None: recomputed from ``x`` with the
    biases ``b1``, ``b2`` (the mixed mode)."""
    if runs_plain(h3, "conv_block_bwd"):
        return conv_block_bwd_plain(g, x, h1, h2, h3, w1, w2, w3, need_dx, gp=gp, b1=b1, b2=b2)
    dx, _, *grads = _launch_bwd(g, x, None, h1, h2, h3, w1, w2, w3, need_dx, gp=gp, b1=b1,
                                b2=b2)
    count_launch(conv_block_bwd, h3.dtype,
                 _modes(gp, h1) + _bwd_modes(x, None, w1.shape[-1], need_dx, h1 is None))
    return (dx, *grads)


def conv_block_bwd_dual(g, xa, xb, h1, h2, h3, w1, w2, w3, *, gp=None, b1=None, b2=None):
    """The fused backward of the block on ``[xa | xb]``:
    ``(dxa, dxb, dw1, db1, dw2, db2, dw3, db3)``; ``gp``, and ``h1``, ``h2``
    None with ``b1``, ``b2``, as :func:`conv_block_bwd` takes them."""
    if runs_plain(h3, "conv_block_bwd_dual"):
        return conv_block_bwd_dual_plain(g, xa, xb, h1, h2, h3, w1, w2, w3, gp=gp, b1=b1, b2=b2)
    out = _launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, True, gp=gp, b1=b1, b2=b2)
    count_launch(conv_block_bwd_dual, h3.dtype,
                 _modes(gp, h1) + _bwd_modes(xa, xb, w1.shape[-1], True, h1 is None))
    return out


def _fwd_modes(xs, c: int) -> tuple:
    """The forward's route of a launch: "wgmma" when every tensor-core
    layer of the block ran on the wgmma body of its dtype
    (``csrc/conv3x3_wgmma.cuh``, float32 ``csrc/conv3x3_wgmma_tf32.cuh``),
    which the C entry decides by shape and alignment, as the launch did."""
    fn = _build.entry("pda_conv_block_fwd_wgmma" + _suffix(xs[0].dtype), (_VP, _VP, _I, _I, _I))
    xb = xs[1] if len(xs) > 1 else None
    on = fn(xs[0].data_ptr(), None if xb is None else xb.data_ptr(), xs[0].shape[-1],
            0 if xb is None else xb.shape[-1], c)
    return ("wgmma",) if on else ()


def _bwd_modes(xa, xb, c: int, need_dx: bool, recompute: bool = False) -> tuple:
    """The backward's route of a launch, which the C entry decides by shape
    and alignment, as the launch did: "wgmma" when every dgrad and every
    wgrad but a single-input entry layer's (1 or 2 channels, on the FMA
    pipes) ran on the wgmma bodies of its dtype (bf16:
    ``csrc/conv3x3_wgmma.cuh``, ``csrc/wgrad_wgmma.cuh``; float32, 3xTF32:
    ``csrc/conv3x3_wgmma_tf32.cuh``, ``csrc/wgrad_wgmma_tf32.cuh``, and with
    ``recompute`` every tensor-core layer that rebuilt h1, h2)."""
    ptrs = (xa.data_ptr(), None if xb is None else xb.data_ptr(), xa.shape[-1],
            0 if xb is None else xb.shape[-1], c, int(need_dx))
    if xa.dtype == _BF16:
        on = _build.entry("pda_conv_block_bwd_wgmma_bf16", (_VP, _VP, _I, _I, _I, _I))(*ptrs)
    else:
        on = _build.entry("pda_conv_block_bwd_wgmma", (_VP, _VP, _I, _I, _I, _I, _I))(
            *ptrs, int(recompute))
    return ("wgmma",) if on else ()


def _modes(gp, h1) -> tuple:
    """The backward modes of a launch: "pool" (a pooled cotangent) and/or
    "recompute" (h1, h2 not saved)."""
    return (("pool",) if gp is not None else ()) + (("recompute",) if h1 is None else ())


#: launches of the CUDA kernel since the count was last set to 0: its
#: float32 instance (``launches``) and its bf16 instance (``launches_bf16``);
#: the backwards' launches in a mode also count in ``launches_<mode>[_bf16]``
#: (:data:`BWD_MODES`); the bf16 launches whose layers all ran on the wgmma
#: bodies (every forward layer; every dgrad and every wgrad but an entry
#: layer's) in ``launches_wgmma_bf16``, and the float32 launches whose layers
#: all ran on the 3xTF32 wgmma bodies (every forward layer but a 1- or
#: 2-channel entry layer; every dgrad, every wgrad but an entry layer's, and
#: the recompute's layers) in ``launches_wgmma_f32`` (:data:`FWD_MODES`, the
#: route of the forwards and the backwards alike; :func:`count_name`)
BWD_MODES = ("pool", "recompute")
FWD_MODES = ("wgmma",)
for _fn in (conv_block_fwd, conv_block_fwd_dual, conv_block_bwd, conv_block_bwd_dual):
    _fn.launches = _fn.launches_bf16 = 0
    _fn.launches_wgmma_bf16 = _fn.launches_wgmma_f32 = 0
for _fn in (conv_block_bwd, conv_block_bwd_dual):
    for _m in BWD_MODES:
        setattr(_fn, f"launches_{_m}", 0)
        setattr(_fn, f"launches_{_m}_bf16", 0)
del _fn, _m
