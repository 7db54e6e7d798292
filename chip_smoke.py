#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pda_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error or miss:
  1. device   — a CUDA card is present; print its name and power limit
  2. build    — compile the CUDA kernels from pda_torch/kernels/csrc/
  3. kernels  — each kernel against its plain PyTorch version at every
                geometry of the serving path (tiled and pseudo) and of the
                Mean-Teacher step (pda_torch/tools/workload.py), random
                seeded inputs; each kernel twice, bit-equal, and against its
                plain version in float64 (the MC tail, K3, at the tiled, MT
                teacher and pseudo shapes)
  4. serving  — the flagship PUNet (num_filters 64..512, latent 6,
                no_convs_fcomb 3, float32, seeded weights) on a seeded
                synthetic 520x704 frame: tiled MC-16 prediction (block 384,
                halo 64) and full-frame MC-16 pseudo-labels with consensus
                masking; shapes, ranges, kernel launch counts, and one 512^2
                tile against the same port on the CPU
  5. training — the flagship's Mean-Teacher step (MC-16, consensus masking,
                Adam 1e-5, EMA 0.999) at full widths: one step at 128^2,
                batch 2, on the card against the same step of the port on
                the CPU (loss, every gradient, updated student and teacher),
                with its kernel launch counts; then steps at 512^2, batch 2
  6. algorithms — fault 3.1: K3 at C = 16 and 20 (zero-padded to 24)
                against its plain version, a PUNet at num_filters (16, 32,
                48, 64) and a 2-class one through mc_pseudo and the
                validation predictor, card vs CPU (no K3 launch for 2
                classes); the pseudo-PUNet, FixMatch (distribution
                alignment), AdaMT and AdaMatch steps of the flagship, one at
                128^2 card vs CPU with launch counts each, then timed at
                512^2; the UNet2d path (depth 4, 64 features, sigmoid): the
                supervised and pseudo-label steps at 256^2 batch 4 card vs
                CPU, then timed, and tiled prediction of the frame, one tile
                card vs CPU, with no kernel launch
  7. engine   — the training engine (pda_torch.train.engine) on the card: the
                flagship's MeanTeacherTrainer.fit(8) at 512^2, batch 2, on
                seeded synthetic 520x704 frames through the port's Loader and
                DualImageCollectionDataset (epochs of 4 steps, a validation
                each, panels every 4 steps, the plateau controller, best and
                latest .pt checkpoints in a temporary directory), with exact
                launch counts and its patches/s beside the bare MT step's; a
                fresh trainer reloading latest.pt bit for bit, then resuming
                to 10; the same fit at 128^2 (2 steps, 1 validation) on the
                card against the CPU (float32, and float64 for the gradients'
                reference); and 300 iterations of development/learning_smoke.py's
                PUNetTrainer run (PUNet 16/32/64/96, 64^2, batch 8, lr 1e-3),
                final validation dice above 0.5
  8. times    — CUDA-event medians of every kernel, its plain version and
                (ConvBlock forward and backward) cuDNN's convolutions, beside
                its bound from the shapes, with TFLOP/s; end-to-end ms/frame
                and tiles/s, ms/step and patches/s of every step

Every comparison runs with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 both False), so the plain versions
compute in full float32. The last two lines of standard output are a JSON
line of per-kernel results and ``{"ok": true, "device": {...}}``; nothing of
the kind is printed when a phase fails or there is no card.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

SEED = 0
MC = 16
FRAME = (520, 704)
BLOCK, HALO = (384, 384), (64, 64)
K12_REL_TOL = 1e-4  # kernels 1/2: max |kernel - plain| <= 1e-4 * max |plain|
# ... and max |kernel - ref64| <= 1e-5 * max |ref64|, ref64 the plain version in
# float64: float32 accuracy (3xTF32 is ~1e-6 off, one TF32 product ~1e-3)
K12_REF64_TOL = 1e-5
K3_MEAN_TOL = 1e-5  # kernel 3: max abs error of the MC mean (vs plain and vs float64)
K3_WINDOW = 1e-4  # kernel 3: consensus may differ only where a logit is this near a threshold
TILE_TOL = 1e-4  # one tile, card vs CPU: max abs error of the MC mean

# The ConvBlock shapes of the serving path and the MT step (K1, K2, the
# backward, and K3's feature terms) are pda_torch/tools/workload.py's, shared
# with the profiler.
BWD_REL_TOL = 1e-4  # each of dx, dW, db: max |kernel - plain| <= 1e-4 * max |plain|
# ... and max |kernel - ref64| <= 1e-5 * max |ref64|, ref64 the plain version in
# float64: float32 accuracy (3xTF32 is ~1e-6 off, one TF32 product ~1e-3)
BWD_REF64_TOL = 1e-5
# (B, H, W, Cin, C) whose library backward is timed with cudnn.benchmark on:
# there cuDNN's default dgrad algorithm takes ~300 ms (PERF.md, row 10)
BWD_LIBRARY_BENCHMARK = {(2, 128, 128, 128, 256)}

MT_LR, MT_MOMENTUM, MT_BATCH = 1e-5, 0.999, 2
MT_CHECK_PATCH, MT_TIME_PATCH = 128, 512
MT_WARMUP, MT_TIMED = 3, 7
LAST_SCALE = 8.0  # Fcomb last layer x8: the random teacher's consensus share lies inside (0, 1)
MT_LOSS_TOL = 1e-4  # card vs CPU: |loss - ref| <= 1e-4 * max(1, |ref|), same for recon, kl
MT_GRAD_TOL = 1e-3  # card vs CPU: per parameter, max |g - ref| <= 1e-3 * max |ref|
MT_PARAM_TOL = 1e-6  # card vs CPU: updated student (where Adam's sign is defined) and teacher
# the algorithms phase: a gradient leaf beyond MT_GRAD_TOL passes if 1 - its
# cosine to the float64 step's is within GRAD_COS_TOL, or within GRAD_COS_CPU
# times the CPU float32 step's (check_step)
GRAD_COS_TOL, GRAD_COS_CPU = 1e-5, 4.0
# kernel launches of one MT step
MT_LAUNCHES = {"conv_block_fwd": 20, "conv_block_fwd_dual": 6, "mc_consensus": 1,
               "conv_block_bwd": 12, "conv_block_bwd_dual": 3}

# The algorithms phase. The MC tail at widths the kernel once refused (C = 20
# is zero-padded to 24), a small PUNet through it, a 2-class PUNet (the plain
# tail, no MC kernel launch); the other PUNet steps at the flagship's widths,
# checked at 128^2 and timed at 512^2; the UNet2d path the UNet experiments
# build (depth 4, 64 features, sigmoid; 256^2 batch 4, Adam 1e-4).
FAULT_WIDTHS = (16, 20)
SMALL_FILTERS = (16, 32, 48, 64)
ALG_CHECK_PATCH, ALG_TIME_PATCH = 128, 512
ALG_WARMUP, ALG_TIMED = 2, 5
SOURCE_DISTRIBUTION = (0.7, 0.3)  # FixMatch's source class distribution [bg, fg]
# kernel launches of one step: the student's forward (12 blocks, 3 decoder
# blocks) and backward a loss, the teacher's (or the model's own) MC pass
# (8 + 3 blocks and the MC tail) where the step draws pseudo-labels
ALG_LAUNCHES = {
    "pseudo_punet": {"conv_block_fwd": 12, "conv_block_fwd_dual": 3, "mc_consensus": 0,
                     "conv_block_bwd": 12, "conv_block_bwd_dual": 3},
    "fixmatch": MT_LAUNCHES,
    "adamt": {"conv_block_fwd": 32, "conv_block_fwd_dual": 9, "mc_consensus": 1,
              "conv_block_bwd": 24, "conv_block_bwd_dual": 6},
}
ALG_LAUNCHES["adamatch"] = ALG_LAUNCHES["adamt"]
UNET_LR, UNET_BATCH, UNET_PATCH = 1e-4, 4, 256
NO_LAUNCHES = dict.fromkeys(MT_LAUNCHES, 0)

# The engine phase: the flagship's MT trainer at 512^2 (epochs of 4 steps, a
# validation batch each, panels every 4 steps), resumed to 10; the same fit at
# 128^2 card vs CPU; development/learning_smoke.py's run (pda records 0.82-0.84
# final dice on its TPU in bf16: a reference point, not a target)
ENGINE_EPOCH, ENGINE_FIT, ENGINE_RESUME = 4, 8, 10
ENGINE_CHECK_PATCH, ENGINE_CHECK_FIT = 128, 2
ENGINE_MIN_SHARE = 0.9  # the engine's loop against the bare step's patches/s (reported)
LEARN_FILTERS, LEARN_ITERATIONS, LEARN_BATCH = (16, 32, 64, 96), 300, 8
LEARN_LR, LEARN_BAR = 1e-3, 0.5
# kernel launches of one MT validation step (the teacher's MC pass, the
# student's loss with its posterior, the student's MC pass) and of one MT
# panel pass (the teacher's and the student's MC passes on one patch)
MT_VAL_LAUNCHES = {"conv_block_fwd": 28, "conv_block_fwd_dual": 9, "mc_consensus": 2,
                   "conv_block_bwd": 0, "conv_block_bwd_dual": 0}
MT_PANEL_LAUNCHES = {"conv_block_fwd": 16, "conv_block_fwd_dual": 6, "mc_consensus": 2,
                     "conv_block_bwd": 0, "conv_block_bwd_dual": 0}

# A kernel's bound: the larger of its FLOPs over the card's float32-accurate
# peak and its bytes (each input read once, each output written once) over
# the memory rate. H100 SXM data sheet: 495 TFLOP/s TF32 on the tensor cores,
# so 165 in 3xTF32, the fastest float32-accurate route (67 TFLOP/s on the FMA
# pipes); 3.35 TB/s.
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def add_bound(entry, binding, flops, nbytes, weight=1):
    """Add ``weight`` calls' bound (ms) to ``entry``; ``binding`` sums each
    term's share, which names ``bound_by``. Returns one call's (ms, term)."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES
    ms, term = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    entry["bound_ms"] += weight * ms
    binding[entry["name"], term] = binding.get((entry["name"], term), 0.0) + weight * ms
    return ms, term


def synthetic_frame(gen, shape, dev):
    """A LIVECell-sized grey frame: bright blobs on a ramp, with noise."""
    import torch

    h, w = shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    img = 0.05 * xx + 0.3 * torch.randn(h, w, generator=gen)
    centers = torch.rand(60, 2, generator=gen) * torch.tensor([h, w], dtype=torch.float32)
    for cy, cx in centers.tolist():
        img += 3.0 * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 120.0)
    return (img * 40 + 100)[..., None].to(dev)


def saved_block(gen, b, h, w, cin, c, dev):
    """(g, x, h1, h2, h3, w1, w2, w3): a ConvBlock's saved tensors from the
    plain forward on seeded inputs, and a seeded cotangent."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.workload import conv_weights

    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    w1, b1, w2, b2, w3, b3 = conv_weights(gen, cin, c, dev)
    hs = [t.permute(0, 2, 3, 1).contiguous() for t in kc._plain_layers(x, w1, b1, w2, b2, w3, b3)]
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    return (g, x, *hs, w1, w2, w3)


def check_bwd(entry, label, kernel, plain, args, names, per_step, binding, need_dx):
    """A backward kernel against its plain version: every output within
    BWD_REL_TOL of the plain one's largest and within BWD_REF64_TOL of the
    plain version's in float64, and two runs bit-equal; then times (the
    kernel's, the plain version's, cuDNN's: :func:`cudnn_block_bwd`) and the
    bound."""
    import torch

    from pda_torch.tools.workload import block_flops, block_weight_bytes, cuda_ms, dgrad_flops

    out, again, ref = kernel(*args), kernel(*args), plain(*args)
    ref64 = plain(*(a.double() for a in args))
    torch.cuda.synchronize()
    ok, worst, worst64 = True, (0.0, ""), (0.0, "")
    same = all((a is None and a2 is None) or torch.equal(a, a2) for a, a2 in zip(out, again))
    for name, a, r, r64 in zip(names, out, ref, ref64):
        if r is None:
            ok &= a is None
            continue
        err = float((a - r).abs().max())
        scale = float(r.abs().max())
        err64 = float((a.double() - r64).abs().max())
        scale64 = float(r64.abs().max())
        ok &= (bool(torch.isfinite(a).all()) and err <= BWD_REL_TOL * scale
               and err64 <= BWD_REF64_TOL * scale64)
        worst = max(worst, (err / scale if scale else err, name))
        worst64 = max(worst64, (err64 / scale64 if scale64 else err64, name))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    ok &= same
    del out, again, ref, ref64
    ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
    # wgrad of three layers, dgrad of two (and of the first with dx);
    # reads x (or xa, xb), h1, h2, h3, g, W; writes dx, dW, db
    b, h, w, c = args[0].shape
    cin = sum(t.shape[-1] for t in args[1:-6])
    lib_args = (args[0], torch.cat(args[1:-6], dim=-1), *args[-6:-3], *map(oihw, args[-3:]))
    benchmark = (b, h, w, cin, c) in BWD_LIBRARY_BENCHMARK
    torch.backends.cudnn.benchmark = benchmark
    try:
        library_ms = cuda_ms(lambda: cudnn_block_bwd(*lib_args, need_dx=need_dx))
    finally:
        torch.backends.cudnn.benchmark = False
    del lib_args
    flops = block_flops(b, h, w, cin, c) + dgrad_flops(b, h, w, cin, c, need_dx)
    nbytes = (4 * b * h * w * (cin * (2 if need_dx else 1) + 4 * c)
              + 2 * block_weight_bytes(cin, c))
    bound, term = add_bound(entry, binding, flops, nbytes, per_step)
    log(f"kernel {label}: worst max_abs_err/max|plain| {worst[0]:.3e} ({worst[1]}; tol "
        f"{BWD_REL_TOL:.0e}), /max|ref64| {worst64[0]:.3e} ({worst64[1]}; tol "
        f"{BWD_REF64_TOL:.0e}), repeat bit-equal {same}, ms {ms:.3f} "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} library_ms {library_ms:.3f}"
        f"{' (cudnn.benchmark on)' if benchmark else ''} bound_ms {bound:.3f} ({term}) "
        f"{'ok' if ok else 'FAIL'}")
    entry["ms"] += per_step * ms
    entry["plain_ms"] += per_step * plain_ms
    entry["library_ms"] = (entry["library_ms"] or 0.0) + per_step * library_ms
    return ok


def oihw(w):
    """An HWIO kernel as cuDNN takes it: OIHW, channels-last."""
    import torch

    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def cudnn_block_bwd(g, x, h1, h2, h3, w1, w2, w3, need_dx):
    """The library's ConvBlock backward: for layers 3, 2, 1 the ReLU mask
    ``da = dh * [h > 0]``, then one cuDNN ``convolution_backward`` (dgrad,
    wgrad and bias gradient) on channels-last views, with the OIHW weights
    laid out beforehand (:func:`oihw`); the dual block's input is
    concatenated beforehand. Timed as ``library_ms`` only."""
    import torch

    dout, grads = g.permute(0, 3, 1, 2), []
    for k, (h_out, h_in, w) in enumerate(((h3, h2, w3), (h2, h1, w2), (h1, x, w1))):
        da = torch.where(h_out.permute(0, 3, 1, 2) > 0, dout, 0.0)
        dout, dw, db = torch.ops.aten.convolution_backward(
            da, h_in.permute(0, 3, 1, 2), w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [k < 2 or need_dx, True, True])
        grads = [dw, db] + grads
    return (dout, *grads)


def check_mc(entry, label, args, masking, binding, weight):
    """K3 against its plain version: the MC mean within K3_MEAN_TOL of the
    plain version's and of the plain version's in float64, the consensus
    only where a logit lies within K3_WINDOW of a threshold, two launches
    bit-equal; then times, TFLOP/s and the bound."""
    import torch

    from pda_torch.kernels import mc_consensus as km
    from pda_torch.tools.workload import cuda_ms, mc_bytes, mc_flops

    mean, cons = km.mc_consensus(*args, masking=masking)
    again = km.mc_consensus(*args, masking=masking)
    ref_mean, ref_cons = km.mc_consensus_plain(*args, masking)
    ref64 = km.mc_consensus_plain(*(a.double() for a in args), masking)[0]
    near = ((km.mc_logits_plain(*args).abs() - math.log(9.0)).abs() < K3_WINDOW).any(dim=0)
    torch.cuda.synchronize()
    err = float((mean - ref_mean).abs().max())
    err64 = float((mean.double() - ref64).abs().max())
    flips = int((cons != ref_cons).sum())
    stray = int(((cons != ref_cons) & ~near).sum())
    same = torch.equal(mean, again[0]) and torch.equal(cons, again[1])
    good = (bool(torch.isfinite(mean).all()) and err <= K3_MEAN_TOL and err64 <= K3_MEAN_TOL
            and stray == 0 and same)
    del mean, cons, again, ref_mean, ref_cons, ref64, near
    ms = cuda_ms(lambda: km.mc_consensus(*args, masking=masking))
    plain_ms = cuda_ms(lambda: km.mc_consensus_plain(*args, masking), iters=3)
    b, h, w, c = args[0].shape
    s, n_mid = args[1].shape[0], args[2].shape[0]
    flops = mc_flops(b, h, w, c, s, n_mid)
    bound, term = add_bound(entry, binding, flops, mc_bytes(b, h, w, c, s, n_mid), weight)
    log(f"kernel mc_consensus {label} S={s} feat {b}x{h}x{w}x{c} masking={masking}: mean "
        f"max_abs_err {err:.3e}, vs ref64 {err64:.3e} (tol {K3_MEAN_TOL:.0e}), consensus differs "
        f"at {flips} px, {stray} of them farther than {K3_WINDOW:.0e} from a threshold, repeat "
        f"bit-equal {same}; ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} "
        f"bound_ms {bound:.3f} ({term}) {'ok' if good else 'FAIL'}")
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms"] += weight * ms
    entry["plain_ms"] += weight * plain_ms
    return good


def cudnn_block(x, w1, b1, w2, b2, w3, b3):
    """The library's ConvBlock: three cuDNN convolutions (``F.conv2d`` with
    bias, then ReLU) on a channels-last (NHWC) batch, with the weights laid
    out beforehand (:func:`cudnn_weights`). Timed as ``library_ms`` only."""
    import torch.nn.functional as F

    h = x.permute(0, 3, 1, 2)
    for w, b in ((w1, b1), (w2, b2), (w3, b3)):
        h = F.relu(F.conv2d(h, w, b, padding=1))
    return h


def cudnn_weights(w1, b1, w2, b2, w3, b3):
    import torch

    return [t if t.ndim == 1 else t.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for t in (w1, b1, w2, b2, w3, b3)]


def phase_kernels(dev, results, binding):
    """Kernels against their plain versions; fills ``results`` per kernel."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools import workload as wl
    from pda_torch.tools.workload import block_flops, block_weight_bytes, conv_weights, cuda_ms

    gen = torch.Generator().manual_seed(SEED)
    k1, k2, k3 = results["conv_block_fwd"], results["conv_block_fwd_dual"], results["mc_consensus"]

    def check_conv(entry, label, kernel, plain, args, per_forward):
        """A forward kernel against its plain version: within K12_REL_TOL of
        the plain one's largest, within K12_REF64_TOL of the plain version's
        in float64, and two runs bit-equal; then times and the bound."""
        out, again, ref = kernel(*args), kernel(*args), plain(*args)
        ref64 = plain(*(a.double() for a in args))
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        err64 = float((out.double() - ref64).abs().max())
        scale64 = float(ref64.abs().max())
        ok = (bool(torch.isfinite(out).all()) and err <= K12_REL_TOL * scale
              and err64 <= K12_REF64_TOL * scale64 and same)
        del out, again, ref, ref64
        x = torch.cat(args[:-6], dim=-1)
        lib_args = (x, *cudnn_weights(*args[-6:]))
        ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
        library_ms = cuda_ms(lambda: cudnn_block(*lib_args))
        b, h, w, cin = x.shape
        c = args[-1].shape[0]
        flops = block_flops(b, h, w, cin, c)
        nbytes = 4 * b * h * w * (cin + 3 * c) + block_weight_bytes(cin, c)
        bound, term = add_bound(entry, binding, flops, nbytes, per_forward)
        del x, lib_args
        log(f"kernel {label}: max_abs_err/max|plain| {err / scale:.3e} (tol "
            f"{K12_REL_TOL:.0e}), /max|ref64| {err64 / scale64:.3e} (tol {K12_REF64_TOL:.0e}), "
            f"repeat bit-equal {same}, ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) plain_ms "
            f"{plain_ms:.3f} library_ms {library_ms:.3f} bound_ms {bound:.3f} ({term}) "
            f"{'ok' if ok else 'FAIL'}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms"] += per_forward * ms
        entry["plain_ms"] += per_forward * plain_ms
        entry["library_ms"] = (entry["library_ms"] or 0.0) + per_forward * library_ms
        return ok

    # every shape of the serving path, the MT step's posterior entry and the
    # learning check's blocks at width 96; the JSON line's times and bounds
    # sum one tiled forward's calls (weight 0: checked and logged only)
    ok = True
    for shape, per_forward in ([(s, 2) for s in wl.K1_TILED] + [(s, 0) for s in wl.K1_PSEUDO]
                               + [(wl.K1_POSTERIOR, 0), (wl.LEARN_BLOCK, 0)]):
        b, h, w, cin, c = shape
        x = torch.randn(b, h, w, cin, generator=gen).to(dev)
        ok &= check_conv(k1, f"conv_block_fwd {cin}->{c} @{b}x{h}x{w}", kc.conv_block_fwd,
                         kc.conv_block_fwd_plain, (x, *conv_weights(gen, cin, c, dev)),
                         per_forward)
    for shape, per_forward in ([(s, 1) for s in wl.K2_TILED] + [(s, 0) for s in wl.K2_PSEUDO]
                               + [(wl.LEARN_DUAL_BLOCK, 0)]):
        b, h, w, ca, cb, c = shape
        xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
        xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
        ok &= check_conv(k2, f"conv_block_fwd_dual {ca}+{cb}->{c} @{b}x{h}x{w}",
                         kc.conv_block_fwd_dual, kc.conv_block_fwd_dual_plain,
                         (xa, xb, *conv_weights(gen, ca + cb, c, dev)), per_forward)

    for (b, h, w, cin, c), need_dx, per_step in wl.BWD_SHAPES + [(wl.LEARN_BLOCK, True, 0)]:
        saved = saved_block(gen, b, h, w, cin, c, dev)
        ok &= check_bwd(results["conv_block_bwd"], f"conv_block_bwd {cin}->{c} @{b}x{h}x{w} "
                        f"need_dx={need_dx}", lambda *a: kc.conv_block_bwd(*a, need_dx=need_dx),
                        lambda *a: kc.conv_block_bwd_plain(*a, need_dx=need_dx), saved,
                        ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"), per_step, binding,
                        need_dx)
        del saved
    for (b, h, w, ca, cb, c), per_step in ([(s, 1) for s in wl.BWD_DUAL_SHAPES]
                                           + [(wl.LEARN_DUAL_BLOCK, 0)]):
        g, x, *rest = saved_block(gen, b, h, w, ca + cb, c, dev)
        args = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *rest)
        del x
        ok &= check_bwd(results["conv_block_bwd_dual"], f"conv_block_bwd_dual {ca}+{cb}->{c} "
                        f"@{b}x{h}x{w}", kc.conv_block_bwd_dual, kc.conv_block_bwd_dual_plain,
                        args, ("dxa", "dxb", "dw1", "db1", "dw2", "db2", "dw3", "db3"), per_step,
                        binding, True)
        del g, rest, args

    # K3 at the MC tail's shape on each path; the JSON line's times and bound
    # are the tiled forward's call (weight 0: checked and logged only)
    for name, (b, h, w, c), masking in wl.K3_SHAPES:
        ok &= check_mc(k3, name, wl.mc_inputs(gen, b, h, w, c, dev=dev), masking, binding,
                       int(name == "tiled"))
    torch.cuda.synchronize()
    return ok


def phase_serving(dev, results):
    """The two serving entries end to end; returns (ok, timings)."""
    import torch

    from pda_torch.infer import full_punet_pseudo, tiled_punet_probs
    from pda_torch.infer.tiling import extract_tiles, tile_standardize
    from pda_torch.kernels import conv_block as kc
    from pda_torch.kernels import mc_consensus as km
    from pda_torch.models.punet import livecell_punet, mc_pseudo
    from pda_torch.tools.workload import cuda_ms

    wrappers = {"conv_block_fwd": kc.conv_block_fwd,
                "conv_block_fwd_dual": kc.conv_block_fwd_dual,
                "mc_consensus": km.mc_consensus}
    expect = {"conv_block_fwd": 8, "conv_block_fwd_dual": 3, "mc_consensus": 1}
    gen = torch.Generator().manual_seed(SEED)
    model_cpu = livecell_punet(generator=torch.Generator().manual_seed(SEED), device="cpu").eval()
    model = copy.deepcopy(model_cpu).to(dev)
    frame = synthetic_frame(gen, FRAME, dev)
    n_tiles = 4
    eps_tiled = torch.randn(MC, n_tiles, 6, generator=gen).to(dev)
    eps_pseudo = torch.randn(MC, 1, 6, generator=gen).to(dev)

    def run_tiled():
        return tiled_punet_probs(model, frame, eps_tiled, MC, BLOCK, HALO)

    def run_pseudo():
        return full_punet_pseudo(model, frame, eps_pseudo, MC, masking=True)

    ok = True
    for name, run in (("tiled_punet_probs", run_tiled), ("full_punet_pseudo", run_pseudo)):
        for w in wrappers.values():
            w.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        for k, n in counts.items():
            results[k]["launches"] += n
        probs = out if name == "tiled_punet_probs" else out[0]
        good = (counts == expect and tuple(probs.shape) == (*FRAME, 1)
                and bool(torch.isfinite(probs).all())
                and float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0)
        if name == "full_punet_pseudo":
            cons = out[1]
            good &= tuple(cons.shape) == (*FRAME, 1) and bool(((cons == 0) | (cons == 1)).all())
            log(f"serving {name}: consensus share {float(cons.mean()):.4f}")
        log(f"serving {name}: shape {tuple(probs.shape)} range [{float(probs.min()):.4f}, "
            f"{float(probs.max()):.4f}] mean {float(probs.mean()):.4f} launches {counts} "
            f"(expected {expect}) {'ok' if good else 'FAIL'}")
        ok &= good

    # one 512^2 tile, MC-16: the card against the same port on the CPU
    with torch.inference_mode():
        tile = tile_standardize(extract_tiles(frame, BLOCK, HALO))[:1]
        eps0 = eps_tiled[:, :1]
        on_card = mc_pseudo(model, tile, MC, eps=eps0)[0]
        t0 = time.perf_counter()
        on_cpu = mc_pseudo(model_cpu, tile.cpu(), MC, eps=eps0.cpu())[0]
        cpu_s = time.perf_counter() - t0
    err = float((on_card.cpu() - on_cpu).abs().max())
    good = err <= TILE_TOL
    log(f"serving tile 512^2 MC-{MC} card vs cpu: max_abs_err {err:.3e} (tol {TILE_TOL:.0e}) "
        f"cpu {cpu_s:.1f} s {'ok' if good else 'FAIL'}")
    ok &= good

    torch.cuda.reset_peak_memory_stats()
    tiled_ms = cuda_ms(run_tiled, warmup=1, iters=5)
    tiled_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    pseudo_ms = cuda_ms(run_pseudo, warmup=1, iters=5)
    pseudo_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"time tiled_punet_probs MC-{MC} 520x704 (4 tiles of 512^2): {tiled_ms:.2f} ms/frame, "
        f"{1000.0 * n_tiles / tiled_ms:.2f} tiles/s, peak {tiled_peak:.2f} GiB")
    log(f"time full_punet_pseudo MC-{MC} 520x704 (padded 528x704): {pseudo_ms:.2f} ms/frame, "
        f"{1000.0 / pseudo_ms:.3f} frames/s, peak {pseudo_peak:.2f} GiB")
    return ok


def mt_batch(gen, frame, patch, dev):
    """(x, x1, x2, gt): two standardized patches of the frame (its top-left
    and bottom-right corners), a weak and a strong noisy view, and the
    bright-blob mask as ground truth, batch 2."""
    import torch

    from pda_torch.infer.tiling import tile_standardize

    h, w = frame.shape[:2]
    x = tile_standardize(torch.stack([frame[:patch, :patch], frame[h - patch:, w - patch:]]).cpu())
    x1 = x + 0.1 * torch.randn(x.shape, generator=gen)
    x2 = x + 0.3 * torch.randn(x.shape, generator=gen)
    return [a.to(dev) for a in (x, x1, x2, (x > 1.0).float())]


@contextlib.contextmanager
def recorded_blocks(out):
    """Append (h1, h2, h3) of every ConvBlock forward to ``out``, from the
    kernel on the card or the plain version on the CPU (for the ReLU-mask
    census of :func:`relu_flips`)."""
    from pda_torch.kernels import conv_block as kc

    launch, nhwc = kc._launch, kc._nhwc

    def record(fn):
        def run(*a, **k):
            hs = fn(*a, **k)
            out.append(hs)
            return hs
        return run

    kc._launch, kc._nhwc = record(launch), record(nhwc)
    try:
        yield out
    finally:
        kc._launch, kc._nhwc = launch, nhwc


def relu_flips(card_blocks, cpu_blocks):
    """(pixels whose ReLU output is 0 on one side and not on the other, the
    largest such nonzero output relative to its map's largest)."""
    n, margin = 0, 0.0
    for hs, hs_cpu in zip(card_blocks, cpu_blocks):
        for a, b in zip(hs, hs_cpu):
            a, b = a.detach().cpu(), b.detach()
            flip = (a > 0) != (b > 0)
            if flip.any():
                n += int(flip.sum())
                margin = max(margin, float((a - b).abs()[flip].max() / b.abs().max()))
    return n, margin


def check_step(label, card, cpu, aux, aux_cpu, init, lr, zero_grads=(), ref64=None):
    """One train step on the card against the same step of the port on the
    CPU: every aux value within MT_LOSS_TOL (relative to max(1, |ref|)); every
    gradient within MT_GRAD_TOL of its leaf's largest; the updated student
    within MT_PARAM_TOL wherever the reference gradient lies farther from 0
    than the gradients' error (nearer, Adam's sign is noise and the step is
    only held to lr); the teacher (if any) likewise, its noisy entries within
    2 lr (AdaMT's teacher is the student after its first step).
    ``zero_grads``: parameters whose exact gradient is 0 (the UNet's sampler
    biases, which the InstanceNorm after them takes out); their gradients are
    held to MT_GRAD_TOL of 1e-2 of the model's largest, their step is noise.

    ``ref64``: the same step of the port on the CPU in float64. A leaf beyond
    MT_GRAD_TOL of the CPU's float32 gradient then passes if its direction
    is within GRAD_COS_TOL of the float64 gradient's (1 - cosine), or within
    GRAD_COS_CPU times the CPU's own float32 distance: a ReLU pixel whose
    pre-activation lies within float32 rounding of 0 may switch sides
    between card and CPU and move one leaf by a few 1e-3 of its largest,
    and a leaf whose gradient is a small remainder of cancelling terms (the
    UNet's, after its InstanceNorms) is 1e-2 off float64 in float32 on the
    CPU too. The worst errors of card and CPU against float64 are printed
    beside."""
    import torch

    errs = {k: 0.0 if float(aux[k]) == float(v)  # equal, infinities included
            else abs(float(aux[k]) - float(v)) / max(1.0, abs(float(v)))
            for k, v in aux_cpu.items()}
    ok = set(aux) == set(aux_cpu) and all(e <= MT_LOSS_TOL for e in errs.values())
    log(f"{label} card vs cpu: loss {float(aux['loss']):.6f} vs {float(aux_cpu['loss']):.6f}, "
        f"relative errors {', '.join(f'{k} {e:.2e}' for k, e in errs.items())} (tol "
        f"{MT_LOSS_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    worst, worst64, cpu_worst64, worst_cos = (0.0, ""), (0.0, ""), (0.0, ""), (1.0, "", 1.0)
    param_worst, teacher_worst, sign_ok, n_beyond, n_bad = 0.0, 0.0, True, 0, 0
    top = max(float(p.grad.abs().max()) for p in cpu.model.parameters())
    refs = (itertools.repeat(None) if ref64 is None
            else (p.grad for p in ref64.model.parameters()))
    teachers = (itertools.repeat(None) if card.teacher is None
                else zip(card.teacher.parameters(), cpu.teacher.parameters()))
    for (name, p), p_cpu, g64, tp in zip(card.model.named_parameters(), cpu.model.parameters(),
                                         refs, teachers):
        g, g_cpu = p.grad.cpu(), p_cpu.grad
        zero = name in zero_grads
        scale = 1e-2 * top if zero else float(g_cpu.abs().max())
        err = float((g - g_cpu).abs().max())
        worst = max(worst, (err / scale, name))
        beyond = err > MT_GRAD_TOL * scale
        noise = max(MT_GRAD_TOL * scale, err)  # the gradients' error
        sign_ref = g_cpu
        if g64 is not None:
            e64, c64 = float((g.double() - g64).abs().max()), float((g_cpu.double() - g64).abs().max())
            worst64 = max(worst64, (e64 / scale, name))
            cpu_worst64 = max(cpu_worst64, (c64 / scale, name))
            noise, sign_ref = max(noise, e64, c64), g64
            if beyond and not zero:
                cos, cos_cpu = (float(torch.nn.functional.cosine_similarity(
                    a.double().flatten(), g64.flatten(), dim=0)) for a in (g, g_cpu))
                worst_cos = min(worst_cos, (cos, name, cos_cpu))
                n_beyond += 1
                beyond = 1.0 - cos > max(GRAD_COS_TOL, GRAD_COS_CPU * (1.0 - cos_cpu))
        n_bad += beyond
        noisy = (sign_ref.abs() <= noise).cpu() | zero  # there Adam's sign is noise
        diff = (p.detach().cpu() - p_cpu.detach()).abs()
        param_worst = max(param_worst, float(torch.where(noisy, 0.0, diff).max()))
        moved = (p_cpu.detach() - init[name]).abs()
        sign_ok &= float(torch.where(noisy, moved, 0.0).max()) <= lr + MT_PARAM_TOL
        if tp is not None:  # the teacher follows the student, noise included
            t_diff = (tp[0].cpu() - tp[1]).abs()
            teacher_worst = max(teacher_worst, float(torch.where(noisy, 0.0, t_diff).max()))
            sign_ok &= float(torch.where(noisy, t_diff, 0.0).max()) <= 2 * lr + MT_PARAM_TOL
    good = (n_bad == 0 and param_worst <= MT_PARAM_TOL and sign_ok
            and teacher_worst <= MT_PARAM_TOL and card.step == cpu.step == 1)
    grads = (f"gradients worst max_abs_err/max|ref| {worst[0]:.3e} ({worst[1]}; tol "
             f"{MT_GRAD_TOL:.0e})")
    if ref64 is not None:
        grads += (f", {n_beyond} leaves beyond it, their worst cosine to float64 "
                  f"{worst_cos[0]:.8f} ({worst_cos[1]}; the CPU's float32 {worst_cos[2]:.8f}; tol "
                  f"1 - max({GRAD_COS_TOL:.0e}, {GRAD_COS_CPU:g} x the CPU's)); against "
                  f"the CPU's float64 step: card {worst64[0]:.3e} ({worst64[1]}), the CPU's "
                  f"float32 {cpu_worst64[0]:.3e} ({cpu_worst64[1]})")
    log(f"{label} card vs cpu: {grads}; updated student max_abs_err {param_worst:.3e}, teacher "
        f"{teacher_worst:.3e} (tol {MT_PARAM_TOL:.0e}) {'ok' if good else 'FAIL'}")
    return ok and good


def phase_training(dev, results):
    """The Mean-Teacher step of the flagship: one step at 128^2 on the card
    against the port on the CPU, launch counts, then timed 512^2 steps.
    Returns (ok, the timed step's median ms)."""
    import torch

    from pda_torch.models.punet import livecell_punet, mc_decode_logits
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step, steps

    wrappers = kernel_wrappers()
    gen = torch.Generator().manual_seed(SEED + 1)
    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED),
                           device="cpu")
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(LAST_SCALE)
    frame = synthetic_frame(gen, FRAME, "cpu")
    step = make_mean_teacher_step(momentum=MT_MOMENTUM, do_consensus_masking=True)

    def state_on(device):
        student = copy.deepcopy(model).to(device)
        return create_train_state(student, adam(student.parameters(), MT_LR), with_teacher=True)

    # 1. one step at 128^2 on the card and on the CPU, same weights, batch, noise
    batch = mt_batch(gen, frame, MT_CHECK_PATCH, "cpu")
    noise = {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen),
             "eps_post": torch.randn(MT_BATCH, 6, generator=gen)}
    card, cpu = state_on(dev), state_on("cpu")
    for w in wrappers.values():
        w.launches = 0
    _, aux = step(card, *(a.to(dev) for a in batch), **{k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    for k, n in counts.items():
        results[k]["launches"] += n
    ok = counts == MT_LAUNCHES
    log(f"training MT step 128^2: launches {counts} (expected {MT_LAUNCHES}) "
        f"{'ok' if ok else 'FAIL'}")

    # the teacher's pseudo-labels: K3 on the card against the plain tail on the CPU
    t0 = time.perf_counter()
    y, z = steps._mc_pseudo(copy.deepcopy(model).to(dev), batch[1].to(dev), MC, True,
                            noise["eps_teacher"])
    y_cpu, z_cpu = steps._mc_pseudo(cpu.teacher, batch[1], MC, True, noise["eps_teacher"])
    with torch.no_grad():
        enc = cpu.teacher.encode(batch[1])
        logits = mc_decode_logits(cpu.teacher, enc.features, enc.prior, MC,
                                  eps=noise["eps_teacher"])
    near = ((logits.abs() - torch.log(torch.tensor(9.0))).abs() < K3_WINDOW).any(dim=0)
    flips = int((z.cpu() != z_cpu).sum())
    stray = int(((z.cpu() != z_cpu) & ~near).sum())
    share = float(z.mean())
    y_err = float((y.cpu() - y_cpu).abs().max())
    good = stray == 0 and y_err <= TILE_TOL and 0.0 < share < 1.0
    log(f"training teacher pseudo-labels card vs cpu: max_abs_err {y_err:.3e} (tol "
        f"{TILE_TOL:.0e}), consensus share {share:.4f}, {flips} px flip, {stray} of them "
        f"farther than {K3_WINDOW:.0e} from a threshold {'ok' if good else 'FAIL'}")
    ok &= good

    # the CPU step takes the card teacher's pseudo-labels, so that a pixel
    # flipped within the threshold window does not count as a step difference
    pseudo = steps._mc_pseudo
    steps._mc_pseudo = lambda *a, **k: (y.cpu(), z.cpu())
    try:
        _, aux_cpu = step(cpu, *batch, **noise)
    finally:
        steps._mc_pseudo = pseudo
    cpu_s = time.perf_counter() - t0
    ok &= check_step("training MT step", card, cpu, aux, aux_cpu, model.state_dict(), MT_LR)
    log(f"training MT step card vs cpu: cpu {cpu_s:.1f} s")
    del card, cpu, logits, enc

    # 2. timed steps at 512^2, batch 2, fresh noise from a card generator
    good, ms = time_steps(f"MT step MC-{MC} 512^2 batch {MT_BATCH} f32", step, state_on(dev),
                          mt_batch(gen, frame, MT_TIME_PATCH, dev), MT_BATCH, wrappers,
                          MT_LAUNCHES, MT_WARMUP, MT_TIMED,
                          torch.Generator(device=dev).manual_seed(SEED))
    return ok and good, ms


def time_steps(label, step, state, batch, n_patches, wrappers, launches, warmup, timed,
               generator=None):
    """Train steps on the card, timed: the CUDA-event median of ``timed``
    steps after ``warmup``, ms/step, patches/s and peak memory; every loss
    finite and each kernel launched ``launches[name]`` times a step.
    Returns (ok, ms)."""
    import torch

    for w in wrappers.values():
        w.launches = 0
    kw = {} if generator is None else {"generator": generator}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for _ in range(warmup + timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, aux = step(state, *batch, **kw)
        end.record()
        losses.append(aux["loss"])
        events.append((start, end))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [s.elapsed_time(e) for s, e in events[warmup:]]
    ms = statistics.median(times)
    counts = {k: w.launches for k, w in wrappers.items()}
    n = warmup + timed
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    good = finite and counts == {k: n * v for k, v in launches.items()} and state.step == n
    log(f"training {label}: losses {[round(float(v), 5) for v in losses]} finite {finite}, "
        f"launches {counts} over {n} steps {'ok' if good else 'FAIL'}")
    log(f"time {label}: {ms:.2f} ms/step (median of {timed}, min {min(times):.2f}, max "
        f"{max(times):.2f}), {n_patches} patches a step, {1000.0 * n_patches / ms:.3f} "
        f"patches/s, peak {peak:.2f} GiB")
    return good, ms


def phase_algorithms(dev, results, binding):
    """The fault-3.1 widths and class counts, the pseudo-PUNet, FixMatch,
    AdaMT and AdaMatch steps of the flagship, and the UNet2d path: each on
    the card against the port on the CPU, with its kernel launch counts, then
    timed."""
    import torch

    from pda_torch import train as tt
    from pda_torch.infer import tiled_unet_probs
    from pda_torch.infer.tiling import extract_tiles, tile_standardize
    from pda_torch.models import ProbabilisticUnet, UNet2d
    from pda_torch.models.punet import (livecell_punet, mc_decode_logits, mc_predict_probs,
                                        mc_pseudo)
    from pda_torch.tools import workload as wl
    from pda_torch.tools.workload import cuda_ms
    from pda_torch.train import adam, create_train_state, steps

    wrappers = kernel_wrappers()

    def reset():
        reset_launches(wrappers)

    def counted():
        return counted_launches(wrappers, results)

    gen = torch.Generator().manual_seed(SEED + 2)
    ok = True

    # 1. fault 3.1: K3 at the widths it once refused, then whole PUNets
    with torch.inference_mode():
        for c in FAULT_WIDTHS:
            for masking in (False, True):
                ok &= check_mc(results["mc_consensus"], f"C={c}",
                               wl.mc_inputs(gen, 2, 128, 128, c, dev=dev), masking, binding, 0)
    frame = synthetic_frame(gen, FRAME, "cpu")
    x = mt_batch(gen, frame, ALG_CHECK_PATCH, "cpu")[1]
    eps = torch.randn(MC, MT_BATCH, 6, generator=gen)
    for n_classes in (1, 2):
        small = ProbabilisticUnet(num_classes=n_classes, num_filters=SMALL_FILTERS,
                                  no_convs_fcomb=3, beta=1.0, rl_swap=True,
                                  generator=torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            small.fcomb.last_layer.weight.mul_(LAST_SCALE)
        on_card = copy.deepcopy(small).to(dev)
        with torch.inference_mode():
            reset()
            y, z = mc_pseudo(on_card, x.to(dev), MC, eps=eps.to(dev), masking=True)
            mean = mc_predict_probs(on_card, x.to(dev), MC, eps=eps.to(dev))
            torch.cuda.synchronize()
            counts = read_launches(wrappers)
            y_cpu, z_cpu = mc_pseudo(small, x, MC, eps=eps, masking=True)
            mean_cpu = mc_predict_probs(small, x, MC, eps=eps)
            enc = small.encode(x)
            logits = mc_decode_logits(small, enc.features, enc.prior, MC, eps=eps)
        near = ((logits.abs() - math.log(9.0)).abs() < K3_WINDOW).any(dim=0)
        flips = int((z.cpu() != z_cpu).sum())
        stray = int(((z.cpu() != z_cpu) & ~near).sum())
        err = max(float((y.cpu() - y_cpu).abs().max()), float((mean.cpu() - mean_cpu).abs().max()))
        want_mc = 2 if n_classes == 1 else 0  # mc_pseudo and the val predictor
        good = (tuple(y.shape) == tuple(mean.shape) == (MT_BATCH, ALG_CHECK_PATCH,
                                                        ALG_CHECK_PATCH, n_classes)
                and err <= TILE_TOL and stray == 0 and counts["mc_consensus"] == want_mc)
        log(f"algorithms PUNet num_filters {SMALL_FILTERS}, {n_classes} class(es), MC-{MC} "
            f"{ALG_CHECK_PATCH}^2 batch {MT_BATCH} card vs cpu: pseudo-label and mean max_abs_err "
            f"{err:.3e} (tol {TILE_TOL:.0e}), consensus share {float(z.mean()):.4f}, {flips} px "
            f"flip, {stray} of them farther than {K3_WINDOW:.0e} from a threshold; mc_consensus "
            f"launches {counts['mc_consensus']} (expected {want_mc}) {'ok' if good else 'FAIL'}")
        ok &= good
        del small, on_card, enc, logits

    # 2. the other PUNet steps at the flagship's widths, 128^2 card vs CPU
    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED),
                           device="cpu")
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(LAST_SCALE)
    init = model.state_dict()
    source_frame = synthetic_frame(gen, FRAME, "cpu")

    def state_on(device, with_teacher, dtype=torch.float32):
        student = copy.deepcopy(model).to(device=device, dtype=dtype)
        return create_train_state(student, adam(student.parameters(), MT_LR),
                                  with_teacher=with_teacher)

    def batch_of(algo, patch, device):
        """pseudo PUNet: (x, y, z) with soft pseudo-labels and a consensus
        mask as read from disk; FixMatch: (x, x1, x2, gt); the joint steps:
        (xs, ys) of another frame + the target's (xt, xt1, xt2, yt)."""
        g = torch.Generator().manual_seed(SEED + patch)
        target = mt_batch(g, frame, patch, device)
        if algo == "pseudo_punet":
            y = torch.sigmoid(2.0 * target[1])
            return target[2], y, ((y - 0.5).abs() > 0.3).float()
        if algo == "fixmatch":
            return target
        xs, _, _, ys = mt_batch(g, source_frame, patch, device)
        return (xs, ys, *target)

    noise_shapes = {"eps_post": (MT_BATCH, 6), "eps_source": (MT_BATCH, 6),
                    "eps_teacher": (MC, MT_BATCH, 6), "eps_weak": (MC, MT_BATCH, 6)}
    algos = {
        "pseudo_punet": (tt.make_pseudo_punet_step(), False, ("eps_post",)),
        "fixmatch": (tt.make_fixmatch_step(source_distribution=SOURCE_DISTRIBUTION,
                                           do_consensus_masking=True), False,
                     ("eps_weak", "eps_post")),
        "adamt": (tt.make_adamt_step(momentum=MT_MOMENTUM, do_consensus_masking=True), True,
                  ("eps_source", "eps_teacher", "eps_post")),
        "adamatch": (tt.make_adamatch_step(do_consensus_masking=True), False,
                     ("eps_source", "eps_weak", "eps_post")),
    }
    pseudo = steps._mc_pseudo
    for algo, (step, with_teacher, names) in algos.items():
        batch = batch_of(algo, ALG_CHECK_PATCH, "cpu")
        noise = {k: torch.randn(*noise_shapes[k], generator=gen) for k in names}
        card, cpu = state_on(dev, with_teacher), state_on("cpu", with_teacher)
        drawn, card_blocks, cpu_blocks = [], [], []

        def capture(*a, **k):  # the pseudo-label pass, kept out of the census
            n = len(card_blocks)
            drawn.append(pseudo(*a, **k))
            del card_blocks[n:]
            return drawn[-1]

        steps._mc_pseudo = capture
        reset()
        try:
            with recorded_blocks(card_blocks):
                _, aux = step(card, *(a.to(dev) for a in batch),
                              **{k: v.to(dev) for k, v in noise.items()})
            torch.cuda.synchronize()
        finally:
            steps._mc_pseudo = pseudo
        counts = counted()
        good = counts == ALG_LAUNCHES[algo]
        log(f"algorithms {algo} step {ALG_CHECK_PATCH}^2: launches {counts} (expected "
            f"{ALG_LAUNCHES[algo]}) {'ok' if good else 'FAIL'}")
        # the CPU steps (float32, and float64 for the gradients' reference)
        # take the card's pseudo-labels, so that a consensus pixel flipped
        # within K3's threshold window is no step difference
        t0 = time.perf_counter()
        cpu64 = state_on("cpu", with_teacher, torch.float64)
        for state, dtype in ((cpu, torch.float32), (cpu64, torch.float64)):
            if drawn:
                y, z = (t.to("cpu", dtype) for t in drawn[0])
                steps._mc_pseudo = lambda *a, **k: (y, z)
            try:
                with recorded_blocks(cpu_blocks if dtype == torch.float32 else []):
                    _, out = step(state, *(a.to(dtype) for a in batch),
                                  **{k: v.to(dtype) for k, v in noise.items()})
            finally:
                steps._mc_pseudo = pseudo
            if dtype == torch.float32:
                aux_cpu = out
        cpu_s = time.perf_counter() - t0
        flips, margin = relu_flips(card_blocks, cpu_blocks)
        log(f"algorithms {algo} step {ALG_CHECK_PATCH}^2: ReLU masks of the student's "
            f"{len(cpu_blocks)} ConvBlocks card vs cpu: {flips} px differ, each output within "
            f"{margin:.1e} of 0 (relative to its map's largest)")
        del card_blocks, cpu_blocks
        good &= check_step(f"algorithms {algo} step {ALG_CHECK_PATCH}^2", card, cpu, aux,
                           aux_cpu, init, MT_LR, ref64=cpu64)
        log(f"algorithms {algo} step card vs cpu: cpu (float32 and float64) {cpu_s:.1f} s")
        ok &= good
        del card, cpu, cpu64, drawn

    # 3. the PUNet steps timed at 512^2, batch 2 (the joint steps: 2 source
    # and 2 target patches), noise from a card generator
    cuda_gen = torch.Generator(device=dev).manual_seed(SEED)
    for algo, (step, with_teacher, _) in algos.items():
        n_patches = 2 * MT_BATCH if algo in ("adamt", "adamatch") else MT_BATCH
        good, _ = time_steps(f"{algo} step MC-{MC} {ALG_TIME_PATCH}^2 batch {MT_BATCH} f32",
                             step, state_on(dev, with_teacher),
                             batch_of(algo, ALG_TIME_PATCH, dev), n_patches, wrappers,
                             ALG_LAUNCHES[algo], ALG_WARMUP, ALG_TIMED, cuda_gen)
        ok &= good
    del model

    # 4. UNet2d: the supervised and pseudo-label steps at 256^2, batch 4,
    # Adam 1e-4, card vs CPU; then timed; no kernel of the port launches
    unet = UNet2d(depth=4, initial_features=64, final_activation="sigmoid",
                  generator=torch.Generator().manual_seed(SEED))
    zero_grads = tuple(n for n, _ in unet.named_parameters()
                       if n.startswith("decoder.samplers.") and n.endswith(".bias"))
    h, w = FRAME
    p = UNET_PATCH
    ux = tile_standardize(torch.stack([frame[:p, :p], frame[:p, w - p:], frame[h - p:, :p],
                                       frame[h - p:, w - p:]]))
    soft = torch.sigmoid(2.0 * ux)
    unet_steps = {"supervised_unet": (tt.make_supervised_unet_step(), (ux, (ux > 1.0).float())),
                  "pseudo_unet": (tt.make_pseudo_unet_step(),
                                  (ux, soft, ((soft - 0.5).abs() > 0.3).float()))}

    def unet_state(device, dtype=torch.float32):
        m = copy.deepcopy(unet).to(device=device, dtype=dtype)
        return create_train_state(m, adam(m.parameters(), UNET_LR))

    for name, (step, batch) in unet_steps.items():
        card, cpu, cpu64 = unet_state(dev), unet_state("cpu"), unet_state("cpu", torch.float64)
        reset()
        _, aux = step(card, *(a.to(dev) for a in batch))
        torch.cuda.synchronize()
        counts = counted()
        good = counts == NO_LAUNCHES
        log(f"algorithms {name} step {p}^2 batch {UNET_BATCH}: launches {counts} (expected "
            f"none) {'ok' if good else 'FAIL'}")
        _, aux_cpu = step(cpu, *batch)
        step(cpu64, *(a.double() for a in batch))
        good &= check_step(f"algorithms {name} step {p}^2 batch {UNET_BATCH}", card, cpu, aux,
                           aux_cpu, unet.state_dict(), UNET_LR, zero_grads, ref64=cpu64)
        ok &= good
        del card, cpu, cpu64
    for name, (step, batch) in unet_steps.items():
        good, _ = time_steps(f"{name} step {p}^2 batch {UNET_BATCH} f32", step, unet_state(dev),
                             tuple(a.to(dev) for a in batch), UNET_BATCH, wrappers, NO_LAUNCHES,
                             ALG_WARMUP, ALG_TIMED)
        ok &= good
    # yardsticks, not the port's path: the supervised step under cuDNN's
    # autotuner, and with cuDNN off (PyTorch's own CUDA convolutions)
    step, batch = unet_steps["supervised_unet"]
    for mode, flags in (("cudnn.benchmark on", {"benchmark": True}),
                        ("cuDNN off", {"enabled": False})):
        with torch.backends.cudnn.flags(**{"enabled": True, "benchmark": False,
                                           "deterministic": False, "allow_tf32": False,
                                           **flags}):
            time_steps(f"supervised_unet step {p}^2 batch {UNET_BATCH} f32 ({mode}, a "
                       f"yardstick)", step, unet_state(dev), tuple(a.to(dev) for a in batch),
                       UNET_BATCH, wrappers, NO_LAUNCHES, ALG_WARMUP, ALG_TIMED)

    # 5. unet_prediction's tiled path on the 520x704 frame; one tile card vs CPU
    on_card = copy.deepcopy(unet).to(dev).eval()
    frame_dev = frame.to(dev)
    reset()
    probs = tiled_unet_probs(on_card, frame_dev, BLOCK, HALO)
    torch.cuda.synchronize()
    counts = counted()
    with torch.inference_mode():
        tile = tile_standardize(extract_tiles(frame_dev, BLOCK, HALO))[:1]
        err = float((on_card(tile).cpu() - unet.eval()(tile.cpu())).abs().max())
    good = (counts == NO_LAUNCHES and tuple(probs.shape) == (*FRAME, 1)
            and bool(torch.isfinite(probs).all()) and float(probs.min()) >= 0.0
            and float(probs.max()) <= 1.0 and err <= TILE_TOL)
    log(f"algorithms tiled_unet_probs 520x704: shape {tuple(probs.shape)} range "
        f"[{float(probs.min()):.4f}, {float(probs.max()):.4f}], one 512^2 tile card vs cpu "
        f"max_abs_err {err:.3e} (tol {TILE_TOL:.0e}), launches {counts} (expected none) "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: tiled_unet_probs(on_card, frame_dev, BLOCK, HALO), warmup=1, iters=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"time tiled_unet_probs UNet2d(depth 4, 64) 520x704 (4 tiles of 512^2): {ms:.2f} "
        f"ms/frame, {4000.0 / ms:.2f} tiles/s, peak {peak:.2f} GiB")
    return ok


def kernel_wrappers():
    """The five kernels' wrappers, each with its ``launches`` count."""
    from pda_torch.kernels import conv_block as kc
    from pda_torch.kernels import mc_consensus as km

    return {"conv_block_fwd": kc.conv_block_fwd, "conv_block_fwd_dual": kc.conv_block_fwd_dual,
            "mc_consensus": km.mc_consensus, "conv_block_bwd": kc.conv_block_bwd,
            "conv_block_bwd_dual": kc.conv_block_bwd_dual}


def reset_launches(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_launches(wrappers):
    """The launches since :func:`reset_launches` (a check's, logged only)."""
    return {k: w.launches for k, w in wrappers.items()}


def counted_launches(wrappers, results):
    """The launches since :func:`reset_launches` of a main path's run, added
    to the JSON line's counts."""
    counts = read_launches(wrappers)
    for k, n in counts.items():
        results[k]["launches"] += n
    return counts


def same_trainer_state(a, b):
    """Bit-equal student, teacher, Adam moments and steps, iteration, best
    metric, plateau state and noise generators."""
    import torch

    ok = all(torch.equal(v, w) for m, n in ((a.state.model, b.state.model),
                                             (a.state.teacher, b.state.teacher))
             for v, w in zip(m.state_dict().values(), n.state_dict().values()))
    sa, sb = a.state.optimizer.state_dict()["state"], b.state.optimizer.state_dict()["state"]
    ok &= sorted(sa) == sorted(sb) and all(
        torch.equal(sa[k][key].cpu(), sb[k][key].cpu()) for k in sa
        for key in ("step", "exp_avg", "exp_avg_sq"))
    ok &= (a._iteration, a._best_metric) == (b._iteration, b._best_metric)
    ok &= a.lr_scheduler.state_dict() == b.lr_scheduler.state_dict()
    ok &= a.state.learning_rate == b.state.learning_rate
    ok &= all(torch.equal(g.get_state(), h.get_state()) for g, h in
              ((a.generator, b.generator), (a.panel_generator, b.panel_generator)))
    return ok


def check_fit(label, card, cpu, grads, init, lr):
    """The final student and teacher of a fit on the card against the same
    fit on the CPU, each step's gradients as :func:`check_step` judges one
    step's (within MT_GRAD_TOL of the CPU's float32 leaf, or by cosine to
    the float64 fit's); the weights within MT_PARAM_TOL wherever no step's
    float64 gradient lay within the gradients' error of 0 (there Adam's
    sign is noise, and the student is held to steps x lr of its start, the
    teacher to twice that of the CPU's)."""
    import torch

    n_steps = len(grads["card"])
    params = list(cpu.state.model.parameters())
    noisy = [torch.zeros(p.shape, dtype=torch.bool) for p in params]
    worst, worst_cos, n_beyond, n_bad = (0.0, ""), (1.0, "", 1.0), 0, 0
    names = [n for n, _ in card.state.model.named_parameters()]
    for k in range(n_steps):
        for i, name in enumerate(names):
            g, gc, g64 = grads["card"][k][i], grads["cpu"][k][i], grads["cpu64"][k][i]
            scale = float(gc.abs().max())
            err = float((g - gc).abs().max())
            worst = max(worst, (err / scale if scale else err, f"step {k} {name}"))
            noise = max(MT_GRAD_TOL * scale, err, float((g - g64).abs().max()),
                        float((gc - g64).abs().max()))
            noisy[i] |= g64.abs() <= noise
            if err > MT_GRAD_TOL * scale:
                n_beyond += 1
                cos, cos_cpu = (float(torch.nn.functional.cosine_similarity(
                    a.flatten(), g64.flatten(), dim=0)) for a in (g, gc))
                worst_cos = min(worst_cos, (cos, f"step {k} {name}", cos_cpu))
                n_bad += 1.0 - cos > max(GRAD_COS_TOL, GRAD_COS_CPU * (1.0 - cos_cpu))
    student, teacher, sign_ok = 0.0, 0.0, True
    for i, ((name, p), pc, tp, tc) in enumerate(zip(
            card.state.model.named_parameters(), params, card.state.teacher.parameters(),
            cpu.state.teacher.parameters())):
        diff = (p.detach().cpu() - pc.detach()).abs()
        student = max(student, float(torch.where(noisy[i], 0.0, diff).max()))
        moved = (pc.detach() - init[name]).abs()
        sign_ok &= float(torch.where(noisy[i], moved, 0.0).max()) <= n_steps * lr + MT_PARAM_TOL
        t_diff = (tp.detach().cpu() - tc.detach()).abs()
        teacher = max(teacher, float(torch.where(noisy[i], 0.0, t_diff).max()))
        sign_ok &= (float(torch.where(noisy[i], t_diff, 0.0).max())
                    <= 2 * n_steps * lr + MT_PARAM_TOL)
    good = n_bad == 0 and student <= MT_PARAM_TOL and teacher <= MT_PARAM_TOL and sign_ok
    log(f"{label} card vs cpu: {n_steps} steps' gradients worst max_abs_err/max|ref| "
        f"{worst[0]:.3e} ({worst[1]}; tol {MT_GRAD_TOL:.0e}), {n_beyond} leaves beyond it, "
        f"their worst cosine to float64 {worst_cos[0]:.8f} ({worst_cos[1]}; the CPU's float32 "
        f"{worst_cos[2]:.8f}); final student max_abs_err {student:.3e}, teacher {teacher:.3e} "
        f"(tol {MT_PARAM_TOL:.0e}, where Adam's sign is defined), the rest within steps x lr "
        f"{sign_ok} {'ok' if good else 'FAIL'}")
    return good


def phase_engine(dev, results, bare_ms):
    """The training engine on the card: the flagship's MT fit at 512^2, the
    reload and resume, the fit at 128^2 card vs CPU, the learning check."""
    import torch

    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.tools.workload import livecell_mt_trainer
    from pda_torch.train import LATEST, PUNetTrainer, ReduceLROnPlateau, steps

    wrappers = kernel_wrappers()

    def reset():
        reset_launches(wrappers)

    def expected(n_steps, step, n_val, val, n_panels):
        return {k: n_steps * step[k] + n_val * val[k] + n_panels * MT_PANEL_LAUNCHES[k]
                for k in MT_LAUNCHES}

    def finite(history):
        return all(math.isfinite(v) for _, h in history for v in h.values())

    def flagship(root):
        return livecell_mt_trainer(root, device=dev, steps_per_epoch=ENGINE_EPOCH)

    ok = True
    with tempfile.TemporaryDirectory() as root:
        # 1. the flagship's MT fit at 512^2, batch 2, through the port's data path
        trainer = flagship(root)
        t0 = time.perf_counter()
        trainer.initialize()  # the loader's worker processes start, one example batch
        init_s = time.perf_counter() - t0
        starts, train = [], trainer.train_step

        def timed_step(state, *batch, **kw):  # a CUDA event as each step starts
            starts.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
            return train(state, *batch, **kw)

        trainer.train_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        stats = trainer.fit(ENGINE_FIT)
        torch.cuda.synchronize()
        counts = counted_launches(wrappers, results)  # the main path's run
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_val = ENGINE_FIT // ENGINE_EPOCH
        n_panels = len(range(0, ENGINE_FIT, trainer.logger.log_image_interval)) + n_val
        want = expected(ENGINE_FIT, MT_LAUNCHES, n_val, MT_VAL_LAUNCHES, n_panels)
        files = sorted(os.listdir(trainer.ckpt_dir))
        good = (counts == want and [i for i, _ in trainer.history] == list(range(ENGINE_FIT))
                and [i for i, _ in trainer.val_history] == [ENGINE_EPOCH, ENGINE_FIT]
                and finite(trainer.history) and finite(trainer.val_history)
                and files == ["best.pt", "latest.pt"])
        log(f"engine MeanTeacherTrainer.fit({ENGINE_FIT}) 512^2 batch {MT_BATCH}: losses "
            f"{[round(h['loss'], 5) for _, h in trainer.history]}; validations "
            f"{[(i, {k: round(v, 5) for k, v in m.items()}) for i, m in trainer.val_history]}; "
            f"learning rate {trainer.state.learning_rate:g}; {files} "
            f"({os.path.getsize(os.path.join(trainer.ckpt_dir, 'latest.pt')) / 2**20:.1f} MiB "
            f"each); launches {counts} (expected {ENGINE_FIT} steps, {n_val} validations, "
            f"{n_panels} panel passes: {want}) {'ok' if good else 'FAIL'}")
        ok &= good
        # the loop: one step's start to the next one's on the card's clock,
        # within an epoch (a validation and the checkpoints lie between epochs)
        loop = [a.elapsed_time(b) for k, (a, b) in enumerate(zip(starts, starts[1:]))
                if (k + 1) % ENGINE_EPOCH]
        loop_ms = statistics.median(loop)
        ms_iter = 1000.0 * stats["elapsed_sec"] / stats["steps"]
        ckpt_s = trainer.timings["checkpoint"]
        unwritten_ms = 1000.0 * (stats["elapsed_sec"] - ckpt_s) / stats["steps"]
        host = ", ".join(f"{k} {v:.3f}" for k, v in sorted(trainer.timings.items(),
                                                           key=lambda kv: -kv[1]))
        log(f"time engine MeanTeacherTrainer.fit({ENGINE_FIT}) 512^2 batch {MT_BATCH} f32, "
            f"epochs of {ENGINE_EPOCH}: the fit's Throughput (the train loop with each epoch's "
            f"first batch and the epochs' checkpoint writes, not the validations) "
            f"{ms_iter:.2f} ms/iteration, {stats['patches_per_sec']:.3f} patches/s, "
            f"{bare_ms / ms_iter:.3f} of the bare MT step's {bare_ms:.2f} ms "
            f"({1000.0 * MT_BATCH / bare_ms:.3f} patches/s; aim {ENGINE_MIN_SHARE}); less its "
            f"checkpoint writes ({ckpt_s:.3f} s) {unwritten_ms:.2f} ms/iteration, "
            f"{bare_ms / unwritten_ms:.3f}; the host loop within an epoch {loop_ms:.2f} "
            f"ms/iteration (median of {len(loop)} step-to-step spans, CUDA events; min "
            f"{min(loop):.2f}, max {max(loop):.2f}), {bare_ms / loop_ms:.3f}; peak {peak:.2f} "
            f"GiB; set-up {init_s:.1f} s; host seconds by part: {host}")

        # 2. a fresh trainer reloads latest.pt bit for bit, then resumes to 10
        fresh = flagship(root)
        fresh.load_checkpoint(LATEST)
        same = same_trainer_state(trainer, fresh)
        del trainer
        reset()
        fresh.fit(ENGINE_RESUME, overwrite_training=False)
        torch.cuda.synchronize()
        counts = read_launches(wrappers)
        n_steps = ENGINE_RESUME - ENGINE_FIT
        want = expected(n_steps, MT_LAUNCHES, 1, MT_VAL_LAUNCHES, 2)
        good = (same and counts == want and fresh._iteration == ENGINE_RESUME
                and [i for i, _ in fresh.history] == list(range(ENGINE_FIT, ENGINE_RESUME))
                and finite(fresh.history))
        log(f"engine reload of latest.pt: student, teacher, Adam moments and steps, iteration, "
            f"best metric, plateau state, generators bit-equal {same}; fit({ENGINE_RESUME}, "
            f"overwrite_training=False) resumed at {fresh.history[0][0]}, losses "
            f"{[round(h['loss'], 5) for _, h in fresh.history]}, launches {counts} (expected "
            f"{want}) {'ok' if good else 'FAIL'}")
        ok &= good
        del fresh

        # 3. the same fit at 128^2 (2 steps, 1 validation) on the card, the CPU
        # (float32) and the CPU in float64; the CPU fits take the card
        # teacher's pseudo-labels, so that a consensus pixel flipped within
        # the MC kernel's threshold window is no difference
        fits, grads, drawn = {}, {}, []
        for name, device, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                                    ("cpu64", "cpu", torch.float64)):
            tr = livecell_mt_trainer(os.path.join(root, name), device=device,
                                     patch=ENGINE_CHECK_PATCH, steps_per_epoch=ENGINE_CHECK_FIT,
                                     num_workers=0, logger=False, dtype=dtype)
            tr.initialize()
            grads[name], train = [], tr.train_step

            def train_step(state, *batch, _train=train, _out=grads[name], **kw):
                res = _train(state, *batch, **kw)
                _out.append([p.grad.detach().cpu().double() for p in state.model.parameters()])
                return res

            tr.train_step = train_step
            fits[name] = tr
        init = {k: v.clone() for k, v in fits["cpu"].state.model.state_dict().items()}
        pseudo = steps._mc_pseudo

        def record(*a, **k):
            y, z = pseudo(*a, **k)
            drawn.append((y.cpu(), z.cpu()))
            return y, z

        def replayed(recorded, dtype):
            """``_mc_pseudo`` giving the card's pseudo-labels, after drawing
            its noise from the generator as the card's call did."""
            def mc_pseudo(model, x, n_samples, masking, eps=None, generator=None):
                if eps is None:
                    torch.randn((n_samples, x.shape[0], model.latent_dim), generator=generator)
                return tuple(v.to(dtype) for v in next(recorded))
            return mc_pseudo

        t0 = time.perf_counter()
        try:
            steps._mc_pseudo = record
            reset()
            fits["card"].fit(ENGINE_CHECK_FIT)
            torch.cuda.synchronize()
            counts = read_launches(wrappers)
            for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
                steps._mc_pseudo = replayed(iter(drawn), dtype)
                fits[name].fit(ENGINE_CHECK_FIT)
        finally:
            steps._mc_pseudo = pseudo
        cpu_s = time.perf_counter() - t0
        card, cpu = fits["card"], fits["cpu"]
        pairs = list(zip(card.history + card.val_history, cpu.history + cpu.val_history))
        same_keys = len(pairs) == ENGINE_CHECK_FIT + 1 and all(
            i == j and sorted(a) == sorted(b) for (i, a), (j, b) in pairs)
        worst = max((0.0 if a[k] == v else abs(a[k] - v) / max(1.0, abs(v)), f"{j} {k}")
                    for (_, a), (j, b) in pairs for k, v in b.items())
        want = expected(ENGINE_CHECK_FIT, MT_LAUNCHES, 1, MT_VAL_LAUNCHES, 0)
        share = float(drawn[0][1].mean())
        good = (same_keys and worst[0] <= MT_LOSS_TOL and counts == want and len(drawn) == 3
                and 0.0 < share < 1.0)
        log(f"engine MeanTeacherTrainer.fit({ENGINE_CHECK_FIT}) {ENGINE_CHECK_PATCH}^2 card vs "
            f"cpu: losses {[round(h['loss'], 6) for _, h in card.history]} vs "
            f"{[round(h['loss'], 6) for _, h in cpu.history]}, validation "
            f"{card.val_history[0][1]} vs {cpu.val_history[0][1]}; worst relative error "
            f"{worst[0]:.2e} ({worst[1]}; tol {MT_LOSS_TOL:.0e}); consensus share {share:.4f}; "
            f"launches {counts} (expected {want}); cpu (float32 and float64) {cpu_s:.1f} s "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        ok &= check_fit(f"engine MeanTeacherTrainer.fit({ENGINE_CHECK_FIT}) "
                        f"{ENGINE_CHECK_PATCH}^2", card, cpu, grads, init, MT_LR)
        del fits, card, cpu

        # 4. learning: development/learning_smoke.py's run on the port
        raws, labels = make_dataset_arrays(32, (96, 96), seed=7)
        train_ds = ImageCollectionDataset(raws[:24], labels[:24], patch_shape=(64, 64),
                                          n_samples=LEARN_BATCH * 16)
        val_ds = ImageCollectionDataset(raws[24:], labels[24:], patch_shape=(64, 64))
        model = ProbabilisticUnet(num_filters=LEARN_FILTERS, latent_dim=6, no_convs_fcomb=3,
                                  beta=1.0, rl_swap=True,
                                  generator=torch.Generator().manual_seed(SEED))
        learner = PUNetTrainer("learning-smoke", model,
                               Loader(train_ds, LEARN_BATCH, seed=0, num_workers=4),
                               Loader(val_ds, 4, seed=1), learning_rate=LEARN_LR,
                               lr_scheduler=ReduceLROnPlateau(), save_root=root, logger=False,
                               device=dev)
        reset()
        t0 = time.perf_counter()
        stats = learner.fit(LEARN_ITERATIONS)
        final = learner.validate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches(wrappers)
        n_val_steps = len(learner.val_history) * len(learner.val_loader)
        want = {"conv_block_fwd": 12 * LEARN_ITERATIONS + 20 * n_val_steps,
                "conv_block_fwd_dual": 3 * LEARN_ITERATIONS + 6 * n_val_steps,
                "mc_consensus": n_val_steps, "conv_block_bwd": 12 * LEARN_ITERATIONS,
                "conv_block_bwd_dual": 3 * LEARN_ITERATIONS}
        good = final["dice"] > LEARN_BAR and counts == want and finite(learner.history)
        log(f"engine learning check (development/learning_smoke.py): PUNetTrainer, PUNet "
            f"{LEARN_FILTERS}, 64^2 batch {LEARN_BATCH}, lr {LEARN_LR:g} with the plateau "
            f"controller, {LEARN_ITERATIONS} iterations f32: validation dice by epoch "
            f"{[round(m['dice'], 4) for _, m in learner.val_history]}, final {final['dice']:.4f} "
            f"(bar {LEARN_BAR}; pda records 0.82-0.84 on its TPU in bf16, a reference point); "
            f"learning rate {learner.state.learning_rate:g}; {stats['patches_per_sec']:.1f} "
            f"patches/s (Throughput), {wall:.1f} s with the validations; launches {counts} "
            f"(expected {want}) {'ok' if good else 'FAIL'}")
        ok &= good
        del learner
    return ok


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        from pda_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 1
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for cuDNN and matmul")
    log(card)

    results = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": None, "library_ms": None}
               for name, src, rep in (
                   ("conv_block_fwd", "pda_torch/kernels/csrc/conv_block_fwd.cu",
                    "pda/kernels/conv_block.py:391"),
                   ("conv_block_fwd_dual", "pda_torch/kernels/csrc/conv_block_fwd.cu",
                    "pda/kernels/conv_block.py:447"),
                   ("mc_consensus", "pda_torch/kernels/csrc/mc_consensus.cu",
                    "pda/kernels/mc_consensus.py:136"),
                   ("conv_block_bwd", "pda_torch/kernels/csrc/conv_block_bwd.cu",
                    "pda/kernels/conv_block_bwd.py:402"),
                   ("conv_block_bwd_dual", "pda_torch/kernels/csrc/conv_block_bwd.cu",
                    "pda/kernels/conv_block_bwd.py:502"))}
    binding = {}  # (kernel, "operations" or "bytes") -> ms of bound that term sets
    ok = True
    try:
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            torch.cuda.synchronize()
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()

        with torch.inference_mode():
            ok &= phase_kernels(dev, results, binding)
        lap("kernels")
        ok &= phase_serving(dev, results)
        lap("serving")
        good, mt_ms = phase_training(dev, results)
        ok &= good
        lap("training")
        ok &= phase_algorithms(dev, results, binding)
        lap("algorithms")
        ok &= phase_engine(dev, results, mt_ms)
        lap("engine")
    except Exception:  # any phase's error fails the run, with its traceback
        traceback.print_exc()
        ok = False
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    for entry in results.values():
        entry["bound_by"] = max(("operations", "bytes"),
                                key=lambda t: binding.get((entry["name"], t), 0.0))
    log("kernel ms/plain_ms/library_ms/bound_ms: forward kernels summed over one tiled "
        "MC-16 forward's calls, backward kernels over one MT step's (512^2, batch 2); "
        f"bound at {PEAK_FLOPS / 1e12:.0f} TFLOP/s (3xTF32) and {PEAK_BYTES / 1e12:.2f} TB/s; "
        "library_ms: cuDNN's three convolutions (F.conv2d) for the forward, its three "
        "convolution_backward calls with the ReLU masks between them for the backward "
        "(cudnn.benchmark on at 128->256), TF32 off; none for mc_consensus (no single PyTorch "
        "call computes it); mc_consensus: the tiled forward's call; launches: the main "
        "paths' runs, each counted from 0: both serving entries, the checked MT step, the "
        "other PUNet steps and the UNet2d path at the flagship's widths, and the flagship's "
        "MeanTeacherTrainer.fit (the checks' runs are logged on their own lines only)")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
