#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pda_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,lung]

Phases, each of which fails the run (exit code 1) on any error or miss
(``--phases`` runs some of them, and then prints no result lines):
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
                alignment), AdaMT and AdaMatch steps of the flagship and
                its supervised step (PUNetTrainer's), one at
                128^2 card vs CPU with launch counts each, then timed at
                512^2; the UNet2d path (depth 4, 64 features, sigmoid): the
                supervised and pseudo-label steps at 256^2 batch 4 card vs
                CPU, then timed, and tiled prediction of the frame, one tile
                card vs CPU, with no kernel launch
  7. engine   — pda's native host library (pda_torch/data/native.py) built
                on the card's host (g++'s version, the build's seconds), each
                entry point against the port's numpy path, and the port's
                OpenCV blur of a fixed probe against cv2's digest; the
                training engine (pda_torch.train.engine) on the card: the
                flagship's MeanTeacherTrainer.fit(8) at 512^2, batch 2, on
                seeded synthetic 520x704 frames through the port's Loader and
                DualImageCollectionDataset on the native weak views (epochs
                of 4 steps, a validation each, panels every 4 steps, the
                plateau controller, best and latest .pt checkpoints in a
                temporary directory), with exact launch counts, its patches/s
                beside the bare MT step's and its loader seconds; its
                TensorBoard event file (records' CRCs, a train/loss scalar a
                step, every panel image decoded); a
                fresh trainer reloading latest.pt bit for bit, then resuming
                to 10; the same fit at 128^2 (2 steps, 1 validation) on the
                card against the CPU (float32, and float64 for the gradients'
                reference); and 300 iterations of development/learning_smoke.py's
                PUNetTrainer run (PUNet 16/32/64/96, 64^2, batch 8, lr 1e-3),
                final validation dice above 0.5
  8. experiments — the LIVECell CLIs (pda_torch/experiments/) through their
                main(argv) on a synthetic LIVECell tree (two cell types, 4
                train, 1 validation, 1 test frame each, 520x704, written by
                the port's TIFF codec), at the flagship's width:
                livecell_prepare_data; livecell_punet --train --predict
                --evaluate; livecell_punet_target --get_pseudo_labels
                --train --predict --evaluate --consensus; livecell_mt
                --train --predict --evaluate --masking; livecell_fm,
                _adamt, _adamatch and _unet --train (each --iterations
                1); checkpoints under pda's names, predictions,
                pseudo trees, dice in [0, 1] and the dice runner's known
                answers on the test labels, the codec's round trip, the
                first prediction file bit-equal to tiled_punet_probs, the
                card's memory back after the last trainer; every distinct
                shape the CLIs gave a kernel, held against its plain version
                and float64 as in phase 3 where that phase had not; seconds
                by CLI and by trainer part, peak disk
  9. mitoem   — the MitoEM CLIs (pda_torch/experiments/mitoem_*) through
                their main(argv) on a synthetic MitoEM tree (MitoEM slices
                as PNG and TIFF, the VNC and Lucchi++ zips, UroCell NIfTI
                volumes; synthetic.write_mitoem_tree) at the flagship's
                width: the HDF5 codec's round trip; mitoem_prepare_data
                (every converted volume read back through the port's HDF5
                reader against its source slices); mitoem_punet --train
                --predict --evaluate --iterations 2; mitoem_mt --masking
                and mitoem_fm --consensus on lucchi, mitoem_adamt --type
                urocell and mitoem_adamatch --type vnc --consensus
                --masking, each --train --predict --evaluate
                --iterations 1; mitoem_unet the same; checkpoints, one
                probability map per target frame, 10 dice values in
                [0, 1], the dice runner's known answers on
                each target's ground truth, the first prediction bit-equal
                to tiled_punet_probs (MC-8), the card's memory back after
                the last trainer; every new (kernel, shape) held against its
                plain version and float64; seconds by CLI and trainer part
 10. lung     — one 128^2 Mean-Teacher step of the Lung PUNet (the
                flagship with the BCE reconstruction, consensus masking) card
                vs CPU (float32, float64 the gradients' reference), with its
                launch counts; then the Lung X-Ray CLIs
                (pda_torch/experiments/lung_*) through their main(argv) on a
                synthetic Lung tree (synthetic.write_lung_tree: JSRT 2048^2
                PNG and 8-bit BMP, NIH 1024^2, Montgomery 4892x4020 and
                4020x4892 16-bit PNG) at the flagship's width:
                lung_prepare_data (each prepared image and mask against its
                raw file resized by the port: 256^2, masks 0/255);
                lung_punet and lung_unet --train --predict --evaluate
                --iterations 2 on the four domains; lung_mt --masking and
                lung_adamt --consensus --train --predict --evaluate
                --iterations 1 on jsrt2 and montgomery (2 pairs each);
                checkpoint names, one probability map per test image and
                pair, 36 dice values in [0, 1], the dice runner's known
                answers on each domain's ground truth, the first
                prediction bit-equal to tiled_punet_probs (MC-16), the
                card's memory back after the last trainer; every new
                (kernel, shape) held against its plain version and float64,
                timed; seconds by CLI and trainer part, peak disk and memory
 11. times    — CUDA-event medians of every kernel, its plain version and
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

import argparse
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
from glob import glob

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
# K3's plain version materializes (S, B, H, W, C): batches beyond this many
# bytes of it (a 2048^2 frame's 36 tiles) run it in chunks of the batch
PLAIN_MC_BYTES = 4 * 2**30

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

# (kernel, shape) of every check against the plain version, filled as the
# checks run (shape_key); the experiments phase checks each other shape that
# its run gives a kernel
CHECKED = set()

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
    "supervised_punet": {"conv_block_fwd": 12, "conv_block_fwd_dual": 3, "mc_consensus": 0,
                         "conv_block_bwd": 12, "conv_block_bwd_dual": 3},
    "fixmatch": MT_LAUNCHES,
    "adamt": {"conv_block_fwd": 32, "conv_block_fwd_dual": 9, "mc_consensus": 1,
              "conv_block_bwd": 24, "conv_block_bwd_dual": 6},
}
ALG_LAUNCHES["pseudo_punet"] = ALG_LAUNCHES["supervised_punet"]
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

# The engine phase's host checks. pda's native library (pda_torch/data/native.py)
# built on the card's host, each entry point against the port's numpy path at
# tests/test_native.py's tolerances (rtol, atol): the library is built with
# -march=native, so its bits are the host's own
NATIVE_TOLS = {"standardize": (1e-5, 1e-6), "elastic_warp": (1e-4, 1e-4),
               "field_upsample": (1e-5, 1e-5), "random_contrast": (1e-4, 1e-5)}
NOISE_TOL = 0.01  # the noise's mean and standard deviation (0.5) within 0.01
# the native blur against the port's OpenCV blur (pda_torch/data/blur.py):
# max |native - port| <= 1e-5 * max |x| inside a border of 4 sigma + 1 pixels
# (2.1e-7 of it on the sandbox's CPU at sigma 0.3-4, 512^2)
NATIVE_BLUR_TOL = 1e-5
# The port's blur on the card's host (no cv2 there) against cv2's result on the
# x86-64 host that tests/test_torch_blur.py pins: the SHA-256 of the blurred
# default_rng(11).standard_normal((96, 80, 3)) probe and its first plane at
# each sigma; equal bit for bit
BLUR_PROBE_SIGMAS = (0.45, 1.3, 3.7)
BLUR_PROBE_SHA256 = "7b1229497c7fb3628001ee6fc54625c2aeeed46422c1d19a41a7a678cc7fb40a"

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


def shape_key(name, args, need_dx=True, masking=False):
    """(kernel, shape) of a launch from its arguments: the ConvBlock
    forwards (B, H, W, Cin[, Cb], C); the backwards the same, the
    single-input one with need_dx; K3 (B, H, W, C, S, n_mid, masking)."""
    if name == "mc_consensus":
        feat, z, mid_w = args[:3]
        return name, (*feat.shape, z.shape[0], mid_w.shape[0], bool(masking))
    inputs = args[1:-6] if name.startswith("conv_block_bwd") else args[:-6]
    b, h, w, _ = inputs[0].shape
    c = args[-1].shape[-1] if name.startswith("conv_block_bwd") else args[-1].shape[0]
    key = (b, h, w, *(t.shape[-1] for t in inputs), c)
    return name, key + ((bool(need_dx),) if name == "conv_block_bwd" else ())


@contextlib.contextmanager
def kernel_shapes(census):
    """Add the (kernel, shape) of every kernel launch inside the block to
    ``census`` (the launchers wrapped; the launch counts are untouched)."""
    from pda_torch.kernels import conv_block as kc
    from pda_torch.kernels import mc_consensus as km

    launch, launch_bwd, launch_mc = kc._launch, kc._launch_bwd, km._launch

    def fwd(xa, xb, *rest):
        name = "conv_block_fwd" if xb is None else "conv_block_fwd_dual"
        census.add(shape_key(name, (xa,) + (() if xb is None else (xb,)) + rest))
        return launch(xa, xb, *rest)

    def bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx):
        name = "conv_block_bwd" if xb is None else "conv_block_bwd_dual"
        inputs = (xa,) + (() if xb is None else (xb,))
        census.add(shape_key(name, (g, *inputs, h1, h2, h3, w1, w2, w3), need_dx))
        return launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx)

    def mc(feat, z, mid_w, mid_b, last_w, last_b, masking):
        census.add(shape_key("mc_consensus", (feat, z, mid_w), masking=masking))
        return launch_mc(feat, z, mid_w, mid_b, last_w, last_b, masking)

    kc._launch, kc._launch_bwd, km._launch = fwd, bwd, mc
    try:
        yield census
    finally:
        kc._launch, kc._launch_bwd, km._launch = launch, launch_bwd, launch_mc


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


def check_bwd(entry, label, kernel, plain, args, names, per_step, binding, need_dx,
              timed=True):
    """A backward kernel against its plain version: every output within
    BWD_REL_TOL of the plain one's largest and within BWD_REF64_TOL of the
    plain version's in float64, and two runs bit-equal; then, if ``timed``,
    times (the kernel's, the plain version's, cuDNN's:
    :func:`cudnn_block_bwd`) and the bound."""
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
    CHECKED.add(shape_key(entry["name"], args, need_dx))
    verdict = (f"kernel {label}: worst max_abs_err/max|plain| {worst[0]:.3e} ({worst[1]}; tol "
               f"{BWD_REL_TOL:.0e}), /max|ref64| {worst64[0]:.3e} ({worst64[1]}; tol "
               f"{BWD_REF64_TOL:.0e}), repeat bit-equal {same}")
    if not timed:
        log(f"{verdict} {'ok' if ok else 'FAIL'}")
        return ok
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
    log(f"{verdict}, ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} "
        f"library_ms {library_ms:.3f}"
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


def plain_mc(fn, args, *rest):
    """K3's plain version ``fn`` over the batch in chunks whose (S, b, H, W,
    C) float32 intermediate stays within PLAIN_MC_BYTES (one chunk up to
    that size, as the kernels phase's shapes are); the pixels are
    independent, so the chunks' outputs, joined, are the whole call's."""
    import torch

    feat, z, *weights = args
    s, b, (h, w, c) = z.shape[0], z.shape[1], feat.shape[1:]
    step = b if s * b * h * w * c * 4 <= PLAIN_MC_BYTES else max(
        1, PLAIN_MC_BYTES // (s * h * w * c * 4))
    parts = [fn(feat[i:i + step], z[:, i:i + step], *weights, *rest) for i in range(0, b, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def check_mc(entry, label, args, masking, binding, weight, timed=True):
    """K3 against its plain version: the MC mean within K3_MEAN_TOL of the
    plain version's and of the plain version's in float64, the consensus
    only where a logit lies within K3_WINDOW of a threshold, two launches
    bit-equal; then, if ``timed``, times, TFLOP/s and the bound."""
    import torch

    from pda_torch.kernels import mc_consensus as km
    from pda_torch.tools.workload import cuda_ms, mc_bytes, mc_flops

    mean, cons = km.mc_consensus(*args, masking=masking)
    again = km.mc_consensus(*args, masking=masking)
    ref_mean, ref_cons = plain_mc(km.mc_consensus_plain, args, masking)
    ref64 = plain_mc(km.mc_consensus_plain, [a.double() for a in args], masking)[0]
    near = plain_mc(lambda *a: ((km.mc_logits_plain(*a).abs() - math.log(9.0)).abs()
                                < K3_WINDOW).any(dim=0), args)
    torch.cuda.synchronize()
    err = float((mean - ref_mean).abs().max())
    err64 = float((mean.double() - ref64).abs().max())
    flips = int((cons != ref_cons).sum())
    stray = int(((cons != ref_cons) & ~near).sum())
    same = torch.equal(mean, again[0]) and torch.equal(cons, again[1])
    good = (bool(torch.isfinite(mean).all()) and err <= K3_MEAN_TOL and err64 <= K3_MEAN_TOL
            and stray == 0 and same)
    del mean, cons, again, ref_mean, ref_cons, ref64, near
    CHECKED.add(shape_key("mc_consensus", args, masking=masking))
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    b, h, w, c = args[0].shape
    s, n_mid = args[1].shape[0], args[2].shape[0]
    verdict = (f"kernel mc_consensus {label} S={s} n_mid={n_mid} feat {b}x{h}x{w}x{c} "
               f"masking={masking}: mean max_abs_err {err:.3e}, vs ref64 {err64:.3e} (tol "
               f"{K3_MEAN_TOL:.0e}), consensus differs at {flips} px, {stray} of them farther "
               f"than {K3_WINDOW:.0e} from a threshold, repeat bit-equal {same}")
    if not timed:
        log(f"{verdict} {'ok' if good else 'FAIL'}")
        return good
    ms = cuda_ms(lambda: km.mc_consensus(*args, masking=masking))
    plain_ms = cuda_ms(lambda: plain_mc(km.mc_consensus_plain, args, masking), iters=3)
    flops = mc_flops(b, h, w, c, s, n_mid)
    bound, term = add_bound(entry, binding, flops, mc_bytes(b, h, w, c, s, n_mid), weight)
    log(f"{verdict}; ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} "
        f"bound_ms {bound:.3f} ({term}) {'ok' if good else 'FAIL'}")
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


def check_conv(entry, label, kernel, plain, args, per_forward, binding, timed=True):
    """A forward kernel against its plain version: within K12_REL_TOL of
    the plain one's largest, within K12_REF64_TOL of the plain version's in
    float64, and two runs bit-equal; then, if ``timed``, times and the
    bound."""
    import torch

    from pda_torch.tools.workload import block_flops, block_weight_bytes, cuda_ms

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
    CHECKED.add(shape_key(entry["name"], args))
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    verdict = (f"kernel {label}: max_abs_err/max|plain| {err / scale:.3e} (tol "
               f"{K12_REL_TOL:.0e}), /max|ref64| {err64 / scale64:.3e} (tol {K12_REF64_TOL:.0e}), "
               f"repeat bit-equal {same}")
    if not timed:
        log(f"{verdict} {'ok' if ok else 'FAIL'}")
        return ok
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
    log(f"{verdict}, ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} "
        f"library_ms {library_ms:.3f} bound_ms {bound:.3f} ({term}) {'ok' if ok else 'FAIL'}")
    entry["ms"] += per_forward * ms
    entry["plain_ms"] += per_forward * plain_ms
    entry["library_ms"] = (entry["library_ms"] or 0.0) + per_forward * library_ms
    return ok


def phase_kernels(dev, results, binding):
    """Kernels against their plain versions; fills ``results`` per kernel."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools import workload as wl
    from pda_torch.tools.workload import conv_weights

    gen = torch.Generator().manual_seed(SEED)
    k1, k2, k3 = results["conv_block_fwd"], results["conv_block_fwd_dual"], results["mc_consensus"]

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
                         per_forward, binding)
    for shape, per_forward in ([(s, 1) for s in wl.K2_TILED] + [(s, 0) for s in wl.K2_PSEUDO]
                               + [(wl.LEARN_DUAL_BLOCK, 0)]):
        b, h, w, ca, cb, c = shape
        xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
        xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
        ok &= check_conv(k2, f"conv_block_fwd_dual {ca}+{cb}->{c} @{b}x{h}x{w}",
                         kc.conv_block_fwd_dual, kc.conv_block_fwd_dual_plain,
                         (xa, xb, *conv_weights(gen, ca + cb, c, dev)), per_forward, binding)

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

    # 2. the PUNet steps at the flagship's widths, 128^2 card vs CPU
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
        """supervised PUNet: (x, gt); pseudo PUNet: (x, y, z) with soft
        pseudo-labels and a consensus mask as read from disk; FixMatch:
        (x, x1, x2, gt); the joint steps: (xs, ys) of another frame + the
        target's (xt, xt1, xt2, yt)."""
        g = torch.Generator().manual_seed(SEED + patch)
        target = mt_batch(g, frame, patch, device)
        if algo == "supervised_punet":
            return target[0], target[3]
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
        "supervised_punet": (tt.make_supervised_punet_step(), False, ("eps_post",)),
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


@contextlib.contextmanager
def augmentation_path(native: bool):
    """PDA_NATIVE_AUGS set to the native ("1") or the numpy ("0") path while
    the block runs."""
    old = os.environ.get("PDA_NATIVE_AUGS")
    os.environ["PDA_NATIVE_AUGS"] = "1" if native else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PDA_NATIVE_AUGS"]
        else:
            os.environ["PDA_NATIVE_AUGS"] = old


def small_mt_fits(root, dev, wrappers, loader_seed: int = 0):
    """The flagship's MT fit at 128^2 (2 steps, 1 validation) on the card, on
    the CPU (float32) and on the CPU in float64, each step's gradients
    recorded; the CPU fits take the card teacher's pseudo-labels, so that a
    consensus pixel flipped within the MC kernel's threshold window is no
    difference. ``loader_seed`` moves the train loader's seed. Returns the
    fits, the gradients, the pseudo-labels, the initial student, the card
    fit's launches and the CPU fits' seconds."""
    import torch

    from pda_torch.tools.workload import livecell_mt_trainer
    from pda_torch.train import steps

    fits, grads, drawn = {}, {}, []
    for name, device, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        tr = livecell_mt_trainer(os.path.join(root, name), device=device,
                                 patch=ENGINE_CHECK_PATCH, steps_per_epoch=ENGINE_CHECK_FIT,
                                 num_workers=0, logger=False, dtype=dtype)
        tr.train_loader.seed += loader_seed
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
        reset_launches(wrappers)
        fits["card"].fit(ENGINE_CHECK_FIT)
        torch.cuda.synchronize()
        counts = read_launches(wrappers)
        for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
            steps._mc_pseudo = replayed(iter(drawn), dtype)
            fits[name].fit(ENGINE_CHECK_FIT)
    finally:
        steps._mc_pseudo = pseudo
    return fits, grads, drawn, init, counts, time.perf_counter() - t0


def check_native() -> bool:
    """pda's native library built on this host (g++'s version and the build's
    seconds logged), each entry point against the port's numpy path, and the
    port's blur of the probe against cv2's digest."""
    import hashlib

    import numpy as np
    from scipy.ndimage import map_coordinates

    from pda_torch.data import blur, native, transforms

    cxx = subprocess.run([native.CXX, "--version"], capture_output=True, text=True, timeout=60)
    version = (cxx.stdout.splitlines()[0] if cxx.returncode == 0 and cxx.stdout
               else f"failed ({cxx.returncode}): {cxx.stderr.strip()}")
    built = not native.library_path().exists()
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    log(f"engine native library: {native.CXX} {' '.join(native.CXX_FLAGS)}: {version}; "
        f"{path.name} {'built' if built else 'found built'} in {build_s:.2f} s")
    rng = np.random.default_rng(SEED)
    ok, lines = True, []

    def check(name, good, detail):
        nonlocal ok
        ok &= bool(good)
        lines.append(f"{name} {detail} {'ok' if good else 'FAIL'}")

    def close(name, got, want):
        rtol, atol = NATIVE_TOLS[name]
        err = float(np.abs(got - want).max())
        check(name, got.shape == want.shape and np.allclose(got, want, rtol=rtol, atol=atol),
              f"max abs err {err:.2e} (rtol {rtol:.0e}, atol {atol:.0e})")

    x = rng.normal(3.0, 2.0, (512, 512)).astype(np.float32)
    ref = x - x.mean()
    close("standardize", native.standardize(x), ref / (ref.std() + transforms.EPS))
    check("crop", np.array_equal(native.crop(x, 10, 20, 256, 300), x[10:266, 20:320]), "equal")
    # the warp and the field at tests/test_native.py's shapes and draws
    wrng = np.random.default_rng(0)
    a = wrng.normal(size=(64, 48)).astype(np.float32)
    dy, dx = ((wrng.normal(size=(64, 48)) * 9).astype(np.float32) for _ in range(2))
    yy, xx = np.meshgrid(np.arange(64), np.arange(48), indexing="ij")
    for order in (0, 1):
        close("elastic_warp", native.elastic_warp(a, dy, dx, order=order),
              map_coordinates(a, np.stack([yy + dy, xx + dx]), order=order, mode="reflect"))
    joint = transforms.JointAugmentations()
    with augmentation_path(native=False):  # the numpy field from the same draws
        field_np = joint._field(96, 80, np.random.default_rng(3))
    close("field_upsample", joint._field(96, 80, np.random.default_rng(3)), field_np)
    # at the loader's size, the joint augmentations' own field (reported)
    fy, fx = joint._field(512, 512, rng), joint._field(512, 512, rng)
    norm = max(np.abs(fy).max(), np.abs(fx).max())
    fy, fx = fy * (joint.alpha / norm), fx * (joint.alpha / norm)
    yy, xx = np.meshgrid(np.arange(512), np.arange(512), indexing="ij")
    frame_err = float(np.abs(native.elastic_warp(x, fy, fx, order=1) - map_coordinates(
        x, np.stack([yy + fy, xx + fx]), order=1, mode="reflect")).max())
    lines.append(f"(512^2 bilinear warp on the augmentations' field, alpha {joint.alpha}: max "
                 f"abs err {frame_err:.2e} against map_coordinates, reported)")
    close("random_contrast", native.random_contrast(x, 2.0), x.mean() + 2.0 * (x - x.mean()))
    zeros = np.zeros((512, 512), np.float32)
    noise = native.add_gaussian_noise(zeros, 0.5, seed=42)
    check("add_gaussian_noise", abs(noise.std() - 0.5) < NOISE_TOL and abs(noise.mean())
          < NOISE_TOL and np.array_equal(noise, native.add_gaussian_noise(zeros, 0.5, seed=42))
          and not np.array_equal(noise, native.add_gaussian_noise(zeros, 0.5, seed=43)),
          f"std {noise.std():.4f} mean {noise.mean():.2e} (tol {NOISE_TOL}), repeats per seed")
    weak = native.weak_augment(x, p=0.0, seed=1)
    views = [native.weak_augment(x, p=1.0, seed=s) for s in (1, 1, 2)]
    check("weak_augment", abs(weak.mean()) < 1e-3 and abs(weak.std() - 1.0) < 1e-2
          and np.array_equal(views[0], views[1]) and not np.array_equal(views[0], views[2])
          and all(np.isfinite(v).all() for v in views),
          f"p 0 standardizes (mean {weak.mean():.1e}, std {weak.std():.4f}), p 1 repeats per seed")
    worst = 0.0
    for sigma in (0.3, 0.7, 1.5, 2.9, 4.0):
        r = (int(np.rint(8 * sigma + 1)) | 1) // 2 + 1
        d = np.abs(native.gaussian_blur(x, sigma) - blur.gaussian_blur(x, sigma))[r:-r, r:-r]
        worst = max(worst, float(d.max()) / float(np.abs(x).max()))
    check("gaussian_blur", worst <= NATIVE_BLUR_TOL, f"against the port's OpenCV blur, inside "
          f"4 sigma + 1, sigma 0.3-4: {worst:.2e} of max |x| (tol {NATIVE_BLUR_TOL:.0e})")
    probe = np.random.default_rng(11).standard_normal((96, 80, 3)).astype(np.float32)
    digest = hashlib.sha256()
    for sigma in BLUR_PROBE_SIGMAS:
        digest.update(blur.gaussian_blur(probe, sigma).tobytes())
        digest.update(blur.gaussian_blur(np.ascontiguousarray(probe[..., 0]), sigma).tobytes())
    check("blur probe", digest.hexdigest() == BLUR_PROBE_SHA256,
          f"(the port's OpenCV blur, sigma {BLUR_PROBE_SIGMAS}) sha256 {digest.hexdigest()[:16]} "
          f"against cv2's on x86-64 {BLUR_PROBE_SHA256[:16]}")
    log("engine native library checks: " + "; ".join(lines))
    return ok


def check_events(trainer, n_steps, n_panels) -> bool:
    """The trainer's event file: every record's length and masked CRCs, one
    ``train/loss`` scalar a step, each panel image a PNG the port decodes to
    its height, width and 3 channels."""
    from pda_torch.data import png
    from pda_torch.train import events

    trainer.logger.close()
    files = glob(os.path.join(trainer.logger.log_dir, "events.out.tfevents.*"))
    t0 = time.perf_counter()
    parsed = [events.parse_event(r) for f in files for r in events.read_records(f)]
    values = [(e["step"], v) for e in parsed for v in e["values"]]
    losses = [step for step, v in values if v["tag"] == "train/loss"]
    images = [(step, v["tag"], v["image"]) for step, v in values if "image" in v]
    decoded = all(png.decode(im["png"]).shape == (im["height"], im["width"], 3)
                  for _, _, im in images)
    read_s = time.perf_counter() - t0
    tags = {tag.split("/", 1)[1] for _, tag, _ in images}
    nbytes = sum(os.path.getsize(f) for f in files)
    good = (len(files) == 1 and parsed[0]["file_version"] == "brain.Event:2"
            and losses == list(range(n_steps)) and decoded and tags == set(trainer.image_tags)
            and len(images) == n_panels * len(trainer.image_tags))
    log(f"engine event file {[os.path.basename(f) for f in files]}: {len(parsed)} records, "
        f"{nbytes / 2**20:.2f} MiB, lengths and masked CRC-32Cs checked; {len(losses)} "
        f"train/loss scalars (steps {losses}); {len(images)} images "
        f"({n_panels} panel passes x {len(trainer.image_tags)} tags), each decoded by the "
        f"port's PNG reader {decoded}; read in {read_s:.2f} s {'ok' if good else 'FAIL'}")
    return good


def phase_engine(dev, results, bare_ms):
    """The training engine on the card: the flagship's MT fit at 512^2, the
    reload and resume, the fit at 128^2 card vs CPU, the learning check."""
    import torch

    from pda_torch.data import ImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.tools.workload import livecell_mt_trainer
    from pda_torch.train import LATEST, PUNetTrainer, ReduceLROnPlateau

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

    ok = check_native()
    with tempfile.TemporaryDirectory() as root:
        # 1. the flagship's MT fit at 512^2, batch 2, through the port's data path
        # (the native weak views, PDA_NATIVE_AUGS's default)
        trainer = flagship(root)
        views = type(trainer.train_loader.dataset.augmentation1).__name__
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
                and files == ["best.pt", "latest.pt"] and views == "NativeWeakAugmentation")
        log(f"engine MeanTeacherTrainer.fit({ENGINE_FIT}) 512^2 batch {MT_BATCH} on {views} "
            f"views: losses "
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
            f"GiB; set-up {init_s:.1f} s; host seconds by part: {host} (loader "
            f"{trainer.timings['loader']:.3f} s waiting for {ENGINE_FIT} batches of native "
            f"views; panels: computing and writing the event file's images)")
        ok &= check_events(trainer, ENGINE_FIT, n_panels)

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
        # (float32) and the CPU in float64, on the numpy views this check was
        # set on (PRs 7-10): its weights' criterion fails on some loader draws
        # of either view (PERF.md §6, PR 11; pda_torch/tools/fit_check_seeds.py)
        with augmentation_path(native=False):
            fits, grads, drawn, init, counts, cpu_s = small_mt_fits(root, dev, wrappers)
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


# The experiments phase: the LIVECell CLIs (pda_torch/experiments/) on a
# synthetic LIVECell tree of two cell types, each with 4 train frames (the
# source PUNet's batch), 1 validation and 1 test frame of 520x704, at the
# flagship's width on the card; --iterations 1 for every CLI (2 for the source,
# pseudo-label and MT runs until the Lung phase needed the time).
EXP_CELL_TYPES = ("A172", "BT474")
EXP_COUNTS = (("train", 4), ("val", 1), ("test", 1))
EXP_MEMORY_SLACK = 64 * 2**20  # bytes the card may keep after the last trainer
DICE_TOL = 1e-9  # the dice runner against its known answers
TIFF_DTYPES = ("uint8", "uint16", "int32", "float32")


def glob_tifs(folder):
    return sorted(os.path.join(folder, n) for n in (os.listdir(folder) if os.path.isdir(folder)
                                                    else []) if n.endswith(".tif"))


def tree_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root)
               for f in files)


def tiff_roundtrip(folder):
    """The port's TIFF codec writes and reads each dtype bit for bit (every
    float32 bit pattern included)."""
    import numpy as np

    from pda_torch.data import tiff

    rng = np.random.default_rng(SEED)
    same = {}
    for name in TIFF_DTYPES:
        dt = np.dtype(name)
        bits = rng.integers(0, 2**(8 * dt.itemsize), size=(37, 53), dtype=np.uint64)
        a = bits.astype(f"u{dt.itemsize}").view(dt)
        path = os.path.join(folder, f"roundtrip_{name}.tif")
        tiff.imwrite(path, a)
        b = tiff.imread(path)
        same[name] = b.dtype == dt and b.shape == a.shape and a.tobytes() == b.tobytes()
    return same


def check_shapes(dev, results, binding, census, timed=False):
    """Each (kernel, shape) of ``census`` that no check has held against
    its plain version yet, on seeded inputs: the checks of the kernels
    phase; ``timed`` also logs each shape's kernel, plain and library times
    and bound (weight 0: the JSON line's sums stay as they are). Returns
    (ok, number checked)."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools import workload as wl

    # the inputs are drawn on the card: a 2048^2 frame's 36 tiles take
    # seconds of the CPU's generator a shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    todo = sorted(census - CHECKED)
    ok = True
    with torch.inference_mode(), torch.device(dev):
        for name, shape in todo:
            entry = results[name]
            if name == "conv_block_fwd":
                b, h, w, cin, c = shape
                x = torch.randn(b, h, w, cin, generator=gen).to(dev)
                ok &= check_conv(entry, f"{name} {cin}->{c} @{b}x{h}x{w}", kc.conv_block_fwd,
                                 kc.conv_block_fwd_plain, (x, *wl.conv_weights(gen, cin, c, dev)),
                                 0, binding, timed=timed)
            elif name == "conv_block_fwd_dual":
                b, h, w, ca, cb, c = shape
                args = (torch.randn(b, h, w, ca, generator=gen).to(dev),
                        torch.randn(b, h, w, cb, generator=gen).to(dev),
                        *wl.conv_weights(gen, ca + cb, c, dev))
                ok &= check_conv(entry, f"{name} {ca}+{cb}->{c} @{b}x{h}x{w}",
                                 kc.conv_block_fwd_dual, kc.conv_block_fwd_dual_plain, args, 0,
                                 binding, timed=timed)
            elif name == "conv_block_bwd":
                b, h, w, cin, c, need_dx = shape
                ok &= check_bwd(entry, f"{name} {cin}->{c} @{b}x{h}x{w} need_dx={need_dx}",
                                lambda *a, n=need_dx: kc.conv_block_bwd(*a, need_dx=n),
                                lambda *a, n=need_dx: kc.conv_block_bwd_plain(*a, need_dx=n),
                                saved_block(gen, b, h, w, cin, c, dev),
                                ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"), 0, binding,
                                need_dx, timed=timed)
            elif name == "conv_block_bwd_dual":
                b, h, w, ca, cb, c = shape
                g, x, *rest = saved_block(gen, b, h, w, ca + cb, c, dev)
                args = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *rest)
                del x
                ok &= check_bwd(entry, f"{name} {ca}+{cb}->{c} @{b}x{h}x{w}",
                                kc.conv_block_bwd_dual, kc.conv_block_bwd_dual_plain, args,
                                ("dxa", "dxb", "dw1", "db1", "dw2", "db2", "dw3", "db3"), 0,
                                binding, True, timed=timed)
                del g, rest, args
            else:
                b, h, w, c, s, n_mid, masking = shape
                ok &= check_mc(entry, "census", wl.mc_inputs(gen, b, h, w, c, s, n_mid, dev),
                               masking, binding, 0, timed=timed)
    torch.cuda.synchronize()
    return ok, len(todo)


def recording_fit(fit, trainers):
    """``engine.Trainer.fit`` that appends (class, run name, set-up seconds,
    fit seconds, host seconds by part) of each fit to ``trainers``."""
    def recorded(self, iterations, **kw):
        t0 = time.perf_counter()
        self.initialize()
        init_s = time.perf_counter() - t0
        out = fit(self, iterations, **kw)
        trainers.append((type(self).__name__, self.name, init_s, time.perf_counter() - t0,
                         dict(self.timings)))
        return out
    return recorded


def recording(run, values):
    """``run`` that appends each value it returns to ``values``."""
    def recorded(*a, **k):
        value = run(*a, **k)
        values.append(value)
        return value
    return recorded


def checkpoint_dirs(save, names):
    """(the runs' checkpoint folders under ``save``, whether each holds
    best.pt and latest.pt and nothing else)."""
    from pda_torch.train import checkpoint_dir

    dirs = [checkpoint_dir(n, save) for n in names]
    return dirs, all(os.path.isdir(d) and sorted(os.listdir(d)) == ["best.pt", "latest.pt"]
                     for d in dirs)


def drop(dirs):
    import shutil

    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def phase_experiments(dev, results, binding):
    """The LIVECell experiment CLIs on the card, through their main(argv),
    on a synthetic LIVECell tree written by the port's TIFF codec."""
    import gc

    import numpy as np
    import torch

    from pda_torch.data import tiff
    from pda_torch.data.synthetic import write_livecell_tree
    from pda_torch.experiments import (livecell_adamatch, livecell_adamt, livecell_da,
                                       livecell_fm, livecell_mt, livecell_prepare_data,
                                       livecell_punet, livecell_punet_target, livecell_unet)
    from pda_torch.infer import tiled_punet_probs
    from pda_torch.infer.tiling import grid_shape
    from pda_torch.train import engine, load_params

    wrappers = kernel_wrappers()
    ok = True
    trainers, dice, cli_s, census = [], [], {}, set()
    disk = {"peak": 0}
    fit = engine.Trainer.fit

    dice_modules = (livecell_punet, livecell_punet_target, livecell_da, livecell_unet)
    saved_dice = [m.run_dice_evaluation for m in dice_modules]

    def check(label, good, detail=""):
        nonlocal ok
        log(f"experiments {label}: {detail}{' ' if detail else ''}{'ok' if good else 'FAIL'}")
        ok &= bool(good)

    with tempfile.TemporaryDirectory() as root:
        data, pred, save = (os.path.join(root, d) for d in ("data", "pred", "save"))
        same = tiff_roundtrip(root)
        check("TIFF codec round trip", all(same.values()), f"bit-equal {same}")
        t0 = time.perf_counter()
        frames = write_livecell_tree(data, EXP_CELL_TYPES, counts=EXP_COUNTS, seed=SEED)
        log(f"experiments synthetic LIVECell tree: {EXP_CELL_TYPES}, frames "
            f"{ {k: len(v) for k, v in frames.items()} } of {FRAME[0]}x{FRAME[1]}, "
            f"{tree_bytes(data) / 2**20:.1f} MiB, {time.perf_counter() - t0:.1f} s")
        common = ["--data", data, "--pred_path", pred, "--save_root", save]

        def run(module, flags, iterations=None):
            paths = ["--data", data] if module is livecell_prepare_data else common
            argv = flags + paths + ([] if iterations is None else
                                    ["--iterations", str(iterations)])
            name = module.__name__.rsplit(".", 1)[-1]
            n_trainers = len(trainers)
            t0 = time.perf_counter()
            module.main(argv, cell_types=EXP_CELL_TYPES, device=dev.type)
            torch.cuda.synchronize()
            cli_s[f"{name} {' '.join(flags)}"] = time.perf_counter() - t0
            disk["peak"] = max(disk["peak"], tree_bytes(root))
            log(f"experiments {name} {' '.join(flags)}: {time.perf_counter() - t0:.1f} s, "
                f"{len(trainers) - n_trainers} trainers, disk {tree_bytes(root) / 2**30:.2f} GiB")

        def probability_maps(folder):
            """Each test frame's prediction: float32, 520x704, finite, in [0, 1]."""
            names = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
            good = len(names) == 1
            for n in names:
                p = tiff.imread(os.path.join(folder, n))
                good &= (p.dtype == np.float32 and p.shape == FRAME and bool(np.isfinite(p).all())
                         and float(p.min()) >= 0.0 and float(p.max()) <= 1.0)
            return good

        pairs = [(s, t) for t in EXP_CELL_TYPES for s in EXP_CELL_TYPES if s != t]
        others = [(livecell_fm, "fixmatch"), (livecell_adamt, "adamt"),
                  (livecell_adamatch, "adamatch"), (livecell_unet, None)]
        census_on = contextlib.ExitStack()
        try:
            census_on.enter_context(kernel_shapes(census))
            engine.Trainer.fit = recording_fit(fit, trainers)
            for m in dice_modules:
                m.run_dice_evaluation = recording(m.run_dice_evaluation, dice)
            gc.collect()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(wrappers)

            # 1. the label TIFFs
            run(livecell_prepare_data, [])
            labels = {s: [p for ct in EXP_CELL_TYPES for p in glob_tifs(
                os.path.join(data, "annotations", f"livecell_{s}_images", ct))]
                for s in ("train_val", "test")}
            good = (len(labels["train_val"]) == 2 * 4 and len(labels["test"]) == 2
                    and all(tiff.imread(p).dtype == np.uint16 and tiff.imread(p).max() > 1
                            for v in labels.values() for p in v))
            check("livecell_prepare_data", good, f"uint16 instance label TIFFs (train, test) "
                  f"{[len(v) for v in labels.values()]}")

            # 2. the source PUNets
            run(livecell_punet, ["--train", "--predict", "--evaluate"], 1)
            src_dirs, good = checkpoint_dirs(save, [f"punet-source-livecell-{c}" for c in EXP_CELL_TYPES])
            good &= all(probability_maps(os.path.join(pred, "punet_source", a, b))
                        for a in EXP_CELL_TYPES for b in EXP_CELL_TYPES)
            check("livecell_punet checkpoints and predictions", good, f"{len(dice)} dice values")
            first = EXP_CELL_TYPES[0]
            kept_state = load_params(src_dirs[0])  # on the host, for the check below
            first_frame = frames["test"][0]
            first_pred = glob_tifs(os.path.join(pred, "punet_source", first, first))[0]
            first_bytes = tiff.imread(first_pred).tobytes()

            # 3. pseudo-labels, the PUNets on them, their predictions
            run(livecell_punet_target,
                ["--get_pseudo_labels", "--train", "--predict", "--evaluate", "--consensus"], 1)
            good = True
            for src in EXP_CELL_TYPES:
                for ct in EXP_CELL_TYPES:
                    tree = os.path.join(pred, "punet_source_predictions", src)
                    lab, con = (glob_tifs(os.path.join(tree, k, "livecell_train_val_images", ct))
                                for k in ("annotations", "consensus"))
                    good &= len(lab) == 5 and [os.path.basename(p) for p in lab] == [
                        os.path.basename(p) for p in con]
                    good &= all(set(np.unique(tiff.imread(p)).tolist()) <= {0, 1} for p in con)
            tgt_dirs, good_dirs = checkpoint_dirs(save, [f"punet-livecell-source-{s}-target-{t}-consensus"
                                             for s, t in pairs])
            good &= good_dirs and all(probability_maps(
                os.path.join(pred, "punet_target", f"source-{s}-target-{t}")) for s, t in pairs)
            check("livecell_punet_target pseudo trees, checkpoints and predictions", good)
            drop(tgt_dirs)

            # 4. Mean Teacher, warm-started from the source runs
            run(livecell_mt, ["--train", "--predict", "--evaluate", "--masking"], 1)
            mt_dirs, good = checkpoint_dirs(save, [livecell_da.da_name("mean-teacher", "livecell", s, t,
                                                           False, True) for s, t in pairs])
            good &= all(probability_maps(os.path.join(pred, "mean_teacher",
                                                      f"source-{s}-target-{t}"))
                        for s, t in pairs)
            check("livecell_mt checkpoints and predictions", good)
            drop(mt_dirs)

            # 5. the other methods' training
            for module, method in others:
                run(module, ["--train"], 1)
                names = ([livecell_da.da_name(method, "livecell", s, t, False, False)
                          for s, t in pairs] if method else
                         [f"unet-source-livecell-{c}" for c in EXP_CELL_TYPES])
                dirs, good = checkpoint_dirs(save, names)
                check(f"{module.__name__.rsplit('.', 1)[-1]} --train checkpoints", good)
                drop(dirs)
                if module is livecell_fm:
                    drop(src_dirs)  # no later CLI warm-starts from the source runs
            drop(src_dirs)
            counts = counted_launches(wrappers, results)  # the main path's run
            check("kernel launches", all(n > 0 for n in counts.values()), f"{counts}")
            check("dice", dice and all(math.isfinite(d) and 0.0 <= d <= 1.0 for d in dice),
                  f"{[round(d, 4) for d in dice]}")
            peak_mem = torch.cuda.max_memory_allocated()
        finally:
            census_on.close()
            engine.Trainer.fit = fit
            for m, f in zip(dice_modules, saved_dice):
                m.run_dice_evaluation = f

        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check("card memory after the last trainer",
              mem1 - mem0 <= EXP_MEMORY_SLACK,
              f"{mem0 / 2**20:.1f} MiB before the first, {mem1 / 2**20:.1f} MiB after the last "
              f"(slack {EXP_MEMORY_SLACK / 2**20:.0f} MiB); peak {peak_mem / 2**30:.2f} GiB")
        log(f"experiments peak disk {disk['peak'] / 2**30:.2f} GiB")

        # the dice runner's known answers on the test labels: each label's
        # own binarisation scores 1; the binarisation with its left half
        # cleared, written as 0.25 / 0.75 so that the runner's threshold
        # (> 0.5) decides, scores 2|A and B| / (|A| + |B|) by numpy
        gt_glob = os.path.join(data, "annotations", "livecell_test_images", "{}", "*")
        for case in ("own", "half"):
            want, got = [], []
            for ct in EXP_CELL_TYPES:
                folder = os.path.join(root, "known", case, ct)
                os.makedirs(folder)
                scores = []
                for p in glob_tifs(os.path.dirname(gt_glob.format(ct))):
                    a = tiff.imread(p) > 0
                    b = a.copy()
                    if case == "half":
                        b[:, : b.shape[1] // 2] = False
                    tiff.imwrite(os.path.join(folder, os.path.basename(p)),
                                 (0.25 + 0.5 * b).astype(np.float32))
                    scores.append(2.0 * np.sum(a & b) / (np.sum(a) + np.sum(b)))
                want.append(float(np.mean(scores)))
                got.append(livecell_punet.run_dice_evaluation(gt_glob.format(ct), folder,
                                                              verbose=False))
            good = (0.0 < min(want) and (case == "half" or max(want) == 1.0)
                    and all(abs(g - w) <= DICE_TOL for g, w in zip(got, want)))
            check(f"dice runner's known answer ({case})", good,
                  f"{[round(g, 6) for g in got]} against {[round(w, 6) for w in want]}")

        # every shape the CLIs gave a kernel, held against its plain version
        t0 = time.perf_counter()
        good, n = check_shapes(dev, results, binding, census)
        check("the CLIs' kernel shapes against the plain versions", good,
              f"{len(census)} (kernel, shape) pairs, {len(census) - n} checked in the kernels "
              f"phase, {n} here in {time.perf_counter() - t0:.1f} s")

        # the CLI's first prediction against tiled_punet_probs of the same
        # weights (the copy kept after the source runs), frame and noise (the
        # first draw of punet_prediction's seed-0 generator): the reading,
        # standardising and writing add nothing
        model = livecell_punet.livecell_punet(device=dev)
        model.load_state_dict(kept_state)
        img = torch.from_numpy(tiff.imread(first_frame).astype(np.float32)[..., None]).to(dev)
        gy, gx = grid_shape(img.shape[:2], BLOCK)
        eps = torch.randn((MC, gy * gx, model.latent_dim),
                          generator=torch.Generator().manual_seed(0))
        ref = tiled_punet_probs(model, img, eps.to(dev), MC, BLOCK, HALO)[..., 0].cpu().numpy()
        check("the first livecell_punet --predict file against tiled_punet_probs",
              ref.tobytes() == first_bytes, f"{os.path.basename(first_pred)}: bit-equal "
              f"{ref.tobytes() == first_bytes}")
        del model, img
        log("experiments seconds by CLI: " + "; ".join(f"{k} {v:.1f}" for k, v in cli_s.items()))
        for cls, name, init_s, fit_s, timings in trainers:
            host = ", ".join(f"{k} {v:.3f}" for k, v in sorted(timings.items(),
                                                               key=lambda kv: -kv[1]))
            log(f"experiments trainer {cls} {name}: set-up (loader start, model, warm start) "
                f"{init_s:.2f} s, fit {fit_s:.2f} s; host seconds by part: {host}")
    return ok


# The mitoem phase: the MitoEM suite's CLIs (pda_torch/experiments/mitoem_*) on
# a synthetic MitoEM tree (synthetic.write_mitoem_tree) at the flagship's
# width on the card: MitoEM slices cut from 4096^2 to 1024^2, 4 train and 2
# validation slices a sample; VNC at its 1024^2, 3 slices a stack (of 20);
# Lucchi++ at its 768x1024, 4 Test and 2 Train slices (of 165); UroCell 3
# volumes of 3 slices at 512^2 (its 256^2 is below the CLIs' 512^2 patch);
# --iterations 2 for the source PUNet, 1 for the rest; each domain-adaptation
# method trains one target: AdaMT and AdaMatch by --type (urocell, vnc), Mean
# Teacher and FixMatch Lucchi++ (their loop's target list narrowed).
MITO_SHAPES = {"mitoem": (1024, 1024), "vnc": (1024, 1024), "lucchi": (768, 1024),
               "urocell": (512, 512)}
MITO_MC = 8  # punet_prediction's prior samples in the MitoEM CLIs (pda's default)
H5_DTYPES = ("uint8", "uint16", "int32", "float32", "float64")


def h5_roundtrip(folder):
    """The port's HDF5 writer and reader, each dtype bit for bit (every
    float bit pattern included), whole and one slice at a time, through a
    nested group."""
    import numpy as np

    from pda_torch.data import h5

    rng = np.random.default_rng(SEED)
    same = {}
    path = os.path.join(folder, "roundtrip.h5")
    arrays = {}
    with h5.Writer(path) as f:
        for name in H5_DTYPES:
            dt = np.dtype(name)
            bits = rng.integers(0, 2**(8 * dt.itemsize) - 1, size=(70, 37, 53), dtype=np.uint64)
            arrays[name] = a = bits.astype(f"u{dt.itemsize}").view(dt)
            f.create_dataset(f"whole/{name}", data=a)
            d = f.create_dataset(f"slices/{name}", shape=a.shape, dtype=a.dtype,
                                 chunks=(1, 37, 53))
            for i in range(len(a)):
                d[i] = a[i]
    with h5.File(path) as f:
        for name, a in arrays.items():
            same[name] = all(f[f"{k}/{name}"][...].tobytes() == a.tobytes()
                             and f[f"{k}/{name}"][3:60:7, 5:].tobytes() == a[3:60:7, 5:].tobytes()
                             for k in ("whole", "slices"))
    return same


def converted_volumes(data):
    """Every converted volume against the slices it came from, read back
    through the port's HDF5 reader: {file: bit-equal}."""
    import numpy as np

    from pda_torch.data import h5
    from pda_torch.data.builders.em import _connected_components
    from pda_torch.data.builders.prepare import _files, _find_slice_dirs, read_nifti
    from pda_torch.data.tiff import read_image

    def stack(files):
        return np.stack([read_image(f) for f in files])

    want = {}
    for sample in ("human", "rat"):
        im, tr, va = _find_slice_dirs(os.path.join(data, "mitoem", f"{sample}_raw"))
        raw, seg_tr, seg_va = stack(_files(im)), stack(_files(tr)), stack(_files(va))
        want[f"mitoem/{sample}_train.h5"] = {"raw": raw[:len(seg_tr)], "labels": seg_tr}
        want[f"mitoem/{sample}_val.h5"] = {"raw": raw[len(seg_tr):], "labels": seg_va}
    vnc = os.path.join(data, "vnc", "groundtruth-drosophila-vnc-master")
    want["vnc/vnc_train.h5"] = {
        "raw": stack(sorted(glob(os.path.join(vnc, "stack1", "raw", "*.tif")))),
        "labels/mitochondria": _connected_components(
            stack(sorted(glob(os.path.join(vnc, "stack1", "mitochondria", "*.png")))))}
    want["vnc/vnc_test.h5"] = {"raw": stack(sorted(glob(os.path.join(vnc, "stack2", "raw",
                                                                    "*.tif"))))}
    luc = os.path.join(data, "lucchi", "Lucchi++")
    for part, name in (("Test", "lucchi_train.h5"), ("Train", "lucchi_test.h5")):
        masks = stack(sorted(glob(os.path.join(luc, f"{part}_Out", "*.png"))))
        masks = masks[..., 0] if masks.ndim == 4 else masks
        want[f"lucchi/{name}"] = {"raw": stack(sorted(glob(os.path.join(luc, f"{part}_In",
                                                                        "*.png")))),
                                  "labels": (masks == 255).astype(np.uint8)}
    uro = os.path.join(data, "urocell", "UroCell-master")
    for f in sorted(glob(os.path.join(uro, "data", "*.nii.gz"))):
        name = os.path.basename(f).replace(".nii.gz", "")
        want[f"urocell/{name}.h5"] = {"raw": read_nifti(f), "labels/mito": read_nifti(
            os.path.join(uro, "mito", os.path.basename(f)))}
    same = {}
    for rel, datasets in want.items():
        with h5.File(os.path.join(data, rel)) as f:
            same[rel] = all(f[k][...].dtype == v.dtype and np.array_equal(f[k][...], v)
                            for k, v in datasets.items())
    return same


def phase_mitoem(dev, results, binding):
    """The MitoEM experiment CLIs on the card, through their main(argv), on
    a synthetic MitoEM tree read and converted by the port's codecs."""
    import gc
    import urllib.request

    import numpy as np
    import torch

    from pda_torch.data import tiff
    from pda_torch.data.synthetic import write_mitoem_tree
    from pda_torch.experiments import (mitoem_adamatch, mitoem_adamt, mitoem_common, mitoem_da,
                                       mitoem_fm, mitoem_mt, mitoem_prepare_data, mitoem_punet,
                                       mitoem_unet)
    from pda_torch.infer import tiled_punet_probs
    from pda_torch.infer.tiling import grid_shape
    from pda_torch.train import engine, load_params

    wrappers = kernel_wrappers()
    ok = True
    trainers, dice, cli_s, census = [], [], {}, set()
    disk = {"peak": 0}
    fit = engine.Trainer.fit

    def refuse(url, path):
        raise OSError(f"chip_smoke fetches nothing ({url})")

    dice_modules = (mitoem_punet, mitoem_da, mitoem_unet)
    saved_dice = [m.run_dice_evaluation for m in dice_modules]
    saved_fetch = urllib.request.urlretrieve

    def check(label, good, detail=""):
        nonlocal ok
        log(f"mitoem {label}: {detail}{' ' if detail else ''}{'ok' if good else 'FAIL'}")
        ok &= bool(good)

    types = mitoem_common.EM_TYPES
    with tempfile.TemporaryDirectory() as root:
        data, pred, save = (os.path.join(root, d) for d in ("data", "pred", "save"))
        same = h5_roundtrip(root)
        check("HDF5 codec round trip", all(same.values()), f"bit-equal {same}")
        t0 = time.perf_counter()
        folders = write_mitoem_tree(data, SEED, shapes=MITO_SHAPES)
        log(f"mitoem synthetic MitoEM tree: {sorted(folders)}, shapes {MITO_SHAPES}, "
            f"{tree_bytes(data) / 2**20:.1f} MiB, {time.perf_counter() - t0:.1f} s")
        common = ["--data", data, "--pred_path", pred, "--save_root", save]

        def run(module, flags, iterations=None):
            paths = ["--data", data] if module is mitoem_prepare_data else common
            argv = flags + paths + ([] if iterations is None else
                                    ["--iterations", str(iterations)])
            name = module.__name__.rsplit(".", 1)[-1]
            n_trainers = len(trainers)
            t0 = time.perf_counter()
            module.main(argv, device=dev.type)
            torch.cuda.synchronize()
            label = " ".join([name, *flags])
            cli_s[label] = time.perf_counter() - t0
            disk["peak"] = max(disk["peak"], tree_bytes(root))
            log(f"mitoem {label}: {time.perf_counter() - t0:.1f} s, "
                f"{len(trainers) - n_trainers} trainers, disk {tree_bytes(root) / 2**30:.2f} GiB")

        def probability_maps(folder, em_type):
            """One float32 map in [0, 1] per target frame, of the frame's shape."""
            frames = sorted(glob(mitoem_common.em_input_glob(data, em_type)))
            names = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
            good = len(names) == len(frames) > 0
            shape = tuple(MITO_SHAPES[em_type])
            for n in names:
                p = tiff.imread(os.path.join(folder, n))
                good &= (p.dtype == np.float32 and p.shape == shape and bool(np.isfinite(p).all())
                         and float(p.min()) >= 0.0 and float(p.max()) <= 1.0)
            return good

        def da_checks(method, flags, targets):
            masking, consensus = "--masking" in flags, "--consensus" in flags
            suffix = mitoem_da._suffix(argparse.Namespace(consensus=consensus, masking=masking))
            dirs, good = checkpoint_dirs(save, [mitoem_da.da_name(method, "mito", "mitoem", t, consensus,
                                                      masking) for t in targets])
            good &= all(probability_maps(os.path.join(
                pred, mitoem_da.PRED_SUBDIR[method], f"source-mitoem-target-{t}{suffix}"), t)
                for t in targets)
            return dirs, good

        census_on = contextlib.ExitStack()
        try:
            census_on.enter_context(kernel_shapes(census))
            engine.Trainer.fit = recording_fit(fit, trainers)
            urllib.request.urlretrieve = refuse
            for m in dice_modules:
                m.run_dice_evaluation = recording(m.run_dice_evaluation, dice)
            gc.collect()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(wrappers)

            # 1. the volumes and the UroCell evaluation slices
            run(mitoem_prepare_data, [])
            same = converted_volumes(data)
            check("mitoem_prepare_data volumes against their slices", all(same.values()),
                  f"{len(same)} files bit-equal {all(same.values())}")
            uro_slices = glob(os.path.join(data, "urocell", "preprocessed", "*.tif"))
            check("mitoem_prepare_data UroCell slices", len(uro_slices) == 2 * 3,
                  f"{len(uro_slices)} image/gt TIFFs")

            # 2. the source PUNet, its predictions on the three targets
            run(mitoem_punet, ["--train", "--predict", "--evaluate"], 2)
            src_dirs, good = checkpoint_dirs(save, ["punet-source-mitoem"])
            good &= all(probability_maps(os.path.join(pred, "punet_predictions", t), t)
                        for t in types)
            check("mitoem_punet checkpoint and predictions", good, f"{len(dice)} dice values")
            kept_state = load_params(src_dirs[0])  # on the host, for the check below
            first_frame = sorted(glob(mitoem_common.em_input_glob(data, "vnc")))[0]
            first_pred = os.path.join(pred, "punet_predictions", "vnc",
                                      os.path.splitext(os.path.basename(first_frame))[0] + ".tif")
            first_bytes = tiff.imread(first_pred).tobytes()

            # 3. the domain-adaptation methods, one target each: AdaMT and
            # AdaMatch by --type; Mean Teacher and FixMatch (whose command
            # lines, as pda's, have no --type) on Lucchi++ alone, their loop's
            # target list narrowed for the call. Each target is trained by
            # at least one method.
            for module, method, flags, targets in (
                    (mitoem_mt, "mean-teacher", ["--masking"], ["lucchi"]),
                    (mitoem_fm, "fixmatch", ["--consensus"], ["lucchi"]),
                    (mitoem_adamt, "adamt", ["--type", "urocell"], ["urocell"]),
                    (mitoem_adamatch, "adamatch", ["--type", "vnc", "--consensus", "--masking"],
                     ["vnc"])):
                em_types = mitoem_da.EM_TYPES
                mitoem_da.EM_TYPES = targets
                try:
                    run(module, ["--train", "--predict", "--evaluate"] + flags, 1)
                finally:
                    mitoem_da.EM_TYPES = em_types
                dirs, good = da_checks(method, flags, targets)
                check(f"{module.__name__.rsplit('.', 1)[-1]} checkpoints and predictions", good)
                drop(dirs)
            drop(src_dirs)

            # 4. the UNet source model
            run(mitoem_unet, ["--train", "--predict", "--evaluate"], 1)
            dirs, good = checkpoint_dirs(save, ["unet-source-mitoem"])
            good &= all(probability_maps(os.path.join(pred, "unet_predictions", t), t)
                        for t in types)
            check("mitoem_unet checkpoint and predictions", good)
            drop(dirs)
            counts = counted_launches(wrappers, results)  # the main path's run
            check("kernel launches", all(n > 0 for n in counts.values()), f"{counts}")
            check("dice", len(dice) == 3 + 4 + 3 and all(math.isfinite(d) and 0.0 <= d <= 1.0
                                                         for d in dice),
                  f"{[round(d, 4) for d in dice]}")
            peak_mem = torch.cuda.max_memory_allocated()
        finally:
            census_on.close()
            engine.Trainer.fit = fit
            urllib.request.urlretrieve = saved_fetch
            for m, f in zip(dice_modules, saved_dice):
                m.run_dice_evaluation = f

        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check("card memory after the last trainer",
              mem1 - mem0 <= EXP_MEMORY_SLACK,
              f"{mem0 / 2**20:.1f} MiB before the first, {mem1 / 2**20:.1f} MiB after the last "
              f"(slack {EXP_MEMORY_SLACK / 2**20:.0f} MiB); peak {peak_mem / 2**30:.2f} GiB")
        log(f"mitoem peak disk {disk['peak'] / 2**30:.2f} GiB")

        # the dice runner's known answers on each target's ground truth (its
        # name remap included): the ground truth against itself scores 1;
        # with its left half cleared (written 0.25 / 0.75, the runner's
        # threshold deciding), numpy's 2|A and B| / (|A| + |B|)
        for case in ("own", "half"):
            want, got = [], []
            for t in types:
                folder = os.path.join(root, "known", case, t)
                os.makedirs(folder)
                scores = []
                for p in sorted(glob(mitoem_common.em_gt_glob(data, t))):
                    a = tiff.read_image(p) > 0
                    a = a[:, :, 0] if a.ndim > 2 else a
                    b = a.copy()
                    if case == "half":
                        b[:, : b.shape[1] // 2] = False
                    tiff.imwrite(os.path.join(folder, em_prediction_name(p, t)),
                                 (0.25 + 0.5 * b).astype(np.float32))
                    scores.append(2.0 * np.sum(a & b) / (np.sum(a) + np.sum(b)))
                want.append(float(np.mean(scores)))
                got.append(mitoem_punet.run_dice_evaluation(
                    mitoem_common.em_gt_glob(data, t), folder, subtype=t, verbose=False))
            good = (0.0 < min(want) and (case == "half" or max(want) == 1.0)
                    and all(abs(g - w) <= DICE_TOL for g, w in zip(got, want)))
            check(f"dice runner's known answer ({case}, {'/'.join(types)})", good,
                  f"{[round(g, 6) for g in got]} against {[round(w, 6) for w in want]}")

        # every shape the CLIs gave a kernel, held against its plain version
        t0 = time.perf_counter()
        good, n = check_shapes(dev, results, binding, census, timed=True)
        check("the CLIs' kernel shapes against the plain versions", good,
              f"{len(census)} (kernel, shape) pairs, {len(census) - n} checked before, "
              f"{n} here in {time.perf_counter() - t0:.1f} s")

        # the first mitoem_punet --predict file (a VNC frame) against
        # tiled_punet_probs of the same weights, frame and noise (the first
        # draw of punet_prediction's seed-0 generator, MC-8)
        model = mitoem_punet.mitoem_punet(device=dev)
        model.load_state_dict(kept_state)
        img = torch.from_numpy(tiff.read_image(first_frame).astype(np.float32)[..., None]).to(dev)
        gy, gx = grid_shape(img.shape[:2], BLOCK)
        eps = torch.randn((MITO_MC, gy * gx, model.latent_dim),
                          generator=torch.Generator().manual_seed(0))
        ref = tiled_punet_probs(model, img, eps.to(dev), MITO_MC, BLOCK, HALO)[..., 0]
        ref = ref.cpu().numpy()
        check("the first mitoem_punet --predict file against tiled_punet_probs",
              ref.tobytes() == first_bytes, f"{os.path.basename(first_pred)}: bit-equal "
              f"{ref.tobytes() == first_bytes}")
        del model, img
        log("mitoem seconds by CLI: " + "; ".join(f"{k} {v:.1f}" for k, v in cli_s.items()))
        for cls, name, init_s, fit_s, timings in trainers:
            host = ", ".join(f"{k} {v:.3f}" for k, v in sorted(timings.items(),
                                                               key=lambda kv: -kv[1]))
            log(f"mitoem trainer {cls} {name}: set-up (loader start, model, warm start) "
                f"{init_s:.2f} s, fit {fit_s:.2f} s; host seconds by part: {host}")
    return ok


def em_prediction_name(gt_path, subtype):
    """The prediction file the dice runner reads for a ground-truth file
    (its lucchi and urocell name remaps)."""
    name = os.path.basename(gt_path)
    if subtype == "lucchi":
        return f"mask{int(name[:-4]):04}.tif"
    if subtype == "urocell":
        name = name.replace("_gt", "_image")
    return f"{name[:-4]}.tif"


# The lung phase: the Lung X-Ray suite's CLIs (pda_torch/experiments/lung_*) on
# a synthetic Lung tree (synthetic.write_lung_tree) at the sources' frame
# sizes (JSRT 2048^2 PNG and BMP, NIH 1024^2, Montgomery 4892x4020 and
# 4020x4892 16-bit) and the flagship's width with the BCE reconstruction
# (lung_punet: rl_swap=False), 256^2 patches, batch 2. Cut: 3 train + 1 test
# frames a JSRT or NIH domain and 4 Montgomery frames (of 124-247 a domain);
# --iterations 2 for the source models, 1 for Mean Teacher and AdaMT, which
# train 2 of the 12 pairs (LUNG_DA_DOMAINS: a BMP target and a prepared one).
LUNG_COUNTS = {"jsrt1": (3, 1), "jsrt2": (3, 1), "nih": (3, 1), "montgomery": 4}
LUNG_DA_DOMAINS = ("jsrt2", "montgomery")
LUNG_SIZE = (256, 256)  # the prepared Montgomery and NIH frames (rows, cols)
LUNG_MC = 16  # punet_prediction's prior samples in the Lung CLIs


def lung_step(dev):
    """One 128^2 Mean-Teacher step of the Lung PUNet (BCE reconstruction,
    consensus masking) on the card against the same step on the CPU, in
    float32 and (the gradients' reference) float64; the CPU steps take the
    card teacher's pseudo-labels. Returns ok."""
    import numpy as np
    import torch

    from pda_torch.data.synthetic import make_lung_frame
    from pda_torch.experiments.common import lung_punet
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step, steps

    wrappers = kernel_wrappers()
    gen = torch.Generator().manual_seed(SEED + 7)
    model = lung_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED),
                       device="cpu")
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(LAST_SCALE)
    init = model.state_dict()
    raw, _ = make_lung_frame(LUNG_SIZE, np.random.default_rng(SEED))
    batch = mt_batch(gen, torch.from_numpy(raw)[..., None], MT_CHECK_PATCH, "cpu")
    noise = {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen),
             "eps_post": torch.randn(MT_BATCH, 6, generator=gen)}
    step = make_mean_teacher_step(momentum=MT_MOMENTUM, do_consensus_masking=True)

    def state_on(device, dtype=torch.float32):
        student = copy.deepcopy(model).to(device=device, dtype=dtype)
        return create_train_state(student, adam(student.parameters(), MT_LR), with_teacher=True)

    card, cpu, cpu64 = state_on(dev), state_on("cpu"), state_on("cpu", torch.float64)
    pseudo, drawn = steps._mc_pseudo, []

    def capture(*a, **k):
        drawn.append(pseudo(*a, **k))
        return drawn[-1]

    steps._mc_pseudo = capture
    reset_launches(wrappers)
    try:
        _, aux = step(card, *(a.to(dev) for a in batch),
                      **{k: v.to(dev) for k, v in noise.items()})
        torch.cuda.synchronize()
    finally:
        steps._mc_pseudo = pseudo
    counts = read_launches(wrappers)  # a check's run: logged only
    ok = counts == MT_LAUNCHES and float(drawn[0][1].mean()) not in (0.0, 1.0)
    log(f"lung MT step (BCE, masking) {MT_CHECK_PATCH}^2: launches {counts} (expected "
        f"{MT_LAUNCHES}), consensus share {float(drawn[0][1].mean()):.4f} "
        f"{'ok' if ok else 'FAIL'}")
    t0 = time.perf_counter()
    for state, dtype in ((cpu, torch.float32), (cpu64, torch.float64)):
        y, z = (t.to("cpu", dtype) for t in drawn[0])
        steps._mc_pseudo = lambda *a, **k: (y, z)
        try:
            _, out = step(state, *(a.to(dtype) for a in batch),
                          **{k: v.to(dtype) for k, v in noise.items()})
        finally:
            steps._mc_pseudo = pseudo
        if dtype == torch.float32:
            aux_cpu = out
    ok &= check_step(f"lung MT step (BCE, masking) {MT_CHECK_PATCH}^2", card, cpu, aux, aux_cpu,
                     init, MT_LR, ref64=cpu64)
    log(f"lung MT step card vs cpu: recon (BCE sum) {float(aux['recon_loss']):.3f}, cpu (float32 "
        f"and float64) {time.perf_counter() - t0:.1f} s")
    return ok


def prepared_frames(data):
    """Every prepared Montgomery and NIH image and mask against its raw file
    resized by the port (INTER_AREA, INTER_NEAREST), LUNG_SIZE, masks in
    {0, 255}: (number of files, all equal)."""
    import numpy as np

    from pda_torch.data import png
    from pda_torch.data.resize import INTER_AREA, INTER_NEAREST, resize

    dsize = LUNG_SIZE[::-1]
    n, good = 0, True
    raw = {}
    mont = os.path.join(data, "montgomery")
    for p in sorted(glob(os.path.join(mont, "CXR_png", "*.png"))):
        name = os.path.basename(p)
        masks = [png.imread(os.path.join(mont, "ManualMask", side, name)) > 0
                 for side in ("leftMask", "rightMask")]
        raw["montgomery_processed", name] = (png.imread(p),
                                             (masks[0] | masks[1]).astype(np.uint8) * 255)
    for split in ("train", "test"):
        for p in sorted(glob(os.path.join(data, "nih", "images", split, "*.png"))):
            lab = png.imread(os.path.join(data, "nih", "labels", split, os.path.basename(p)))
            raw["nih_processed", os.path.basename(p)] = (png.imread(p), lab)
    for (folder, name), (img, mask) in raw.items():
        img = img[..., 0] if img.ndim == 3 else img
        found = glob(os.path.join(data, folder, "images", "*", name))
        if len(found) != 1:
            return n, False
        got_img = png.imread(found[0])
        got_mask = png.imread(found[0].replace(os.sep + "images" + os.sep,
                                               os.sep + "labels" + os.sep))
        want_img = resize(img, dsize, INTER_AREA).astype(np.uint8)
        want_mask = resize(mask, dsize, INTER_NEAREST)
        want_mask = ((want_mask > 0) * 255).astype(np.uint8)
        good &= (got_img.shape == got_mask.shape == LUNG_SIZE
                 and np.array_equal(got_img, want_img) and np.array_equal(got_mask, want_mask)
                 and set(np.unique(got_mask).tolist()) <= {0, 255})
        n += 2
    return n, good


def phase_lung(dev, results, binding):
    """The Lung X-Ray experiment CLIs on the card, through their
    main(argv), on a synthetic Lung tree read by the port's PNG and BMP
    codecs and prepared by its numpy resize."""
    import gc
    import importlib

    import numpy as np
    import torch

    from pda_torch.data import tiff
    from pda_torch.data.builders.lung import LUNG_DOMAINS
    from pda_torch.data.synthetic import write_lung_tree
    from pda_torch.experiments import lung as lung_da
    from pda_torch.infer import tiled_punet_probs
    from pda_torch.infer.tiling import grid_shape
    from pda_torch.train import engine, load_params

    (lung_prepare_data, lung_punet, lung_unet, lung_mt, lung_adamt) = (
        importlib.import_module(f"pda_torch.experiments.{n}")
        for n in ("lung_prepare_data", "lung_punet", "lung_unet", "lung_mt", "lung_adamt"))
    wrappers = kernel_wrappers()
    ok = lung_step(dev)
    trainers, dice, cli_s, census = [], [], {}, set()
    disk = {"peak": 0}
    fit = engine.Trainer.fit

    dice_modules = (lung_punet, lung_unet, lung_da)
    saved_dice = [m.run_lung_dice_evaluation for m in dice_modules]

    def check(label, good, detail=""):
        nonlocal ok
        log(f"lung {label}: {detail}{' ' if detail else ''}{'ok' if good else 'FAIL'}")
        ok &= bool(good)

    with tempfile.TemporaryDirectory() as root:
        data, pred, save = (os.path.join(root, d) for d in ("data", "pred", "save"))
        t0 = time.perf_counter()
        write_lung_tree(data, SEED, counts=LUNG_COUNTS)
        log(f"lung synthetic Lung tree: {LUNG_COUNTS} frames, "
            f"{tree_bytes(data) / 2**20:.1f} MiB, {time.perf_counter() - t0:.1f} s")
        common = ["--data", data, "--pred_path", pred, "--save_root", save]

        def run(module, flags, iterations=None, domains=LUNG_DOMAINS):
            name = module.__name__.rsplit(".", 1)[-1]
            n_trainers = len(trainers)
            t0 = time.perf_counter()
            if module is lung_prepare_data:
                module.main(["--data", data])
            else:
                module.main(flags + common + ["--iterations", str(iterations)],
                            domains=domains, device=dev.type)
            torch.cuda.synchronize()
            label = " ".join([name, *flags])
            cli_s[label] = time.perf_counter() - t0
            disk["peak"] = max(disk["peak"], tree_bytes(root))
            log(f"lung {label}: {time.perf_counter() - t0:.1f} s, "
                f"{len(trainers) - n_trainers} trainers, disk {tree_bytes(root) / 2**30:.2f} GiB")

        def probability_maps(folder, domain):
            """One float32 map in [0, 1] per test image of the target, of its shape."""
            images = sorted(glob(lung_da.test_image_glob(data, domain)))
            names = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
            good = [os.path.splitext(os.path.basename(p))[0] + ".tif" for p in images] == names
            for p, n in zip(images, names):
                m = tiff.imread(os.path.join(folder, n))
                good &= (m.dtype == np.float32 and m.shape == tiff.read_image(p).shape[:2]
                         and bool(np.isfinite(m).all()) and float(m.min()) >= 0.0
                         and float(m.max()) <= 1.0)
            return good and len(names) > 0

        def pair_maps(subdir, pairs):
            return all(probability_maps(os.path.join(pred, subdir, f"source-{s}-target-{t}"), t)
                       for s, t in pairs)

        every = [(s, t) for s in LUNG_DOMAINS for t in LUNG_DOMAINS]
        da_pairs = [(s, t) for t in LUNG_DA_DOMAINS for s in LUNG_DA_DOMAINS if s != t]
        census_on = contextlib.ExitStack()
        try:
            census_on.enter_context(kernel_shapes(census))
            engine.Trainer.fit = recording_fit(fit, trainers)
            for m in dice_modules:
                m.run_lung_dice_evaluation = recording(m.run_lung_dice_evaluation, dice)
            gc.collect()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(wrappers)

            # 1. Montgomery and NIH prepared to 256^2
            run(lung_prepare_data, [])
            n, good = prepared_frames(data)
            check("lung_prepare_data against the raw files resized by the port", good,
                  f"{n} images and masks")

            # 2. the source PUNets and UNets, predicted on every domain
            run(lung_punet, ["--train", "--predict", "--evaluate"], 2)
            src_dirs, good = checkpoint_dirs(save, [f"punet-source-lung-{d}" for d in LUNG_DOMAINS])
            good &= pair_maps("punet_source", every)
            check("lung_punet checkpoints and predictions", good, f"{len(dice)} dice values")
            kept_state = load_params(src_dirs[0])  # on the host, for the check below
            first_frame = sorted(glob(lung_da.test_image_glob(data, LUNG_DOMAINS[0])))[0]
            first_pred = os.path.join(pred, "punet_source",
                                      f"source-{LUNG_DOMAINS[0]}-target-{LUNG_DOMAINS[0]}",
                                      os.path.splitext(os.path.basename(first_frame))[0] + ".tif")
            first_bytes = tiff.imread(first_pred).tobytes()
            run(lung_unet, ["--train", "--predict", "--evaluate"], 2)
            dirs, good = checkpoint_dirs(save, [f"unet-source-lung-{d}" for d in LUNG_DOMAINS])
            good &= pair_maps("unet_source", every)
            check("lung_unet checkpoints and predictions", good)
            drop(dirs)

            # 3. Mean Teacher (warm-started from the source PUNets) and AdaMT
            for module, method, flags in ((lung_mt, "mean-teacher", ["--masking"]),
                                          (lung_adamt, "adamt", ["--consensus"])):
                run(module, ["--train", "--predict", "--evaluate"] + flags, 1,
                    domains=LUNG_DA_DOMAINS)
                dirs, good = checkpoint_dirs(save, [lung_da.da_name(method, "lung", s, t,
                                                        "--consensus" in flags,
                                                        "--masking" in flags)
                                        for s, t in da_pairs])
                good &= pair_maps(lung_da.PRED_SUBDIR[method], da_pairs)
                check(f"{module.__name__.rsplit('.', 1)[-1]} checkpoints and predictions", good)
                drop(dirs)
            drop(src_dirs)
            counts = counted_launches(wrappers, results)  # the main path's run
            check("kernel launches", all(n > 0 for n in counts.values()), f"{counts}")
            n_dice = 2 * len(every) + 2 * len(da_pairs)
            check("dice", len(dice) == n_dice and all(math.isfinite(d) and 0.0 <= d <= 1.0
                                                      for d in dice),
                  f"{len(dice)} of {n_dice}: {[round(d, 4) for d in dice]}")
            peak_mem = torch.cuda.max_memory_allocated()
        finally:
            census_on.close()
            engine.Trainer.fit = fit
            for m, f in zip(dice_modules, saved_dice):
                m.run_lung_dice_evaluation = f

        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check("card memory after the last trainer",
              mem1 - mem0 <= EXP_MEMORY_SLACK,
              f"{mem0 / 2**20:.1f} MiB before the first, {mem1 / 2**20:.1f} MiB after the last "
              f"(slack {EXP_MEMORY_SLACK / 2**20:.0f} MiB); peak {peak_mem / 2**30:.2f} GiB")
        log(f"lung peak disk {disk['peak'] / 2**30:.2f} GiB")

        # the lung dice runner's known answers on each domain's ground truth
        # (jsrt2's name remap included): the ground truth against itself
        # scores 1; with its left half cleared, numpy's 2|A and B| / (|A| + |B|)
        for case in ("own", "half"):
            want, got = [], []
            for d in LUNG_DOMAINS:
                folder = os.path.join(root, "known", case, d) + os.sep
                os.makedirs(folder)
                gt_dir = lung_da.test_gt_dir(data, d)
                images = sorted(glob(lung_da.test_image_glob(data, d)))
                scores = []
                for p, img in zip(sorted(glob(gt_dir + "*")), images):
                    a = tiff.read_image(p) != 0
                    b = a.copy()
                    if case == "half":
                        b[:, : b.shape[1] // 2] = False
                    stem = os.path.splitext(os.path.basename(img))[0]
                    tiff.imwrite(os.path.join(folder, stem + ".tif"), b.astype(np.float32))
                    scores.append(2.0 * np.sum(a & b) / (np.sum(a) + np.sum(b)))
                want.append(float(np.mean(scores)))
                got.append(lung_punet.run_lung_dice_evaluation(gt_dir, folder, d, verbose=False))
            good = (0.0 < min(want) and (case == "half" or max(want) == 1.0)
                    and all(abs(g - w) <= DICE_TOL for g, w in zip(got, want)))
            check(f"dice runner's known answer ({case}, {'/'.join(LUNG_DOMAINS)})", good,
                  f"{[round(g, 6) for g in got]} against {[round(w, 6) for w in want]}")

        # every new shape the CLIs gave a kernel, held against its plain version
        t0 = time.perf_counter()
        good, n = check_shapes(dev, results, binding, census, timed=True)
        check("the CLIs' kernel shapes against the plain versions", good,
              f"{len(census)} (kernel, shape) pairs, {len(census) - n} checked before, "
              f"{n} here in {time.perf_counter() - t0:.1f} s")

        # the first lung_punet --predict file (a JSRT segmentation01 frame)
        # against tiled_punet_probs of the same weights, frame and noise
        model = lung_punet.lung_punet(device=dev)
        model.load_state_dict(kept_state)
        img = torch.from_numpy(tiff.read_image(first_frame).astype(np.float32)[..., None]).to(dev)
        gy, gx = grid_shape(img.shape[:2], BLOCK)
        eps = torch.randn((LUNG_MC, gy * gx, model.latent_dim),
                          generator=torch.Generator().manual_seed(0))
        ref = tiled_punet_probs(model, img, eps.to(dev), LUNG_MC, BLOCK, HALO)[..., 0]
        ref = ref.cpu().numpy()
        check("the first lung_punet --predict file against tiled_punet_probs",
              ref.tobytes() == first_bytes, f"{os.path.basename(first_pred)} "
              f"({'x'.join(map(str, ref.shape))}): bit-equal {ref.tobytes() == first_bytes}")
        del model, img
        log("lung seconds by CLI: " + "; ".join(f"{k} {v:.1f}" for k, v in cli_s.items()))
        for cls, name, init_s, fit_s, timings in trainers:
            host = ", ".join(f"{k} {v:.3f}" for k, v in sorted(timings.items(),
                                                               key=lambda kv: -kv[1]))
            log(f"lung trainer {cls} {name}: set-up (loader start, model, warm start) "
                f"{init_s:.2f} s, fit {fit_s:.2f} s; host seconds by part: {host}")
    return ok


PHASES = ("kernels", "serving", "training", "algorithms", "engine", "experiments", "mitoem",
          "lung")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of pda_torch on one NVIDIA GPU.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all; the engine phase "
                             "needs the training phase); a partial run prints no result lines")
    phases = parser.parse_args(argv).phases.split(",")
    if set(phases) - set(PHASES) or ("engine" in phases and "training" not in phases):
        print(f"chip_smoke: --phases takes some of {','.join(PHASES)} (engine with training)",
              file=sys.stderr)
        return 2
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

        mt_ms = None
        for name in (n for n in PHASES if n in phases):
            if name == "kernels":
                with torch.inference_mode():
                    ok &= phase_kernels(dev, results, binding)
            elif name == "serving":
                ok &= phase_serving(dev, results)
            elif name == "training":
                good, mt_ms = phase_training(dev, results)
                ok &= good
            elif name == "engine":
                ok &= phase_engine(dev, results, mt_ms)
            else:
                ok &= {"algorithms": phase_algorithms, "experiments": phase_experiments,
                       "mitoem": phase_mitoem, "lung": phase_lung}[name](dev, results, binding)
            lap(name)
    except Exception:  # any phase's error fails the run, with its traceback
        traceback.print_exc()
        ok = False
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    if len(phases) < len(PHASES):
        log(f"chip_smoke: phases {','.join(phases)} passed (a partial run: no result lines)")
        return 0
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
        "other PUNet steps and the UNet2d path at the flagship's widths, the flagship's "
        "MeanTeacherTrainer.fit, the experiments phase's LIVECell CLIs, the mitoem phase's "
        "MitoEM CLIs and the lung phase's Lung X-Ray CLIs (the checks' runs are logged on "
        "their own lines only)")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
