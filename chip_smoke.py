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
                teacher and pseudo shapes); the backward in each of its
                modes on the MT step: the pooled cotangent ("with": skip +
                pool, "only": pool; its first pass bit-equal to the plain
                one) and the recompute of h1, h2 (single and dual entry,
                bit-equal to the saved-h kernel)
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
                with its kernel launch counts; then steps at 512^2, batch 2;
                then the step under PDA_PALLAS_CONV_MODE=mixed (forwards on
                cuDNN, every backward recomputing h1, h2): one 64^2 step card
                vs CPU (float32, float64 the gradients' reference) with its
                launch counts, and timed at 512^2 beside the default's ms
                and peak memory; then pda's development/ab_step_check.py
                at 256^2 in float32 (pda_torch/tools/ab_step_check.py):
                the step's compute on the kernels against every plain
                version on the card, each measure within 4x the plain
                leg's own float32-vs-float64 spread and pda's bound
  6. bf16     — pda's bf16 configuration (bench.py's default MT step:
                ProbabilisticUnet(dtype=bfloat16), float32 parameters) on the
                bf16 instances of the four kernel bodies: each at the tiled
                forward's and the MT step's shapes against its plain version
                in float64 sums, layer by layer from the kernel's own input
                (bf16 outputs within one bf16 ulp, or 1e-5 of the largest
                where the value's ulp is finer, and bit-equal on 99%; dW, db
                within 1e-4; K3's mean within 2^-8), timed beside cuDNN's bf16
                convolutions and the bound at 989 TFLOP/s; one 128^2 MT step
                card vs the plain bf16 step on the CPU; the 512^2 step with
                the kernels against the step with every plain version on the
                card (pda's development/ab_step_check.py: loss, gradients'
                cosine, worst leaf; the consensus differs at most at 4x the
                pixels the plain leg's float32 and float64 sums differ at;
                these check the wiring, the layer checks the roundings); 7 timed
                bf16 MT steps at 512^2 beside the float32 step; tiled MC-16
                serving in bf16;
                Trainer(mixed_precision=True).fit ending in a float32
                checkpoint that reloads bit for bit
  7. parallel — pda's data mesh (pda_torch.parallel) at a world of 1 in
                this process (NCCL, a HashStore): the flagship MT step at
                512^2, batch 2, in float32 and in bf16, and the tiled MC-16
                frame, each from one state, batch and noise without a mesh
                and with one; the sharded run bit-equal (loss, every
                parameter, gradient and teacher tensor; the frame), every
                kernel launched on the sharded path (bf16: on the wgmma
                bodies); both legs timed, and the gradient bucket's
                all-reduce alone. Then the (data, space) mesh: a (1, 1)
                mesh (NCCL, its data and space groups of one rank) whose MT
                step is bit-equal to no mesh in float32 and bf16; and the
                row-sharded block's local function on the card
                (models.blocks.conv_block_rows): 2 and 4 row shards of
                2 x 512^2, each shard's rows extended by slicing the whole
                tensor, on every route of the flagship step (single, pooled
                "with" and "only", dual, mixed) forward and backward, and
                the mc_consensus tail on row shards, float32 and bf16,
                held against the whole-image launch (ROW_SHARD_BOUNDS)
  8. algorithms — fault 3.1: K3 at C = 16 and 20 (zero-padded to 24)
                against its plain version, a PUNet at num_filters (16, 32,
                48, 64) and a 2-class one through mc_pseudo and the
                validation predictor, card vs CPU (no K3 launch for 2
                classes); the pseudo-PUNet, FixMatch (distribution
                alignment), AdaMT and AdaMatch steps of the flagship and
                its supervised step (PUNetTrainer's), one at
                64^2 card vs CPU with launch counts each, then timed at
                512^2; the UNet2d path (depth 4, 64 features, sigmoid): the
                supervised and pseudo-label steps at 256^2 batch 4 card vs
                CPU, then timed, the supervised step also in bf16 beside
                float32 (its first forward's rounding layers held against
                float64 sums), and tiled prediction of the frame, one tile
                card vs CPU, with no kernel launch; a bf16 UNet2d (pda's
                UNet2d(dtype=bfloat16), depth 3, 16 features, 64^2): each
                rounding layer from the card's own bf16 input against
                float64 sums, then one supervised step card vs CPU, float32
                parameters and gradients
  9. engine   — pda's native host library (pda_torch/data/native.py) built
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
                native views, card against the CPU (float32, and float64 for
                the gradients' reference; the final weights within the
                interval Adam maps each step's gradient error to); and 300
                iterations of development/learning_smoke.py's
                PUNetTrainer run (pda_torch/tools/learning_smoke.py in
                float32: PUNet 16/32/64/96, 64^2, batch 8, lr 1e-3), final
                validation dice above 0.5
 10. experiments — the LIVECell CLIs (pda_torch/experiments/) through their
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
 11. mitoem   — the MitoEM CLIs (pda_torch/experiments/mitoem_*) through
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
                --iterations 1 (the AdaMT and AdaMatch validations on 40
                patches, their loaders' 400 cut); mitoem_unet the same;
                checkpoints, one
                probability map per target frame, 10 dice values in
                [0, 1], the dice runner's known answers on
                each target's ground truth, the first prediction bit-equal
                to tiled_punet_probs (MC-8), the card's memory back after
                the last trainer; every new (kernel, shape) held against its
                plain version and float64; seconds by CLI and trainer part
 12. lung     — one 64^2 Mean-Teacher step of the Lung PUNet (the
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
 13. times    — CUDA-event medians of every kernel, its plain version and
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
import collections
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
MT_WARMUP, MT_TIMED = 2, 4
LAST_SCALE = 8.0  # Fcomb last layer x8: the random teacher's consensus share lies inside (0, 1)
MT_LOSS_TOL = 1e-4  # card vs CPU: |loss - ref| <= 1e-4 * max(1, |ref|), same for recon, kl
MT_GRAD_TOL = 1e-3  # card vs CPU: per parameter, max |g - ref| <= 1e-3 * max |ref|
MT_PARAM_TOL = 1e-6  # card vs CPU: updated student (where Adam's sign is defined) and teacher
# the algorithms phase: a gradient leaf beyond MT_GRAD_TOL passes if 1 - its
# cosine to the float64 step's is within GRAD_COS_TOL, or within
# pda_torch.tools.ab.SPREAD_FACTOR times the CPU float32 step's (check_step)
GRAD_COS_TOL = 1e-5
# kernel launches of one MT step
MT_LAUNCHES = {"conv_block_fwd": 20, "conv_block_fwd_dual": 6, "mc_consensus": 1,
               "conv_block_bwd": 12, "conv_block_bwd_dual": 3}
# The backward's modes, each a JSON entry of its own whose launches are its
# wrapper's launches in that mode (kc.BWD_MODES: launches_<mode>[_bf16], also
# counted in the wrapper's own count): the pooled cotangent (pda's gpf) and
# the recompute of h1, h2 (PDA_PALLAS_CONV_MODE=mixed)
MODE_ENTRIES = {"conv_block_bwd_pool": ("conv_block_bwd", "pool"),
                "conv_block_bwd_recompute": ("conv_block_bwd", "recompute"),
                "conv_block_bwd_dual_recompute": ("conv_block_bwd_dual", "recompute")}
# ... of one MT step: the 9 blocks whose output feeds a 2x2 pool (levels 0-2
# of the backbone, the prior and the posterior) read the pooled cotangent
MT_MODE_LAUNCHES = {"conv_block_bwd_pool": 9, "conv_block_bwd_recompute": 0,
                    "conv_block_bwd_dual_recompute": 0}
# one MT step under PDA_PALLAS_CONV_MODE=mixed: every forward on cuDNN (pda's
# XLA forward), every backward recomputing h1 and h2
MIXED_MT_LAUNCHES = {"conv_block_fwd": 0, "conv_block_fwd_dual": 0, "mc_consensus": 1,
                     "conv_block_bwd": 12, "conv_block_bwd_dual": 3}
MIXED_MT_MODE_LAUNCHES = {"conv_block_bwd_pool": 9, "conv_block_bwd_recompute": 12,
                          "conv_block_bwd_dual_recompute": 3}
MIXED_CHECK_PATCH = 64
# The bf16 forwards' route, each a JSON entry of its own (bf16 only) whose
# launches are its wrapper's launches_wgmma_bf16: the launches whose
# tensor-core layers all ran on the wgmma body (csrc/conv3x3_wgmma.cuh); on
# the flagship's shapes that is every bf16 forward launch
FWD_MODE_ENTRIES = {"conv_block_fwd_wgmma": ("conv_block_fwd", "wgmma"),
                    "conv_block_fwd_dual_wgmma": ("conv_block_fwd_dual", "wgmma")}
# ... and its twin for the bf16 backwards: the launches whose every dgrad
# (the wgmma body, conv3x3_wgmma.cuh) and every wgrad but an entry layer's
# (wgrad_wgmma.cuh) ran on the wgmma bodies; on the flagship's shapes that is
# every bf16 backward launch
BWD_ROUTE_ENTRIES = {"conv_block_bwd_wgmma": ("conv_block_bwd", "wgmma"),
                     "conv_block_bwd_dual_wgmma": ("conv_block_bwd_dual", "wgmma")}
ROUTE_ENTRIES = {**FWD_MODE_ENTRIES, **BWD_ROUTE_ENTRIES}
# peak device memory (GiB) of each time_steps label's run
STEP_PEAKS = {}

# The algorithms phase. The MC tail at widths the kernel once refused (C = 20
# is zero-padded to 24), a small PUNet through it, a 2-class PUNet (the plain
# tail, no MC kernel launch); the other PUNet steps at the flagship's widths,
# checked at 64^2 (at 128^2 their CPU sides take 7-15 s each) and timed at
# 512^2; the UNet2d path the UNet experiments
# build (depth 4, 64 features, sigmoid; 256^2 batch 4, Adam 1e-4).
FAULT_WIDTHS = (16, 20)
SMALL_FILTERS = (16, 32, 48, 64)
ALG_CHECK_PATCH, ALG_STEP_CHECK_PATCH, ALG_TIME_PATCH = 128, 64, 512
ALG_WARMUP, ALG_TIMED = 1, 2
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
# the bf16 UNet2d check (pda's UNet2d(dtype=bfloat16)): a UNet2d of
# depth 3 from 16 features, its biases drawn (normal, scale 0.1) so that the
# bias add's rounding shows, on a batch of 2 at 64^2: every rounding layer
# (norm, conv, upsample, head) from the card's own bf16 input to it against
# the same layer in float64 sums on the card (cuDNN off; unet_bf16_layers) by
# the bf16 layer rule (bf16_agree; a conv's tolerance one ulp of its output
# plus one of its sum before the bias add, the two roundings), then one
# supervised step card vs CPU,
# the CPU's convs summing in float64 (as bf16_card_vs_cpu's reference): the
# loss and the gradients' cosine within pda's bf16 A/B bounds
# (pda_torch.tools.ab.PDA_BOUNDS), float32 parameters and gradients. The
# timed bf16 UNet2d step (256^2, batch 4) has its first forward's layers held
# the same way, at the shapes and cuDNN algorithms it is timed at.
UNET_BF16_BATCH, UNET_BF16_PATCH, UNET_BF16_DEPTH, UNET_BF16_FEATURES = 2, 64, 3, 16
UNET_BF16_LAYERS = ("_norm_bf16", "_conv_bf16", "_upsample_bf16")
# pda's development/ab_step_check.py at 256^2 in float32 (the training phase)
AB_PATCH = 256
NO_LAUNCHES = dict.fromkeys(MT_LAUNCHES, 0)

# The engine phase: the flagship's MT trainer at 512^2 (epochs of 4 steps, a
# validation batch each, panels every 4 steps), resumed to 10; the same fit at
# 128^2 card vs CPU; development/learning_smoke.py's run (pda records 0.82-0.84
# final dice on its TPU in bf16: a reference point, not a target)
ENGINE_EPOCH, ENGINE_FIT, ENGINE_RESUME = 4, 8, 10
ENGINE_CHECK_PATCH, ENGINE_CHECK_FIT = 128, 2
ENGINE_MIN_SHARE = 0.9  # the engine's loop against the bare step's patches/s (reported)
LEARN_ITERATIONS, LEARN_BATCH = 300, 8  # pda_torch/tools/learning_smoke.py's run
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


def add_bound(entry, binding, flops, nbytes, weight=1, peak_flops=PEAK_FLOPS):
    """Add ``weight`` calls' bound (ms) to ``entry`` (the FLOPs at
    ``peak_flops``, the bf16 instances' at 989 TFLOP/s); ``binding`` sums
    each term's share, which names ``bound_by``. Returns one call's (ms,
    term)."""
    from pda_torch.tools.workload import bound_ms

    ms, term = bound_ms(flops, nbytes, peak_flops, PEAK_BYTES)
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

    def bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, workspaces=None, **kw):
        name = "conv_block_bwd" if xb is None else "conv_block_bwd_dual"
        inputs = (xa,) + (() if xb is None else (xb,))
        census.add(shape_key(name, (g, *inputs, h1, h2, h3, w1, w2, w3), need_dx))
        return launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, workspaces, **kw)

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


def saved_block(gen, b, h, w, cin, c, dev, dtype=None):
    """(g, x, h1, h2, h3, w1, w2, w3): a ConvBlock's saved tensors from the
    plain forward on seeded inputs, and a seeded cotangent; x, g and the
    saved tensors in ``dtype`` (float32 unless given: bf16), the weights
    float32."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.workload import conv_weights

    dtype = dtype or torch.float32
    x = torch.randn(b, h, w, cin, generator=gen).to(dev).to(dtype)
    w1, b1, w2, b2, w3, b3 = conv_weights(gen, cin, c, dev)
    hs = [t.permute(0, 2, 3, 1).contiguous() for t in kc._plain_layers(x, w1, b1, w2, b2, w3, b3)]
    g = torch.randn(b, h, w, c, generator=gen).to(dev).to(dtype)
    return (g, x, *hs, w1, w2, w3)


def check_bwd(entry, label, kernel, plain, args, names, per_step, binding, need_dx,
              timed=True, gp=None, also=None):
    """A backward kernel against its plain version: every output within
    BWD_REL_TOL of the plain one's largest and within BWD_REF64_TOL of the
    plain version's in float64, and two runs bit-equal; then, if ``timed``,
    times (the kernel's, the plain version's, cuDNN's:
    :func:`cudnn_block_bwd`) and the bound. ``gp``: the pooled cotangent,
    handed to both versions (``g``, args[0], may then be None), the
    kernel's first pass bit-equal to the plain one's, cuDNN's backward
    after the pool's transpose (:func:`library_cotangent`); ``also``: a
    second entry (the mode's) that takes the same numbers."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.workload import block_bwd_bytes, block_flops, cuda_ms, dgrad_flops

    def dbl(a):
        return None if a is None else a.double()

    kw, kw64 = ({}, {}) if gp is None else ({"gp": gp}, {"gp": gp.double()})
    out, again, ref = kernel(*args, **kw), kernel(*args, **kw), plain(*args, **kw)
    ref64 = plain(*map(dbl, args), **kw64)
    first = True
    if gp is not None:
        first = torch.equal(kc.masked_cotangent_kernel(args[0], gp, args[-4]),
                            kc.masked_cotangent_plain(args[0], gp, args[-4]))
    torch.cuda.synchronize()
    ok, worst, worst64 = first, (0.0, ""), (0.0, "")
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
        for e in filter(None, (entry, also)):
            e["max_abs_err"] = max(e["max_abs_err"], err)
    ok &= same
    del out, again, ref, ref64
    CHECKED.add(shape_key(entry["name"], args, need_dx))
    verdict = (f"kernel {label}: worst max_abs_err/max|plain| {worst[0]:.3e} ({worst[1]}; tol "
               f"{BWD_REL_TOL:.0e}), /max|ref64| {worst64[0]:.3e} ({worst64[1]}; tol "
               f"{BWD_REF64_TOL:.0e}), repeat bit-equal {same}"
               + ("" if gp is None else f", da_3 bit-equal to the plain version's {first}"))
    if not timed:
        log(f"{verdict} {'ok' if ok else 'FAIL'}")
        return ok
    ms, plain_ms = cuda_ms(lambda: kernel(*args, **kw)), cuda_ms(lambda: plain(*args, **kw))
    # wgrad of three layers, dgrad of two (and of the first with dx);
    # reads x (or xa, xb), h1, h2, h3, g (and/or gp), W; writes dx, dW, db
    b, h, w, c = args[-4].shape
    cin = sum(t.shape[-1] for t in args[1:-6])
    lib_args = (torch.cat(args[1:-6], dim=-1), *args[-6:-3], *map(oihw, args[-3:]))
    benchmark = (b, h, w, cin, c) in BWD_LIBRARY_BENCHMARK
    torch.backends.cudnn.benchmark = benchmark
    try:
        library_ms = cuda_ms(lambda: cudnn_block_bwd(library_cotangent(args[0], gp, args[-4]),
                                                     *lib_args, need_dx=need_dx))
    finally:
        torch.backends.cudnn.benchmark = False
    del lib_args
    mode = "full" if gp is None else "only" if args[0] is None else "with"
    flops = block_flops(b, h, w, cin, c) + dgrad_flops(b, h, w, cin, c, need_dx)
    nbytes = block_bwd_bytes(b, h, w, cin, c, need_dx, act_bytes=4, g_mode=mode)
    bound, term = add_bound(entry, binding, flops, nbytes, per_step)
    log(f"{verdict}, ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} "
        f"library_ms {library_ms:.3f}"
        f"{' (cudnn.benchmark on)' if benchmark else ''} bound_ms {bound:.3f} ({term}) "
        f"{'ok' if ok else 'FAIL'}")
    if also is not None:
        add_bound(also, binding, flops, nbytes, per_step)
    add_times((entry, also), per_step, ms, plain_ms, library_ms)
    return ok


def add_times(entries, weight, ms, plain_ms, library_ms):
    """Add ``weight`` calls' kernel, plain and library ms to each entry
    (None entries skipped)."""
    for e in filter(None, entries):
        e["ms"] += weight * ms
        e["plain_ms"] += weight * plain_ms
        e["library_ms"] = (e["library_ms"] or 0.0) + weight * library_ms


def library_cotangent(g, gp, h3):
    """The block output's cotangent as the unfused path forms it for the
    library's backward: the 2x2 average pool's backward of ``gp``
    (``avg_pool2d_backward``, what autograd of the pool runs), plus ``g``;
    ``g`` itself without a pooled cotangent. Timed in ``library_ms`` only."""
    import torch

    if gp is None:
        return g
    gx = torch.ops.aten.avg_pool2d_backward(gp.permute(0, 3, 1, 2), h3.permute(0, 3, 1, 2),
                                            [2, 2], [2, 2], [0, 0], False, True, None)
    gx = gx.permute(0, 2, 3, 1)
    return gx if g is None else g + gx


def first_draw(gen, gen_modes, seen, shape):
    """``gen`` at a shape's first backward check and ``gen_modes`` at its
    repeats (the modes' other entries), so that the checks before the modes
    draw what they drew."""
    src = gen_modes if shape in seen else gen
    seen.add(shape)
    return src


def recompute_checks(dev, results, binding, gen, dtype):
    """:func:`check_recompute` at workload.RECOMPUTE_SHAPE (single entry)
    and RECOMPUTE_DUAL_SHAPE (dual entry), inputs in ``dtype``."""
    import torch

    from pda_torch.tools import workload as wl

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    b, h, w, cin, c = wl.RECOMPUTE_SHAPE
    ok = check_recompute(results["conv_block_bwd_recompute" + suffix],
                         f"conv_block_bwd recompute {cin}->{c} @{b}x{h}x{w}",
                         (torch.randn(b, h, w, cin, generator=gen).to(dev).to(dtype),),
                         wl.conv_weights(gen, cin, c, dev), binding)
    b, h, w, ca, cb, c = wl.RECOMPUTE_DUAL_SHAPE
    return ok & check_recompute(results["conv_block_bwd_dual_recompute" + suffix],
                                f"conv_block_bwd_dual recompute {ca}+{cb}->{c} @{b}x{h}x{w}",
                                tuple(torch.randn(b, h, w, k, generator=gen).to(dev).to(dtype)
                                      for k in (ca, cb)),
                                wl.conv_weights(gen, ca + cb, c, dev), binding)


def check_recompute(entry, label, xs, weights, binding, per_step=1):
    """The backward with recompute (h1, h2 None: the mixed mode) against the
    saved-h kernel from the forward kernel's h1, h2, h3 on the same inputs:
    every output bit-equal (the recompute runs the forward's own layer
    bodies). Then what the two are made of, each against its plain version
    on the same tensors (a plain recompute of h1, h2 would set some ReLU
    masks apart at values within rounding of 0, and a flipped mask moves a
    cotangent by its whole value): in float32 the forward kernel's h1, h2
    within K12_REL_TOL / K12_REF64_TOL of the plain forward's, and the
    outputs within BWD_REL_TOL / BWD_REF64_TOL of the plain backward from
    the kernel's h1, h2, h3; in bf16 h1, h2 by the layer rule
    (:func:`bf16_layers_agree`; the bf16 phase holds the saved-h backward
    by its layer rule). Then the kernel's, the saved-h kernel's, the plain
    version's (recomputing) and cuDNN's times (the first two layers, then
    :func:`cudnn_block_bwd`) and the bound."""
    import torch
    import torch.nn.functional as F

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.workload import (PEAK_BF16_FLOPS, block_bwd_bytes, block_flops,
                                          cuda_ms, dgrad_flops, recompute_flops)

    w1, b1, w2, b2, w3, b3 = weights
    dual, bf16 = len(xs) == 2, xs[0].dtype == torch.bfloat16
    gen = torch.Generator(device=xs[0].device).manual_seed(SEED)
    h1, h2, h3 = kc._launch(xs[0], xs[1] if dual else None, *weights)
    g = torch.randn(h3.shape, generator=gen, device=h3.device).to(h3.dtype)
    bwd = kc.conv_block_bwd_dual if dual else kc.conv_block_bwd
    bwd_plain = kc.conv_block_bwd_dual_plain if dual else kc.conv_block_bwd_plain

    def kernel(*h):
        return bwd(g, *xs, *h, h3, w1, w2, w3, b1=b1, b2=b2)

    def plain(dtype=None):
        a = [t if dtype is None else t.to(dtype) for t in (g, *xs, h3, w1, w2, w3, b1, b2)]
        return bwd_plain(*a[:-6], None, None, *a[-6:-2], b1=a[-2], b2=a[-1])

    out, again, saved = kernel(None, None), kernel(None, None), kernel(h1, h2)
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    equal = all(torch.equal(a, b) for a, b in zip(out, saved))
    ok, detail = same and equal, ""
    x = torch.cat(xs, dim=-1)
    if bf16:
        good, worst, _ = bf16_layers_agree((h1, h2), x, weights[:4])
        ok &= good
        detail = (f"; the forward kernel's h1, h2 by the layer rule: beyond 1 ulp {worst[0]} "
                  f"elements, bit-equal {worst[1]:.6f}")
    else:
        worst_h, worst = 0.0, 0.0
        for h, r, r64 in zip((h1, h2), kc._nhwc(kc._plain_layers(x, *weights[:4])),
                             kc._nhwc(kc._plain_layers(x.double(),
                                                       *(t.double() for t in weights[:4])))):
            err, scale = float((h - r).abs().max()), float(r.abs().max())
            err64 = float((h.double() - r64).abs().max())
            ok &= err <= K12_REL_TOL * scale and err64 <= K12_REF64_TOL * float(r64.abs().max())
            worst_h = max(worst_h, err / scale)
        saved_args = (g, *xs, h1, h2, h3, w1, w2, w3)
        ref = bwd_plain(*saved_args)
        ref64 = bwd_plain(*(t.double() for t in saved_args))
        for a, r, r64 in zip(out, ref, ref64):
            err, err64 = float((a - r).abs().max()), float((a.double() - r64).abs().max())
            ok &= (err <= BWD_REL_TOL * float(r.abs().max())
                   and err64 <= BWD_REF64_TOL * float(r64.abs().max()))
            worst = max(worst, err / float(r.abs().max()))
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        detail = (f"; the forward kernel's h1, h2 against the plain forward's worst |err|/max "
                  f"{worst_h:.3e}, the outputs against the plain backward from them "
                  f"{worst:.3e}")
        del ref, ref64
    del out, again, saved
    ms, saved_ms = cuda_ms(lambda: kernel(None, None)), cuda_ms(lambda: kernel(h1, h2))
    plain_ms = cuda_ms(plain)
    lib_w = [oihw(t).to(x.dtype) for t in (w1, w2, w3)]

    def library():
        hs = []
        h = x.permute(0, 3, 1, 2)
        for w, b in ((lib_w[0], b1), (lib_w[1], b2)):
            h = F.relu(F.conv2d(h, w, b.to(x.dtype), padding=1))
            hs.append(h.permute(0, 2, 3, 1))
        return cudnn_block_bwd(g, x, *hs, h3, *lib_w, need_dx=True)

    library_ms = cuda_ms(library)
    b, h, w, c = h3.shape
    cin = x.shape[-1]
    flops = (block_flops(b, h, w, cin, c) + dgrad_flops(b, h, w, cin, c, True)
             + recompute_flops(b, h, w, cin, c))
    nbytes = block_bwd_bytes(b, h, w, cin, c, True, act_bytes=2 if bf16 else 4, recompute=True)
    bound, term = add_bound(entry, binding, flops, nbytes, per_step,
                            PEAK_BF16_FLOPS if bf16 else PEAK_FLOPS)
    log(f"{'bf16 ' if bf16 else ''}kernel {label}: bit-equal to the saved-h kernel {equal}, "
        f"repeat bit-equal {same}{detail}; ms {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s) "
        f"saved-h kernel ms {saved_ms:.3f} plain_ms {plain_ms:.3f} library_ms {library_ms:.3f} "
        f"bound_ms {bound:.3f} ({term}) {'ok' if ok else 'FAIL'}")
    add_times((entry,), per_step, ms, plain_ms, library_ms)
    CHECKED.add((entry["name"], (b, h, w, *(t.shape[-1] for t in xs), c)))
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
    add_times((entry,), per_forward, ms, plain_ms, library_ms)
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

    # the MT step's single-input backwards, each in its mode: the pooled
    # cotangent ("with": the skip's and the pool's, "only": the pool's) or
    # the output's own ("full"); conv_block_bwd's times sum the step's calls,
    # conv_block_bwd_pool's the pooled ones among them
    gen_modes, seen = torch.Generator().manual_seed(SEED + 13), set()
    for (b, h, w, cin, c), need_dx, per_step, mode in (wl.BWD_SHAPES
                                                       + [(wl.LEARN_BLOCK, True, 0, "full")]):
        g, *rest = saved_block(first_draw(gen, gen_modes, seen, (b, h, w, cin, c)),
                               b, h, w, cin, c, dev)
        gp = None if mode == "full" else torch.randn(b, h // 2, w // 2, c,
                                                     generator=gen_modes).to(dev)
        ok &= check_bwd(results["conv_block_bwd"], f"conv_block_bwd {cin}->{c} @{b}x{h}x{w} "
                        f"need_dx={need_dx} g_mode={mode}",
                        lambda *a, **k: kc.conv_block_bwd(*a, need_dx=need_dx, **k),
                        lambda *a, **k: kc.conv_block_bwd_plain(*a, need_dx=need_dx, **k),
                        (None if mode == "only" else g, *rest),
                        ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"), per_step, binding,
                        need_dx, gp=gp, also=None if gp is None else results["conv_block_bwd_pool"])
        del g, rest, gp
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

    # the backward with recompute (PDA_PALLAS_CONV_MODE=mixed), each entry
    ok &= recompute_checks(dev, results, binding, gen_modes, torch.float32)

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
    SPREAD_FACTOR times the CPU's own float32 distance: a ReLU pixel whose
    pre-activation lies within float32 rounding of 0 may switch sides
    between card and CPU and move one leaf by a few 1e-3 of its largest,
    and a leaf whose gradient is a small remainder of cancelling terms (the
    UNet's, after its InstanceNorms) is 1e-2 off float64 in float32 on the
    CPU too. The worst errors of card and CPU against float64 are printed
    beside."""
    import torch

    from pda_torch.tools.ab import SPREAD_FACTOR

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
                beyond = 1.0 - cos > max(GRAD_COS_TOL, SPREAD_FACTOR * (1.0 - cos_cpu))
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
                  f"1 - max({GRAD_COS_TOL:.0e}, {SPREAD_FACTOR:g} x the CPU's)); against "
                  f"the CPU's float64 step: card {worst64[0]:.3e} ({worst64[1]}), the CPU's "
                  f"float32 {cpu_worst64[0]:.3e} ({cpu_worst64[1]})")
    log(f"{label} card vs cpu: {grads}; updated student max_abs_err {param_worst:.3e}, teacher "
        f"{teacher_worst:.3e} (tol {MT_PARAM_TOL:.0e}) {'ok' if good else 'FAIL'}")
    return ok and good


def phase_training(dev, results):
    """The Mean-Teacher step of the flagship: one step at 128^2 on the card
    against the port on the CPU, launch counts, then timed 512^2 steps; then
    the same under PDA_PALLAS_CONV_MODE=mixed (64^2 card vs CPU, timed
    512^2 beside the default's ms and peak).
    Returns (ok, the timed step's median ms)."""
    import torch

    from pda_torch.models.punet import livecell_punet, mc_decode_logits
    from pda_torch.tools import ab_step_check
    from pda_torch.tools.ab import kernel_wrappers, reset_launches
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step, steps

    wrappers = kernel_wrappers()
    gen = torch.Generator().manual_seed(SEED + 1)
    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED),
                           device="cpu")
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(LAST_SCALE)
    frame = synthetic_frame(gen, FRAME, "cpu")
    step = make_mean_teacher_step(momentum=MT_MOMENTUM, do_consensus_masking=True)

    def state_on(device, dtype=torch.float32):
        student = copy.deepcopy(model).to(device=device, dtype=dtype)
        return create_train_state(student, adam(student.parameters(), MT_LR), with_teacher=True)

    # 1. one step at 128^2 on the card and on the CPU, same weights, batch, noise
    batch = mt_batch(gen, frame, MT_CHECK_PATCH, "cpu")
    noise = {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen),
             "eps_post": torch.randn(MT_BATCH, 6, generator=gen)}
    card, cpu = state_on(dev), state_on("cpu")
    reset_launches(wrappers)
    _, aux = step(card, *(a.to(dev) for a in batch), **{k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    counts = counted_launches(wrappers, results)
    modes = mode_launches(wrappers)
    ok = counts == MT_LAUNCHES and modes == MT_MODE_LAUNCHES
    log(f"training MT step 128^2: launches {counts} (expected {MT_LAUNCHES}), by backward mode "
        f"{modes} (expected {MT_MODE_LAUNCHES}) {'ok' if ok else 'FAIL'}")

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
    label = f"MT step MC-{MC} 512^2 batch {MT_BATCH} f32"
    time_batch = mt_batch(gen, frame, MT_TIME_PATCH, dev)
    good, ms = time_steps(label, step, state_on(dev), time_batch, MT_BATCH, wrappers,
                          MT_LAUNCHES, MT_WARMUP, MT_TIMED,
                          torch.Generator(device=dev).manual_seed(SEED), modes=MT_MODE_LAUNCHES)
    ok &= good

    # 3. the mixed mode: one 64^2 step card vs CPU (float32; float64 the
    # gradients' reference), the CPU on the card teacher's pseudo-labels;
    # its launches are the mode's main path's run; then timed at 512^2
    batch = mt_batch(gen, frame, MIXED_CHECK_PATCH, "cpu")
    noise = {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen),
             "eps_post": torch.randn(MT_BATCH, 6, generator=gen)}
    with conv_mode("mixed"):
        card, cpu, cpu64 = state_on(dev), state_on("cpu"), state_on("cpu", torch.float64)
        drawn, pseudo = [], steps._mc_pseudo
        steps._mc_pseudo = lambda *a, **k: drawn.append(pseudo(*a, **k)) or drawn[-1]
        reset_launches(wrappers)
        try:
            _, aux = step(card, *(a.to(dev) for a in batch),
                          **{k: v.to(dev) for k, v in noise.items()})
            torch.cuda.synchronize()
        finally:
            steps._mc_pseudo = pseudo
        counts = counted_launches(wrappers, results)
        modes = mode_launches(wrappers)
        good = counts == MIXED_MT_LAUNCHES and modes == MIXED_MT_MODE_LAUNCHES
        log(f"training mixed MT step {MIXED_CHECK_PATCH}^2: launches {counts} (expected "
            f"{MIXED_MT_LAUNCHES}), by backward mode {modes} (expected "
            f"{MIXED_MT_MODE_LAUNCHES}) {'ok' if good else 'FAIL'}")
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
        good &= check_step(f"training mixed MT step {MIXED_CHECK_PATCH}^2", card, cpu, aux,
                           aux_cpu, model.state_dict(), MT_LR, ref64=cpu64)
        log(f"training mixed MT step card vs cpu: cpu (float32 and float64) "
            f"{time.perf_counter() - t0:.1f} s")
        ok &= good
        del card, cpu, cpu64, drawn
        mixed = f"MT step MC-{MC} 512^2 batch {MT_BATCH} f32 PDA_PALLAS_CONV_MODE=mixed"
        good, mixed_ms = time_steps(mixed, step, state_on(dev), time_batch, MT_BATCH, wrappers,
                                    MIXED_MT_LAUNCHES, MT_WARMUP, MT_TIMED,
                                    torch.Generator(device=dev).manual_seed(SEED),
                                    modes=MIXED_MT_MODE_LAUNCHES)
    ok &= good
    log(f"time MT step 512^2 batch {MT_BATCH} f32: mixed {mixed_ms:.2f} ms, peak "
        f"{STEP_PEAKS[mixed]:.2f} GiB against the default's {ms:.2f} ms, peak "
        f"{STEP_PEAKS[label]:.2f} GiB ({mixed_ms / ms:.3f}x the time, "
        f"{STEP_PEAKS[mixed] / STEP_PEAKS[label]:.3f}x the peak)")

    # 4. pda's development/ab_step_check.py at 256^2 in float32, through
    # pda_torch/tools/ab_step_check.py: the step's compute on the kernels
    # against every plain version on the card, at pda's bounds (a check's
    # launches: logged only)
    t0 = time.perf_counter()
    passed, res, *_ = ab_step_check.check(AB_PATCH, "f32", ab_step_check.FILTERS, dev)
    good = all(passed.values())
    log(f"training ab_step_check {AB_PATCH}^2 f32 kernels vs plain: "
        f"{time.perf_counter() - t0:.1f} s, launches {res['launches']} "
        + ("ok" if good else f"FAIL ({', '.join(k for k, v in passed.items() if not v)})"))
    ok &= good
    return ok, ms


@contextlib.contextmanager
def conv_mode(mode):
    """``PDA_PALLAS_CONV_MODE`` set to ``mode`` while the block runs (the
    port reads it at each block call, as pda does)."""
    before = os.environ.get("PDA_PALLAS_CONV_MODE")
    os.environ["PDA_PALLAS_CONV_MODE"] = mode
    try:
        yield
    finally:
        if before is None:
            del os.environ["PDA_PALLAS_CONV_MODE"]
        else:
            os.environ["PDA_PALLAS_CONV_MODE"] = before


def time_steps(label, step, state, batch, n_patches, wrappers, launches, warmup, timed,
               generator=None, bf16=False, modes=None):
    """Train steps on the card, timed: the CUDA-event median of ``timed``
    steps after ``warmup``, ms/step, patches/s and peak memory (also kept
    in STEP_PEAKS[label]); every loss finite and each kernel launched
    ``launches[name]`` times a step (its bf16 instance with ``bf16``), and
    with ``modes`` each backward mode ``modes[entry]`` times. Returns (ok,
    ms)."""
    import torch

    from pda_torch.tools.ab import read_launches, reset_launches

    reset_launches(wrappers)
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
    counts = read_launches(wrappers, bf16)
    n = warmup + timed
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    good = finite and counts == {k: n * v for k, v in launches.items()} and state.step == n
    by_mode = ""
    if modes is not None:
        got = mode_launches(wrappers, bf16)
        good &= got == {k: n * v for k, v in modes.items()}
        by_mode = f", by backward mode {got}"
    if bf16:
        on, routes = all_on_wgmma(wrappers)
        good &= on
        by_mode += f", on the wgmma bodies {routes}"
    STEP_PEAKS[label] = peak
    log(f"training {label}: losses {[round(float(v), 5) for v in losses]} finite {finite}, "
        f"launches {counts}{by_mode} over {n} steps {'ok' if good else 'FAIL'}")
    log(f"time {label}: {ms:.2f} ms/step (median of {timed}, min {min(times):.2f}, max "
        f"{max(times):.2f}), {n_patches} patches a step, {1000.0 * n_patches / ms:.3f} "
        f"patches/s, peak {peak:.2f} GiB")
    return good, ms


# The bf16 phase: pda's bf16 configuration (bench.py's default MT step,
# livecell_punet(dtype=torch.bfloat16)) on the bf16 instances of the four
# kernel bodies. Each body against its plain version in float64 sums, layer
# by layer with the kernel's own input to each layer (a bf16 rounding that
# falls the other way in one layer moves every layer after it: the check
# holds each layer, not the chain): bf16 outputs within one bf16 ulp of the
# plain value, or within BF16_ABS_TOL of the layer's largest where the value
# is so small that its ulp is finer than the float32 sums' error (values near
# a ReLU's 0), and bit-equal on BF16_BIT_EQUAL of the elements; dW and db
# within BF16_GRAD_TOL of their largest; K3's mean within one bf16 ulp at
# 0.5-1 (2^-8), its consensus only where a logit lies within one bf16 ulp of
# a threshold (2^-6 at |logit| = log 9). Then one 128^2 MT step card vs CPU
# and the 512^2 step with the kernels against the step with every plain
# version on the card (pda's development/ab_step_check.py at the bench
# geometry: loss, gradients' cosine, worst leaf, consensus), timed steps,
# tiled serving, and Trainer(mixed_precision=True). The A/B's teacher: two
# bf16 forwards part once a rounding falls the other way, so pixels whose
# sample logits lie near a threshold flip between any two summation orders;
# against the plain leg, the kernels' consensus may differ at no more than
# SPREAD_FACTOR times the pixels at which the plain leg's own two
# summation orders (float32 and float64 sums) differ (the A/B, its bounds
# AB_*_TOL and its measures live in pda_torch/tools/ab.py, which
# pda_torch/tools/ab_step_check.py runs too). These whole-step
# comparisons check the wiring and catch gross faults: a bf16 ConvBlock that
# drops its per-layer roundings passes them (pda_torch/tools/bf16_controls.py;
# two valid summation orders part as far), so the layer-by-layer checks are
# what hold the bodies' rounding points.
BF16_ABS_TOL = 1e-5
BF16_BIT_EQUAL = 0.99
BF16_GRAD_TOL = 1e-4
K3_BF16_MEAN_TOL = 2.0 ** -8
K3_BF16_WINDOW = 2.0 ** -6
BF16_FIT_STEPS = 2
BF16_KERNELS = ("conv_block_fwd", "conv_block_fwd_dual", "mc_consensus", "conv_block_bwd",
                "conv_block_bwd_dual", *MODE_ENTRIES)


def bf16_name(name):
    """The JSON line's name of a kernel's bf16 instance."""
    return f"{name}_bf16"


def bf16_ulp(t):
    """One bf16 ulp at each element of a float tensor (0 -> the least normal's)."""
    import torch

    _, e = torch.frexp(t.double().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64), e - 8)


def bf16_agree(out, ref, first=None):
    """(ok, elements beyond one ulp and beyond BF16_ABS_TOL, bit-equal share,
    largest difference relative to max |ref|) of a bf16 ``out`` against its
    bf16 reference; ``first``: an earlier rounding of the same value (a
    conv's sum before its bias add), whose one ulp adds to the result's (a
    sum one ulp off, then rounded again with the bias, can land two of the
    result's ulps off: ties fall to even both ways)."""
    import torch

    a, r = out.double(), ref.double()
    diff = (a - r).abs()
    scale = float(r.abs().max()) or 1.0
    tol = bf16_ulp(torch.maximum(a.abs(), r.abs()))
    if first is not None:
        tol = tol + bf16_ulp(first.double().abs())
    beyond = (diff > tol) & (diff > BF16_ABS_TOL * scale)
    n_beyond = int(beyond.sum())
    equal = float((out.view(torch.int16) == ref.view(torch.int16)).double().mean())
    ok = n_beyond == 0 and equal >= BF16_BIT_EQUAL and bool(torch.isfinite(a).all())
    return ok, n_beyond, equal, float(diff.max()) / scale


def plain_wgrad(h_in, da):
    """dW (float64) and db of one layer from bf16 tensors, summed in float64."""
    from pda_torch.kernels import conv_block as kc

    return kc._wgrad_plain(h_in.double(), da.double()), da.double().sum(dim=(0, 1, 2))


def plain_dgrad(da, w, mask):
    """One layer's dgrad as the bf16 kernel computes it, summed in float64:
    the kernel rounded to bf16, the sum masked by [mask > 0] (no mask: dx),
    rounded to bf16 once."""
    import torch
    import torch.nn.functional as F

    from pda_torch.kernels import conv_block as kc

    wk = kc.bf16_operand(w, torch.float64).flip(0, 1).permute(2, 3, 0, 1)
    r = F.conv2d(da.double().permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    if mask is not None:
        r = torch.where(mask > 0, r, 0.0)
    return r.to(torch.bfloat16).contiguous()


def bf16_layers_agree(hs, h_in, ws):
    """A bf16 block's outputs ``hs`` (h1, h2, h3) layer by layer, each from
    the block's own input to it, against the plain layer in float64 sums by
    :func:`bf16_agree`. Returns (ok, (most elements beyond, least bit-equal
    share, largest relative difference), max abs error)."""
    import torch

    from pda_torch.kernels import conv_block as kc

    ok, worst, err = True, (0, 1.0, 0.0), 0.0
    for k, h in enumerate(hs):
        with kc.plain_sums(torch.float64):
            ref = kc.conv_relu_layer(h_in.permute(0, 3, 1, 2), ws[2 * k],
                                     ws[2 * k + 1]).permute(0, 2, 3, 1)
        good, n_beyond, equal, rel = bf16_agree(h, ref)
        ok &= good
        worst = (max(worst[0], n_beyond), min(worst[1], equal), max(worst[2], rel))
        err = max(err, float((h.double() - ref.double()).abs().max()))
        h_in = h
    return ok, worst, err


def check_bf16_fwd(entry, label, args, per_forward, binding, also=None):
    """A bf16 forward block (K1 or K2, args (x[, xb], w1, b1, .., b3)) layer
    by layer against its plain version, twice bit-equal, its tensor-core
    layers on the wgmma body; then the kernel's, the plain version's
    (float32 sums) and cuDNN's bf16 times and the bound, added to ``entry``
    and to ``also`` (the wgmma route's entry). Returns ok."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.workload import PEAK_BF16_FLOPS, block_bytes, block_flops, cuda_ms

    xs, ws = args[:-6], args[-6:]
    kernel = kc.conv_block_fwd if len(xs) == 1 else kc.conv_block_fwd_dual
    plain = kc.conv_block_fwd_plain if len(xs) == 1 else kc.conv_block_fwd_dual_plain
    hs = kc._launch(xs[0], xs[1] if len(xs) > 1 else None, *ws)
    again = kc._launch(xs[0], xs[1] if len(xs) > 1 else None, *ws)
    same = all(torch.equal(a, b) for a, b in zip(hs, again))
    good, worst, err = bf16_layers_agree(hs, torch.cat(xs, dim=-1), ws)
    route = kc._fwd_modes(xs, ws[-1].shape[0]) == ("wgmma",)
    ok = same and good and route
    for e in filter(None, (entry, also)):
        e["max_abs_err"] = max(e["max_abs_err"], err)
    del hs, again
    CHECKED.add(shape_key(entry["name"], args))
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    x = torch.cat(xs, dim=-1)
    lib_args = (x, *[t.to(torch.bfloat16) for t in cudnn_weights(*ws)])
    library_ms = cuda_ms(lambda: cudnn_block(*lib_args))
    b, h, w, cin = x.shape
    c = ws[-1].shape[0]
    flops = block_flops(b, h, w, cin, c)
    nbytes = block_bytes(b, h, w, cin, c)
    bound, term = add_bound(entry, binding, flops, nbytes, per_forward, PEAK_BF16_FLOPS)
    if also is not None:
        add_bound(also, binding, flops, nbytes, per_forward, PEAK_BF16_FLOPS)
    del x, lib_args
    log(f"bf16 kernel {label}: per layer, beyond 1 ulp and {BF16_ABS_TOL:.0e} of max "
        f"{worst[0]} elements, bit-equal {worst[1]:.6f} (>= {BF16_BIT_EQUAL}), worst "
        f"|diff|/max {worst[2]:.3e}; repeat bit-equal {same}; on the wgmma body {route}; "
        f"ms {ms:.3f} "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} library_ms (cuDNN bf16) "
        f"{library_ms:.3f} bound_ms {bound:.3f} ({term}) {'ok' if ok else 'FAIL'}")
    add_times((entry, also), per_forward, ms, plain_ms, library_ms)
    return ok


def check_bf16_bwd(entry, label, args, need_dx, per_step, binding, gp=None, also=()):
    """A bf16 backward block (args (g, x[, xb], h1, h2, h3, w1, w2, w3))
    layer by layer, each layer from the kernel's own cotangent (its da
    workspaces): dW, db within BF16_GRAD_TOL of the largest, da_2, da_1 and
    dx by :func:`bf16_agree`; twice bit-equal; every dgrad and every wgrad
    but an entry layer's on the wgmma bodies (``kc._bwd_modes``), and the
    share of the timed launches that took that route; then times and the
    bound. ``gp``: the pooled cotangent (``g`` may be None), da_3 the
    kernel's first pass, bit-equal to the plain one's (one rounding of a
    float32 sum); cuDNN's time after the pool's transpose; ``also``: more
    entries (the mode's, the route's) that take the same numbers."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.workload import (PEAK_BF16_FLOPS, block_bwd_bytes, block_flops, cuda_ms,
                                          dgrad_flops)

    g, *xs = args[:-6]
    h1, h2, h3, w1, w2, w3 = args[-6:]
    dual = len(xs) == 2
    ws = (torch.empty_like(h1), torch.empty_like(h1))
    out = kc._launch_bwd(g, xs[0], xs[1] if dual else None, h1, h2, h3, w1, w2, w3, need_dx,
                         workspaces=ws, gp=gp)
    again = kc._launch_bwd(g, xs[0], xs[1] if dual else None, h1, h2, h3, w1, w2, w3, need_dx,
                           gp=gp)
    same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, again))
    dxa, dxb, dw1, db1, dw2, db2, dw3, db3 = out
    da1, da2 = ws  # the kernel's da_1 and da_2
    x = torch.cat(xs, dim=-1)
    da3 = kc.masked_cotangent_kernel(g, gp, h3)
    first = torch.equal(da3, kc.masked_cotangent_plain(g, gp, h3))
    route = kc._bwd_modes(xs[0], xs[1] if dual else None, h3.shape[-1],
                          need_dx or dual) == ("wgmma",)
    ok, grad_worst, worst = same and first and route, 0.0, (0, 1.0, 0.0)
    for (dw, db), h_in, da in (((dw3, db3), h2, da3), ((dw2, db2), h1, da2),
                               ((dw1, db1), x, da1)):
        rw, rb = plain_wgrad(h_in, da)
        for a, r in ((dw, rw), (db, rb)):
            err = float((a.double() - r).abs().max()) / (float(r.abs().max()) or 1.0)
            grad_worst = max(grad_worst, err)
            for e in filter(None, (entry, *also)):
                e["max_abs_err"] = max(e["max_abs_err"], float((a.double() - r).abs().max()))
    checks = [(da2, plain_dgrad(da3, w3, h2)), (da1, plain_dgrad(da2, w2, h1))]
    if need_dx or dual:
        dx = torch.cat([dxa, dxb], dim=-1) if dual else dxa
        checks.append((dx, plain_dgrad(da1, w1, None)))
    for a, r in checks:
        good, n_beyond, equal, rel = bf16_agree(a, r)
        ok &= good
        worst = (max(worst[0], n_beyond), min(worst[1], equal), max(worst[2], rel))
    ok &= grad_worst <= BF16_GRAD_TOL
    del out, again, checks, da3, x
    CHECKED.add(shape_key(entry["name"], args, need_dx))
    kw = {} if gp is None else {"gp": gp}
    if dual:
        kernel = lambda: kc.conv_block_bwd_dual(*args, **kw)  # noqa: E731
        plain = lambda: kc.conv_block_bwd_dual_plain(*args, **kw)  # noqa: E731
    else:
        kernel = lambda: kc.conv_block_bwd(*args, need_dx=need_dx, **kw)  # noqa: E731
        plain = lambda: kc.conv_block_bwd_plain(*args, need_dx=need_dx, **kw)  # noqa: E731
    wrapper = kc.conv_block_bwd_dual if dual else kc.conv_block_bwd
    before = (wrapper.launches_bf16, wrapper.launches_wgmma_bf16)
    ms = cuda_ms(kernel)
    share = ((wrapper.launches_wgmma_bf16 - before[1])
             / max(wrapper.launches_bf16 - before[0], 1))
    plain_ms = cuda_ms(plain)
    b, h, w, c = h3.shape
    cin = sum(t.shape[-1] for t in xs)
    lib_args = (torch.cat(xs, dim=-1), h1, h2, h3,
                *[oihw(t).to(torch.bfloat16) for t in (w1, w2, w3)])
    library_ms = cuda_ms(lambda: cudnn_block_bwd(library_cotangent(g, gp, h3), *lib_args,
                                                 need_dx=need_dx or dual))
    del lib_args
    mode = "full" if gp is None else "only" if g is None else "with"
    flops = block_flops(b, h, w, cin, c) + dgrad_flops(b, h, w, cin, c, need_dx or dual)
    nbytes = block_bwd_bytes(b, h, w, cin, c, need_dx or dual, g_mode=mode)
    bound, term = add_bound(entry, binding, flops, nbytes, per_step, PEAK_BF16_FLOPS)
    log(f"bf16 kernel {label}: per layer dW, db worst |err|/max {grad_worst:.3e} (tol "
        f"{BF16_GRAD_TOL:.0e}); da_2, da_1{', dx' if need_dx or dual else ''} beyond 1 ulp and "
        f"{BF16_ABS_TOL:.0e} of max {worst[0]} elements, bit-equal {worst[1]:.6f}, worst "
        f"|diff|/max {worst[2]:.3e}; repeat bit-equal {same}"
        + ("" if gp is None else f", da_3 bit-equal to the plain version's {first}")
        + f"; on the wgmma bodies {route} (share of the timed launches {share:.3f})"
        + f"; ms {ms:.3f} "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} library_ms (cuDNN bf16) "
        f"{library_ms:.3f} bound_ms {bound:.3f} ({term}) {'ok' if ok else 'FAIL'}")
    for e in filter(None, also):
        add_bound(e, binding, flops, nbytes, per_step, PEAK_BF16_FLOPS)
    add_times((entry, *also), per_step, ms, plain_ms, library_ms)
    return ok


def check_bf16_mc(entry, label, args, masking, binding, weight):
    """K3's bf16 instance against its plain version summed in float64: the
    mean within K3_BF16_MEAN_TOL, the consensus only where a logit lies
    within K3_BF16_WINDOW of a threshold, twice bit-equal; times, bound."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.kernels import mc_consensus as km
    from pda_torch.tools.workload import PEAK_BF16_FLOPS, cuda_ms, mc_bytes, mc_flops

    mean, cons = km.mc_consensus(*args, masking=masking)
    again = km.mc_consensus(*args, masking=masking)
    same = torch.equal(mean, again[0]) and torch.equal(cons, again[1])
    with kc.plain_sums(torch.float64):
        ref_mean, ref_cons = plain_mc(km.mc_consensus_plain, args, masking)
        near = plain_mc(lambda *a: ((km.mc_logits_plain(*a).abs()
                                     - math.log(9.0)).abs() < K3_BF16_WINDOW).any(dim=0), args)
    err = float((mean.double() - ref_mean.double()).abs().max())
    flips = int((cons != ref_cons).sum())
    stray = int(((cons != ref_cons) & ~near).sum())
    good = bool(torch.isfinite(mean).all()) and err <= K3_BF16_MEAN_TOL and stray == 0 and same
    del mean, cons, again, ref_mean, ref_cons, near
    CHECKED.add(shape_key("mc_consensus", args, masking=masking))
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    ms = cuda_ms(lambda: km.mc_consensus(*args, masking=masking))
    plain_ms = cuda_ms(lambda: plain_mc(km.mc_consensus_plain, args, masking), iters=3)
    b, h, w, c = args[0].shape
    s, n_mid = args[1].shape[0], args[2].shape[0]
    flops = mc_flops(b, h, w, c, s, n_mid)
    bound, term = add_bound(entry, binding, flops, mc_bytes(b, h, w, c, s, n_mid, feat_bytes=2),
                            weight, PEAK_BF16_FLOPS)
    log(f"bf16 kernel mc_consensus {label} S={s} feat {b}x{h}x{w}x{c} masking={masking}: mean "
        f"max_abs_err {err:.3e} (tol 2^-8), consensus differs at {flips} px, {stray} of them "
        f"farther than 2^-6 from a threshold, repeat bit-equal {same}; ms {ms:.3f} "
        f"({flops / ms / 1e9:.1f} TFLOP/s) plain_ms {plain_ms:.3f} bound_ms {bound:.3f} ({term}) "
        f"{'ok' if good else 'FAIL'}")
    entry["ms"] += weight * ms
    entry["plain_ms"] += weight * plain_ms
    return good


def bf16_model():
    """The flagship in bf16 on the CPU, from SEED, its Fcomb's last layer x
    LAST_SCALE (the random teacher's consensus share inside (0, 1))."""
    import torch

    from pda_torch.models.punet import livecell_punet

    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED),
                           device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(LAST_SCALE)
    return model


def bf16_state(model, device):
    """A Mean-Teacher train state of a copy of ``model`` on ``device``."""
    from pda_torch.train import adam, create_train_state

    student = copy.deepcopy(model).to(device)
    return create_train_state(student, adam(student.parameters(), MT_LR), with_teacher=True)


def bf16_card_vs_cpu(dev, model, frame, gen, leg=contextlib.nullcontext, name="kernels"):
    """One 128^2 bf16 MT step (no update) on the card, inside ``leg`` (the
    kernels; a control's context), against the port's plain bf16 step on the
    CPU in float64 sums, the CPU taking the card teacher's pseudo-labels,
    judged by :func:`ab_compare` with the CPU's float32-vs-float64-sums
    spread. The card's launches are a check's: logged only. Returns
    {criterion: passed}."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.tools.ab import (ab_compare, ab_metrics, kernel_wrappers, mt_compute,
                                    read_launches, reset_launches, teacher_logits)

    wrappers = kernel_wrappers()
    batch = mt_batch(gen, frame, MT_CHECK_PATCH, "cpu")
    noise = {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen),
             "eps_post": torch.randn(MT_BATCH, 6, generator=gen)}
    reset_launches(wrappers)
    card_state = bf16_state(model, dev)
    with leg():
        card = mt_compute(card_state, [a.to(dev) for a in batch],
                          {k: v.to(dev) for k, v in noise.items()})
        torch.cuda.synchronize()
        counts = read_launches(wrappers, bf16=True)
        card["logits"] = teacher_logits(card_state, batch[1].to(dev),
                                        noise["eps_teacher"].to(dev))
    f32 = (card_state.model.unet.contracting_path[0].dtype == torch.bfloat16
           and all(p.grad.dtype == torch.float32 for p in card_state.model.parameters()))
    del card_state
    # the CPU's plain bf16 step in float64 sums (the reference) and in float32
    # sums: two summation orders of one algorithm, whose spread is bf16's own
    t0 = time.perf_counter()
    cpu = mt_compute(bf16_state(model, "cpu"), batch, noise, plain_teacher=True,
                     pseudo=(card["y"], card["z"]))
    with kc.plain_sums(torch.float32):
        cpu32 = mt_compute(bf16_state(model, "cpu"), batch, noise, pseudo=(card["y"], card["z"]))
    passed = ab_compare(
        f"bf16 MT step {MT_CHECK_PATCH}^2 card ({name}) vs cpu (the plain bf16 step, float64 "
        f"sums, on the card teacher's pseudo-labels; cpu {time.perf_counter() - t0:.1f} s; "
        f"launches {counts} (a check's; the kernels' expected {MT_LAUNCHES}), float32 gradients "
        f"{f32})", card, cpu, spread=ab_metrics(cpu32, cpu))
    passed["dtypes"] = f32
    return passed, counts


def bf16_ab(dev, model, frame, gen, leg=contextlib.nullcontext, name="kernels"):
    """The 512^2 bf16 MT step (no update) twice from one state on the card:
    inside ``leg`` (the kernels; a control's context), then with every plain
    version (float32 sums), at pda's A/B bounds; the teacher's logits and
    consensus against the plain leg's own float32-vs-float64-sums spread
    (``pda_torch.tools.ab.kernels_and_plain``). The launches are a check's:
    logged only. Returns ({criterion: passed}, launches)."""
    import torch

    from pda_torch.tools.ab import ab_compare, kernels_and_plain

    batch = mt_batch(gen, frame, MT_TIME_PATCH, dev)
    noise = {k: v.to(dev) for k, v in {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen),
                                       "eps_post": torch.randn(MT_BATCH, 6,
                                                               generator=gen)}.items()}
    t0 = time.perf_counter()
    kern, plain, spread, counts, plain_counts = kernels_and_plain(
        lambda: bf16_state(model, dev), batch, noise, f"bf16 MT step {MT_TIME_PATCH}^2", leg=leg,
        bf16=True)
    passed = ab_compare(f"bf16 MT step {MT_TIME_PATCH}^2 batch {MT_BATCH} {name} vs plain on the "
                        f"card ({time.perf_counter() - t0:.1f} s; launches {counts} (a check's), "
                        f"plain leg {plain_counts})", kern, plain, teacher_spread=spread)
    passed["plain leg"] = plain_counts == dict.fromkeys(plain_counts, 0)
    return passed, counts


def phase_bf16(dev, results, binding, f32_ms):
    """pda's bf16 configuration on the card: the four bf16 bodies at the MT
    step's and tiled serving's shapes, the 128^2 MT step card vs CPU, the
    512^2 step kernels vs plain, timed steps and serving, and
    Trainer(mixed_precision=True)."""
    import torch

    from pda_torch.infer import tiled_punet_probs
    from pda_torch.models.punet import livecell_punet
    from pda_torch.tools import workload as wl
    from pda_torch.tools.ab import kernel_wrappers, reset_launches
    from pda_torch.tools.workload import conv_weights, cuda_ms, livecell_mt_trainer
    from pda_torch.train import load_checkpoint, make_mean_teacher_step
    from pda_torch.train.checkpoint import LATEST

    bf16 = torch.bfloat16
    for name in BF16_KERNELS:
        source = results[name]["source"]
        entry = dict(results[name], name=bf16_name(name), dtype="bfloat16", launches=0,
                     source=source if name == "mc_consensus" else source.replace(".cu", "_bf16.cu"),
                     max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by=None,
                     library_ms=None)
        results[entry["name"]] = entry
    for name, (kernel, _) in ROUTE_ENTRIES.items():
        results[bf16_name(name)] = dict(
            results[bf16_name(kernel)], name=bf16_name(name),
            source="pda_torch/kernels/csrc/" + ("conv3x3_wgmma.cuh" if name in FWD_MODE_ENTRIES
                                                else "wgrad_wgmma.cuh"))
    k1, k2, k3 = (results[bf16_name(n)] for n in ("conv_block_fwd", "conv_block_fwd_dual",
                                                  "mc_consensus"))
    k1w, k2w = (results[bf16_name(n)] for n in FWD_MODE_ENTRIES)
    gen = torch.Generator().manual_seed(SEED + 3)
    ok = True

    # 1. each body at the tiled forward's and the MT step's shapes, and the
    # pseudo export's entry block (the JSON line's times: one tiled
    # forward's calls, one MT step's backward); the checks since the
    # backward's modes draw from their own generator, so that every other
    # check, the 512^2 A/B's included, keeps its data
    gen_modes, seen = torch.Generator().manual_seed(SEED + 14), set()
    with torch.inference_mode():
        for shape, per_forward, src in ([(s, 2, gen) for s in wl.K1_TILED]
                                        + [(wl.K1_POSTERIOR, 0, gen),
                                           (wl.K1_PSEUDO[0], 0, gen_modes)]):
            b, h, w, cin, c = shape
            x = torch.randn(b, h, w, cin, generator=src).to(dev).to(bf16)
            ok &= check_bf16_fwd(k1, f"conv_block_fwd {cin}->{c} @{b}x{h}x{w}",
                                 (x, *conv_weights(src, cin, c, dev)), per_forward, binding,
                                 also=k1w)
        for b, h, w, ca, cb, c in wl.K2_TILED:
            xa = torch.randn(b, h, w, ca, generator=gen).to(dev).to(bf16)
            xb = torch.randn(b, h, w, cb, generator=gen).to(dev).to(bf16)
            ok &= check_bf16_fwd(k2, f"conv_block_fwd_dual {ca}+{cb}->{c} @{b}x{h}x{w}",
                                 (xa, xb, *conv_weights(gen, ca + cb, c, dev)), 1, binding,
                                 also=k2w)
        for name, (b, h, w, c), masking in wl.K3_SHAPES[:2]:
            feat, *rest = wl.mc_inputs(gen, b, h, w, c, dev=dev)
            ok &= check_bf16_mc(k3, name, (feat.to(bf16), *rest), masking, binding,
                                int(name == "tiled"))
    for (b, h, w, cin, c), need_dx, per_step, mode in wl.BWD_SHAPES:
        g, x, *rest = saved_block(first_draw(gen, gen_modes, seen, (b, h, w, cin, c)),
                                  b, h, w, cin, c, dev, bf16)
        gp = None if mode == "full" else torch.randn(b, h // 2, w // 2, c,
                                                     generator=gen_modes).to(dev).to(bf16)
        ok &= check_bf16_bwd(results[bf16_name("conv_block_bwd")],
                             f"conv_block_bwd {cin}->{c} @{b}x{h}x{w} need_dx={need_dx} "
                             f"g_mode={mode}", (None if mode == "only" else g, x, *rest),
                             need_dx, per_step, binding, gp=gp,
                             also=(None if gp is None else results[
                                 bf16_name("conv_block_bwd_pool")],
                                   results[bf16_name("conv_block_bwd_wgmma")]))
        del g, x, rest, gp
    for b, h, w, ca, cb, c in wl.BWD_DUAL_SHAPES:
        g, x, *rest = saved_block(gen, b, h, w, ca + cb, c, dev, bf16)
        args = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *rest)
        del x
        ok &= check_bf16_bwd(results[bf16_name("conv_block_bwd_dual")],
                             f"conv_block_bwd_dual {ca}+{cb}->{c} @{b}x{h}x{w}", args, True, 1,
                             binding, also=(results[bf16_name("conv_block_bwd_dual_wgmma")],))
        del g, rest, args
    ok &= recompute_checks(dev, results, binding, gen_modes, bf16)
    torch.cuda.synchronize()

    # 2. one 128^2 bf16 MT step on the card against the port's plain bf16 step
    # on the CPU; 3. the 512^2 step twice from one state: the kernels, then
    # every plain version (both a check's runs: their launches logged only)
    wrappers = kernel_wrappers()
    model = bf16_model()
    frame = synthetic_frame(gen, FRAME, "cpu")
    passed, counts = bf16_card_vs_cpu(dev, model, frame, gen)
    ok &= all(passed.values()) and counts == MT_LAUNCHES
    passed, counts = bf16_ab(dev, model, frame, gen)
    ok &= all(passed.values()) and counts == MT_LAUNCHES
    batch = mt_batch(gen, frame, MT_TIME_PATCH, dev)

    # 4. 10 bf16 MT steps at 512^2, batch 2, timed; then under
    # PDA_PALLAS_CONV_MODE=mixed, beside them
    step = make_mean_teacher_step(momentum=MT_MOMENTUM, do_consensus_masking=True)
    label = f"MT step MC-{MC} 512^2 batch {MT_BATCH} bf16"
    good, ms = time_steps(label, step, bf16_state(model, dev),
                          batch, MT_BATCH, wrappers, MT_LAUNCHES, MT_WARMUP, MT_TIMED,
                          torch.Generator(device=dev).manual_seed(SEED), bf16=True,
                          modes=MT_MODE_LAUNCHES)
    ok &= good
    counted_launches(wrappers, results, bf16=True)
    log(f"time MT step 512^2 batch {MT_BATCH}: bf16 {ms:.2f} ms against float32 "
        + (f"{f32_ms:.2f} ms ({f32_ms / ms:.2f}x)" if f32_ms else "not measured in this run"))
    mixed = f"{label} PDA_PALLAS_CONV_MODE=mixed"
    with conv_mode("mixed"):
        good, mixed_ms = time_steps(mixed, step, bf16_state(model, dev), batch, MT_BATCH,
                                    wrappers, MIXED_MT_LAUNCHES, MT_WARMUP, MT_TIMED,
                                    torch.Generator(device=dev).manual_seed(SEED), bf16=True,
                                    modes=MIXED_MT_MODE_LAUNCHES)
    ok &= good
    counted_launches(wrappers, results, bf16=True)
    log(f"time MT step 512^2 batch {MT_BATCH} bf16: mixed {mixed_ms:.2f} ms, peak "
        f"{STEP_PEAKS[mixed]:.2f} GiB against the default's {ms:.2f} ms, peak "
        f"{STEP_PEAKS[label]:.2f} GiB ({mixed_ms / ms:.3f}x the time, "
        f"{STEP_PEAKS[mixed] / STEP_PEAKS[label]:.3f}x the peak)")

    # 5. tiled MC-16 serving of the frame in bf16
    serve = livecell_punet(generator=torch.Generator().manual_seed(SEED), device=dev,
                           dtype=bf16).eval()
    frame_dev = frame.to(dev)
    eps_tiled = torch.randn(MC, 4, 6, generator=gen).to(dev)
    reset_launches(wrappers)
    probs = tiled_punet_probs(serve, frame_dev, eps_tiled, MC, BLOCK, HALO)
    torch.cuda.synchronize()
    on, routes = all_on_wgmma(wrappers)
    counts = counted_launches(wrappers, results, bf16=True)
    want = {"conv_block_fwd": 8, "conv_block_fwd_dual": 3, "mc_consensus": 1,
            "conv_block_bwd": 0, "conv_block_bwd_dual": 0}
    good = (counts == want and on and probs.dtype == torch.float32
            and tuple(probs.shape) == (*FRAME, 1)
            and bool(torch.isfinite(probs).all()) and 0.0 <= float(probs.min())
            and float(probs.max()) <= 1.0)
    torch.cuda.reset_peak_memory_stats()
    tiled_ms = cuda_ms(lambda: tiled_punet_probs(serve, frame_dev, eps_tiled, MC, BLOCK, HALO),
                       warmup=1, iters=5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"bf16 serving tiled_punet_probs MC-{MC} 520x704: float32 probabilities in "
        f"[{float(probs.min()):.4f}, {float(probs.max()):.4f}], launches {counts} (expected "
        f"{want}), on the wgmma body {routes} {'ok' if good else 'FAIL'}")
    log(f"time tiled_punet_probs MC-{MC} 520x704 bf16 (4 tiles of 512^2): {tiled_ms:.2f} ms/frame, "
        f"{4000.0 / tiled_ms:.2f} tiles/s, peak {peak:.2f} GiB")
    ok &= good
    del serve, probs

    # 6. Trainer(mixed_precision=True): bf16 compute, float32 parameters and checkpoints
    with tempfile.TemporaryDirectory() as root:
        tr = livecell_mt_trainer(root, device=dev, patch=MT_CHECK_PATCH,
                                 steps_per_epoch=BF16_FIT_STEPS, num_workers=0, logger=False,
                                 mixed_precision=True)
        tr.fit(BF16_FIT_STEPS)
        torch.cuda.synchronize()
        with torch.no_grad():
            feats = tr.state.model.encode(batch[1][:, :MT_CHECK_PATCH, :MT_CHECK_PATCH]).features
        saved = load_checkpoint(tr.ckpt_dir, which=LATEST)
        fresh = livecell_mt_trainer(root, device=dev, patch=MT_CHECK_PATCH,
                                    steps_per_epoch=BF16_FIT_STEPS, num_workers=0, logger=False,
                                    mixed_precision=True)
        fresh.load_checkpoint(LATEST)
        same = all(torch.equal(v, w) for v, w in zip(tr.state.model.state_dict().values(),
                                                     fresh.state.model.state_dict().values()))
        f32 = all(v.dtype == torch.float32 for v in saved["model_state"].values()
                  if v.is_floating_point())
        good = (tr.model.dtype == bf16 and feats.dtype == bf16 and f32 and same
                and tr._iteration == BF16_FIT_STEPS
                and all(math.isfinite(h["loss"]) for _, h in tr.history))
        log(f"bf16 Trainer(mixed_precision=True) MeanTeacherTrainer.fit({BF16_FIT_STEPS}) "
            f"{MT_CHECK_PATCH}^2: model dtype {tr.model.dtype}, activations {feats.dtype}, "
            f"losses {[round(h['loss'], 5) for _, h in tr.history]}, latest.pt float32 {f32}, "
            f"reloaded bit-equal {same} {'ok' if good else 'FAIL'}")
        ok &= good
        del tr, fresh
    return ok


PAR_WARMUP, PAR_TIMED = 1, 3


def same_bits(a, b):
    """Bit-equal student (parameters and gradients) and teacher of two MT
    train states."""
    import torch

    pairs = [*zip(a.model.parameters(), b.model.parameters()),
             *zip(a.teacher.parameters(), b.teacher.parameters())]
    return (all(torch.equal(p, q) for p, q in pairs)
            and all((p.grad is None and q.grad is None) or torch.equal(p.grad, q.grad)
                    for p, q in zip(a.model.parameters(), b.model.parameters())))


def max_param_diff(a, b):
    return max(float((p.detach() - q.detach()).abs().max())
               for p, q in zip(a.model.parameters(), b.model.parameters()))


@contextlib.contextmanager
def matrix_upsample():
    """The float32 align-corners upsample as two contractions with the
    interpolation matrices (as the bf16 path computes it) while the block
    runs: F.interpolate's CUDA backward adds with atomics, so two runs of
    one step differ in their last bits, and only a deterministic backward
    lets two legs be held bit for bit."""
    import torch

    from pda_torch.models import blocks

    plain = blocks.upsample_2x_align_corners

    def upsample(x):
        if x.dtype == torch.bfloat16:
            return plain(x)
        _, h, w, _ = x.shape
        wh = blocks._upsample_matrix(h).to(x.device, x.dtype)
        ww = blocks._upsample_matrix(w).to(x.device, x.dtype)
        x = torch.einsum("Hh,bhwc->bHwc", wh, x)
        return torch.einsum("Ww,bhwc->bhWc", ww, x).contiguous()

    blocks.upsample_2x_align_corners = upsample
    try:
        yield
    finally:
        blocks.upsample_2x_align_corners = plain


def time_legs(label, legs, batch, wrappers, dev, bf16):
    """Train steps of each leg ({name: (step, state)}) in turns, PAR_WARMUP
    then PAR_TIMED rounds, so that a drift of the host's speed falls on every
    leg alike (the bf16 step is host-bound); CUDA events around each step.
    Returns (ok, {name: median ms}): every loss finite, each kernel launched
    MT_LAUNCHES (and MT_MODE_LAUNCHES) times a step of each leg, bf16 on the
    wgmma bodies."""
    import torch

    from pda_torch.tools.ab import read_launches, reset_launches

    gens = {name: torch.Generator(device=dev).manual_seed(SEED) for name in legs}
    events = {name: [] for name in legs}
    losses = []
    n = PAR_WARMUP + PAR_TIMED
    reset_launches(wrappers)
    torch.cuda.synchronize()
    for _ in range(n):
        for name, (step, state) in legs.items():
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            _, aux = step(state, *batch, generator=gens[name])
            end.record()
            losses.append(aux["loss"])
            events[name].append((start, end))
    torch.cuda.synchronize()
    ms = {name: statistics.median(s.elapsed_time(e) for s, e in ev[PAR_WARMUP:])
          for name, ev in events.items()}
    k = n * len(legs)
    counts = read_launches(wrappers, bf16)
    modes = mode_launches(wrappers, bf16)
    good = (bool(torch.isfinite(torch.stack(losses)).all())
            and counts == {name: k * v for name, v in MT_LAUNCHES.items()}
            and modes == {name: k * v for name, v in MT_MODE_LAUNCHES.items()}
            and all(state.step == n for _, state in legs.values()))
    if bf16:
        good &= all_on_wgmma(wrappers)[0]
    log(f"training {label}, legs in turns ({PAR_TIMED} timed after {PAR_WARMUP}): "
        + ", ".join(f"{name} {v:.2f} ms/step" for name, v in ms.items())
        + f"; launches {counts}, by backward mode {modes} over {k} steps "
        + ("ok" if good else "FAIL"))
    return good, ms


def phase_parallel(dev, results):
    """pda's data mesh (pda_torch.parallel) at a world of 1 in this process:
    NCCL on the card, a HashStore. The flagship MT step at 512^2, batch 2,
    float32 and bf16, and the tiled MC-16 frame, each run from one state,
    batch and noise without a mesh and with one: the sharded run bit-equal
    (an all-reduce over one rank returns its input, and the losses'
    value-global terms add 0; the steps under matrix_upsample, whose
    backward is deterministic, and F.interpolate's two runs logged beside),
    every kernel launched on the sharded path (the bf16 ones on the wgmma
    bodies), both legs timed on fresh states in turns (time_legs), and the
    gradient bucket's all-reduce alone."""
    import torch

    from pda_torch.infer import tiled_punet_probs
    from pda_torch.models.punet import livecell_punet
    from pda_torch.parallel import get_mesh
    from pda_torch.tools.ab import kernel_wrappers, reset_launches
    from pda_torch.tools.workload import cuda_ms
    from pda_torch.train import make_mean_teacher_step

    wrappers = kernel_wrappers()
    gen = torch.Generator().manual_seed(SEED + 7)
    frame = synthetic_frame(gen, FRAME, "cpu")
    seconds = {}
    t0 = time.perf_counter()

    def lap(part):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[part] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()

    refs = {}
    mesh = get_mesh(1, device=dev)
    mesh.barrier()  # NCCL sets its communicator up at the first collective
    ok = mesh.world == 1 and mesh.backend == "nccl" and mesh.device == dev
    log(f"parallel mesh: {mesh} {'ok' if ok else 'FAIL'}")
    lap("mesh")
    try:
        f32_model = livecell_punet(consensus_masking=True, device="cpu",
                                   generator=torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            f32_model.fcomb.last_layer.weight.mul_(LAST_SCALE)
        lap("model")
        for dtype in ("f32", "bf16"):
            bf16 = dtype == "bf16"
            model = copy.deepcopy(f32_model)
            model.dtype = torch.bfloat16 if bf16 else torch.float32
            # a partial run (--phases) has no bf16 entries: count into a scratch line
            sink = (results if not bf16 or bf16_name("conv_block_fwd") in results
                    else collections.defaultdict(lambda: {"launches": 0}))
            batch = mt_batch(gen, frame, MT_TIME_PATCH, dev)
            noise = {"eps_teacher": torch.randn(MC, MT_BATCH, 6, generator=gen).to(dev),
                     "eps_post": torch.randn(MT_BATCH, 6, generator=gen).to(dev)}
            kw = dict(momentum=MT_MOMENTUM, do_consensus_masking=True)
            step, mstep = make_mean_teacher_step(**kw), make_mean_teacher_step(mesh=mesh, **kw)
            with matrix_upsample():
                plain, sharded = bf16_state(model, dev), bf16_state(model, dev)
                _, aux = step(plain, *batch, **noise)
                reset_launches(wrappers)
                _, maux = mstep(sharded, *batch, **noise)
                torch.cuda.synchronize()
            counts = counted_launches(wrappers, sink, bf16)
            modes = mode_launches(wrappers, bf16)
            good = counts == MT_LAUNCHES and modes == MT_MODE_LAUNCHES
            routes = ""
            if bf16:
                on, got = all_on_wgmma(wrappers)
                good &= on
                routes = f", on the wgmma bodies {got}"
            equal = (all(float(aux[k]) == float(maux[k]) for k in aux)
                     and same_bits(plain, sharded))
            log(f"parallel MT step 512^2 batch {MT_BATCH} {dtype} world 1: loss "
                f"{float(maux['loss']):.6f} (no mesh {float(aux['loss']):.6f}), bit-equal "
                f"{equal} (max param diff {max_param_diff(plain, sharded):.3e}); launches "
                f"{counts}, by backward mode {modes}{routes} "
                f"{'ok' if good and equal else 'FAIL'}")
            ok &= good and equal
            refs[dtype] = (model, batch, noise, plain, aux)  # the (1, 1) mesh's reference
            del sharded
            lap(f"{dtype} check")
            if not bf16:  # the reason for matrix_upsample: F.interpolate's two runs
                one, two = bf16_state(model, dev), bf16_state(model, dev)
                step(one, *batch, **noise)
                step(two, *batch, **noise)
                log(f"parallel MT step 512^2 f32 without a mesh, twice on F.interpolate's "
                    f"backward: bit-equal {same_bits(one, two)}, max param diff "
                    f"{max_param_diff(one, two):.3e}")
                del one, two
                lap("f32 F.interpolate twice")
            label = f"MT step MC-{MC} 512^2 batch {MT_BATCH} {dtype}"
            legs = {"no mesh": (step, bf16_state(model, dev)),
                    "mesh data=1": (mstep, bf16_state(model, dev))}
            good, ms = time_legs(label, legs, batch, wrappers, dev, bf16)
            sharded = legs["mesh data=1"][1]
            flat = torch.cat([p.grad.reshape(-1) for p in sharded.model.parameters()
                              if p.grad is not None])
            ar_ms = cuda_ms(lambda: mesh.all_reduce_(flat), warmup=1, iters=5)
            log(f"time parallel {label}: {ms['mesh data=1']:.2f} ms/step on the mesh against "
                f"{ms['no mesh']:.2f} without ({ms['mesh data=1'] - ms['no mesh']:+.2f} ms); the "
                f"gradient bucket's all-reduce ({flat.numel()} float32, "
                f"{flat.numel() * 4 / 2**20:.1f} MiB) {ar_ms:.3f} ms")
            ok &= good
            del legs, sharded, flat
            lap(f"{dtype} timed")

        model = copy.deepcopy(f32_model).to(dev).eval()
        image = frame.to(dev)
        eps = torch.randn(MC, 4, 6, generator=gen).to(dev)
        expect = {"conv_block_fwd": 8, "conv_block_fwd_dual": 3, "mc_consensus": 1}
        probs = tiled_punet_probs(model, image, eps, MC, BLOCK, HALO)
        reset_launches(wrappers)
        mprobs = tiled_punet_probs(model, image, eps, MC, BLOCK, HALO, mesh=mesh)
        torch.cuda.synchronize()
        counts = {k: n for k, n in counted_launches(wrappers, results).items() if k in expect}
        equal = torch.equal(probs, mprobs)
        good = counts == expect and equal
        log(f"parallel tiled_punet_probs MC-{MC} 520x704 world 1: bit-equal {equal}, launches "
            f"{counts} (expected {expect}) {'ok' if good else 'FAIL'}")
        ok &= good
        ms = cuda_ms(lambda: tiled_punet_probs(model, image, eps, MC, BLOCK, HALO), warmup=1,
                     iters=PAR_TIMED)
        mesh_ms = cuda_ms(lambda: tiled_punet_probs(model, image, eps, MC, BLOCK, HALO,
                                                    mesh=mesh), warmup=1, iters=PAR_TIMED)
        log(f"time parallel tiled_punet_probs MC-{MC} 520x704: {mesh_ms:.2f} ms/frame on the "
            f"mesh against {ms:.2f} without ({mesh_ms - ms:+.2f} ms)")
        lap("tiles")
        mesh.destroy()  # one mesh a process: the (data, space) mesh's turn
        ok &= check_mesh_2d(dev, results, wrappers, refs)
        refs.clear()
        lap("2-D mesh")
        ok &= check_row_shards(dev, wrappers)
        lap("row shards")
    finally:
        mesh.destroy()
    log(f"parallel seconds by part: {seconds}")
    return ok


#: the row-shard check's routes at 2 x 512^2: (name, x (B, H, W, C), the
#: skip's channels (dual) or 0, C out, pool_out, mixed): the deepest single
#: block, the backbone's and the posterior's level-0 pooled blocks, the top
#: decoder block, and the deepest block in the mixed mode
ROW_SHARD_ROUTES = (("single", (2, 64, 64, 256), 0, 512, None, False),
                    ("with", (2, 512, 512, 1), 0, 64, "with", False),
                    ("only", (2, 512, 512, 2), 0, 64, "only", False),
                    ("dual", (2, 512, 512, 128), 64, 64, None, False),
                    ("mixed", (2, 64, 64, 256), 0, 512, None, True))
#: the row shards' outputs against the whole image's launch, as a share of
#: the whole's largest |value|: forward outputs and K3's maps (each pixel's
#: sums in one order whatever the rows around it), the input gradients
#: (two shards' partial sums added at a seam) and the weights' gradients
#: (their sums split over the shards); bf16: both gradients rounded to bf16
#: after sums split otherwise, two ulps of the largest; the mixed route's
#: outputs (cuDNN's forward) take the input gradients' bound, and its
#: recompute backward runs from the whole image's h3 rows
ROW_SHARD_BOUNDS = {"float32": {"out": 0.0, "dx": 4e-6, "dw": 1e-5},
                    "bfloat16": {"out": 0.0, "dx": 2.0 ** -7, "dw": 2.0 ** -7}}


def check_row_shards(dev, wrappers):
    """The row-sharded block's local function (conv_block_rows) on the card:
    for 2 and 4 row shards of each ROW_SHARD_ROUTES shape, every shard's
    rows extended by HALO rows on each inner side (sliced from the whole
    tensor, as the halo exchange delivers them), forward and backward
    against the whole image's launch of the same route, float32 and bf16;
    then the mc_consensus tail on row shards of a 2 x 512^2 feature term.
    Launches counted (a check's: logged only), every route's kernels and
    modes launched, bf16 on the wgmma bodies. Returns ok."""
    import torch

    from pda_torch.kernels.conv_block import conv_block_bwd
    from pda_torch.kernels.mc_consensus import mc_consensus
    from pda_torch.models.blocks import HALO, conv_block_rows
    from pda_torch.tools.ab import read_launches, reset_launches

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        bounds = ROW_SHARD_BOUNDS[str(dtype).split(".")[1]]
        bf16 = dtype == torch.bfloat16
        reset_launches(wrappers)
        worst = {"out": 0.0, "dx": 0.0, "dw": 0.0}
        for name, shape, cb, cout, pool_out, mixed in ROW_SHARD_ROUTES:
            b, h, w, cin = shape
            weights = []
            for ci in (cin + cb, cout, cout):
                weights += [torch.randn(3, 3, ci, cout, generator=gen, device=dev)
                            * (2.0 / (9 * ci)) ** 0.5,
                            1e-3 * torch.randn(cout, generator=gen, device=dev)]
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            xb = (torch.randn(b, h, w, cb, generator=gen, device=dev).to(dtype) if cb
                  else None)
            cots = [torch.randn(b, h, w, cout, generator=gen, device=dev)]
            if pool_out:
                cots = ([] if pool_out == "only" else cots) + [
                    torch.randn(b, h // 2, w // 2, cout, generator=gen, device=dev)]

            # the entry blocks (Cin 1, 2) read the network's input, whose
            # gradient the main path never asks for (their dx is off the wgmma
            # route); every other block's input gradient is held
            need_dx = cin >= 8

            def run(rows, top, bottom):
                """conv_block_rows on the rows ``rows`` extended by ``top``,
                ``bottom``: its outputs, and the gradients of the inputs (on
                the extended rows; none for an entry block) and the weights."""
                xs = [t[:, rows.start - top:rows.stop + bottom].detach().clone()
                      .requires_grad_(need_dx) for t in (x, xb) if t is not None]
                ws = [t.detach().clone().requires_grad_() for t in weights]
                out = conv_block_rows(xs[0], ws, top, bottom, xb=xs[1] if cb else None,
                                      pool_out=pool_out, mixed=mixed)
                outs = list(out) if isinstance(out, tuple) else [out]
                loss = sum((o.float() * c[:, rows.start // k:rows.stop // k]).sum()
                           for o, c in zip(outs, cots) for k in [h // c.shape[1]])
                if not mixed:
                    loss.backward()
                    return ([o.detach().float() for o in outs],
                            [t.grad.float() for t in xs if need_dx], [t.grad for t in ws])
                # the mixed forward is cuDNN's (pda's XLA convs), whose algorithm, and so
                # its last bits, may change with the rows: hold the recompute backward on
                # the extended rows from the whole image's h3 (and its ReLU mask)
                sl = slice(rows.start - top, rows.stop + bottom)
                h3 = whole_h3[:, sl].contiguous()
                g = torch.zeros_like(h3)
                g[:, top:top + rows.stop - rows.start] = cots[0][:, rows].to(dtype)
                dx, *dw = conv_block_bwd(g, xs[0].detach(), None, None, h3, *weights[0::2],
                                         need_dx=True, b1=weights[1], b2=weights[3])
                return [o.detach().float() for o in outs], [dx.float()], dw

            whole_h3 = (conv_block_rows(x, weights, 0, 0, mixed=True).detach() if mixed
                        else None)
            whole_out, whole_dx, whole_dw = run(slice(0, h), 0, 0)
            for m in (2, 4):
                rows_m = h // m
                outs, dws = [[] for _ in whole_out], None
                dxs = [torch.zeros_like(d) for d in whole_dx]
                for s in range(m):
                    top, bottom = (HALO if s > 0 else 0), (HALO if s < m - 1 else 0)
                    rows = slice(s * rows_m, (s + 1) * rows_m)
                    out, dx, dw = run(rows, top, bottom)
                    for i, o in enumerate(out):
                        outs[i].append(o)
                    for acc, d in zip(dxs, dx):
                        acc[:, rows.start - top:rows.stop + bottom] += d
                    dws = dw if dws is None else [a + c for a, c in zip(dws, dw)]
                errs = {"out": max(float((torch.cat(o, 1) - r).abs().max())
                                   / max(float(r.abs().max()), 1e-30)
                                   for o, r in zip(outs, whole_out)),
                        "dx": max((float((d - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                                   for d, r in zip(dxs, whole_dx)), default=0.0),
                        "dw": max(float((d - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                                  for d, r in zip(dws, whole_dw))}
                # the mixed forward, cuDNN's, within an ulp (the gradients' bound)
                good = all(errs[k] <= bounds["dx" if mixed and k == "out" else k] for k in errs)
                worst = {k: max(worst[k], errs[k]) for k in worst}
                log(f"parallel row shards {name} {tuple(shape)} x{m} {str(dtype)[6:]}: out "
                    f"{errs['out']:.2e}, dx {errs['dx']:.2e}, dW/db {errs['dw']:.2e} of the "
                    f"largest (bounds {bounds}) {'ok' if good else 'FAIL'}")
                ok &= good
        # the MC tail on row shards: a per-pixel op, each shard's rows alone
        feat = torch.randn(2, 512, 512, 64, generator=gen, device=dev).to(dtype)
        z = torch.randn(MC, 2, 64, generator=gen, device=dev)
        tail = (0.2 * torch.randn(1, 64, 64, generator=gen, device=dev),
                0.1 * torch.randn(1, 64, generator=gen, device=dev),
                0.5 * torch.randn(64, 1, generator=gen, device=dev),
                torch.zeros(1, device=dev))
        with torch.no_grad():
            whole = mc_consensus(feat, z, *tail, masking=True)
            for m in (2, 4):
                parts = [mc_consensus(feat[:, s * 512 // m:(s + 1) * 512 // m].contiguous(), z,
                                      *tail, masking=True) for s in range(m)]
                same = all(torch.equal(torch.cat([p[i] for p in parts], 1), whole[i])
                           for i in range(2))
                log(f"parallel row shards mc_consensus 2x512^2x64 x{m} {str(dtype)[6:]}: "
                    f"pseudo and consensus bit-equal {same} {'ok' if same else 'FAIL'}")
                ok &= same
        counts = read_launches(wrappers, bf16)
        modes = mode_launches(wrappers, bf16)
        good = (all(counts.values()) and modes["conv_block_bwd_pool"] > 0
                and modes["conv_block_bwd_recompute"] > 0)
        routes = ""
        if bf16:
            on, got = all_on_wgmma(wrappers)
            good &= on
            routes = f", on the wgmma bodies {got}"
        log(f"parallel row shards {str(dtype)[6:]}: worst {worst}; launches {counts}, by "
            f"backward mode {modes}{routes} {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def check_mesh_2d(dev, results, wrappers, refs):
    """A (1, 1) (data, space) mesh in this process (NCCL, a HashStore; its
    data and space groups of one rank, each set up by an all-reduce): the
    flagship MT step at 512^2, batch 2, float32 and bf16, on the mesh from
    the state, batch and noise of the data mesh's check, whose step without
    a mesh (``refs``: dtype -> (model, batch, noise, state after, aux)) it is
    held against, under matrix_upsample as that was: bit-equal (loss, every
    parameter, gradient and teacher tensor); every kernel launched on the
    mesh's step (counted in the JSON line: a main path's run), bf16 on the
    wgmma bodies. Returns ok."""
    import torch

    from pda_torch.parallel import get_mesh_2d
    from pda_torch.tools.ab import reset_launches
    from pda_torch.train import make_mean_teacher_step

    mesh = get_mesh_2d(1, 1, device=dev)
    ok = (mesh.shape == {"data": 1, "space": 1} and mesh.backend == "nccl"
          and mesh.space.world == mesh.axis("data").world == 1)
    log(f"parallel 2-D mesh: {mesh}, space group {mesh.space.ranks}, data group "
        f"{mesh.axis('data').ranks} {'ok' if ok else 'FAIL'}")
    try:
        for dtype, (model, batch, noise, plain, aux) in refs.items():
            bf16 = dtype == "bf16"
            sink = (results if not bf16 or bf16_name("conv_block_fwd") in results
                    else collections.defaultdict(lambda: {"launches": 0}))
            mstep = make_mean_teacher_step(momentum=MT_MOMENTUM, do_consensus_masking=True,
                                           mesh=mesh)
            with matrix_upsample():
                sharded = bf16_state(model, dev)
                reset_launches(wrappers)
                _, maux = mstep(sharded, *batch, **noise)
                torch.cuda.synchronize()
            counts = counted_launches(wrappers, sink, bf16)
            modes = mode_launches(wrappers, bf16)
            good = counts == MT_LAUNCHES and modes == MT_MODE_LAUNCHES
            if bf16:
                good &= all_on_wgmma(wrappers)[0]
            equal = (all(float(aux[k]) == float(maux[k]) for k in aux)
                     and same_bits(plain, sharded))
            log(f"parallel MT step {MT_TIME_PATCH}^2 batch {MT_BATCH} {dtype} on the (1, 1) "
                f"mesh: loss {float(maux['loss']):.6f} (no mesh {float(aux['loss']):.6f}), "
                f"bit-equal {equal} (max param diff {max_param_diff(plain, sharded):.3e}); "
                f"launches {counts}, by backward mode {modes} "
                f"{'ok' if good and equal else 'FAIL'}")
            ok &= good and equal
            del sharded
    finally:
        mesh.destroy()
    return ok


def unet_conv64(h, conv):
    """A bf16 UNet2d conv (``pda_torch.models.unet._conv_bf16``) with its
    sums in float64: bf16 operands, the sum rounded to bf16, then the bf16
    bias added in bf16."""
    import torch
    import torch.nn.functional as F

    y = F.conv2d(h.to(torch.bfloat16).double(), conv.weight.to(torch.bfloat16).double(), None,
                 padding=conv.padding).to(torch.bfloat16)
    return y + conv.bias.to(torch.bfloat16).view(1, -1, 1, 1)


def unet_layer64(name, h, rest):
    """A bf16 UNet2d rounding layer (UNET_BF16_LAYERS) on ``h`` in float64
    sums, rounded where the layer rounds."""
    import torch
    import torch.nn.functional as F

    hd = h.double()
    if name == "_norm_bf16":
        mean = hd.mean(dim=(2, 3), keepdim=True)
        var = ((hd * hd).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp(min=0.0)
        return ((hd - mean) * torch.rsqrt(var + 1e-5)).to(torch.bfloat16)
    if name == "_upsample_bf16":
        return F.interpolate(hd, scale_factor=2, mode="bilinear",
                             align_corners=False).to(torch.bfloat16)
    return unet_conv64(h, rest[0])


def unet_bf16_layers(label, model, x):
    """A bf16 UNet2d's forward on the card, each rounding layer
    (UNET_BF16_LAYERS) recorded and recomputed from the card's own bf16 input
    to it in float64 sums (:func:`unet_layer64`; cuDNN off, so cuBLAS), held
    by :func:`bf16_agree` (a conv's tolerance one ulp of its output plus one
    of its sum before the bias add). Logs under ``label`` (and a failing
    layer's farthest element); returns ok."""
    import torch

    from pda_torch.models import unet as mu

    layers = {name: getattr(mu, name) for name in UNET_BF16_LAYERS}
    ok, worst, err, count = True, (0, 1.0, 0.0), 0.0, {}

    def recording(name):
        def layer(h, *rest):
            nonlocal ok, worst, err
            out = layers[name](h, *rest)
            with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
                ref = unet_layer64(name, h, rest)
            first = (None if name != "_conv_bf16" else
                     out.double() - rest[0].bias.to(torch.bfloat16).double().view(1, -1, 1, 1))
            good, n_beyond, equal, rel = bf16_agree(out, ref, first)
            ok &= good and out.dtype == torch.bfloat16
            worst = (max(worst[0], n_beyond), min(worst[1], equal), max(worst[2], rel))
            err = max(err, float((out.double() - ref.double()).abs().max()))
            count[name] = count.get(name, 0) + 1
            if not good:
                d = (out.double() - ref.double()).abs()
                tol = bf16_ulp(torch.maximum(out.double().abs(), ref.double().abs()))
                if first is not None:
                    tol = tol + bf16_ulp(first.double().abs())
                i = int((d / tol).argmax())
                at = ("" if first is None else
                      f", its sum before the bias {float(first.flatten()[i]):.6e}")
                log(f"{label} layer {name} #{count[name]} {tuple(out.shape)}: {n_beyond} elements "
                    f"beyond the ulp rule, bit-equal {equal:.5f}; the farthest at {i}: "
                    f"{float(out.flatten()[i]):.6e} against {float(ref.flatten()[i]):.6e}{at}")
            return out
        return layer

    t0 = time.perf_counter()
    for name in layers:
        setattr(mu, name, recording(name))
    try:
        with torch.no_grad():
            probs = model(x)
        torch.cuda.synchronize()
    finally:
        for name, fn in layers.items():
            setattr(mu, name, fn)
    ok &= probs.dtype == torch.float32 and bool(torch.isfinite(probs).all())
    log(f"{label} forward layer by layer on the card against float64 sums (each from the "
        f"card's own bf16 input; layers {count}; {time.perf_counter() - t0:.1f} s): most elements "
        f"beyond the ulp rule {worst[0]}, least bit-equal share {worst[1]:.5f} (tol "
        f"{BF16_BIT_EQUAL}), largest relative difference {worst[2]:.2e}, max_abs_err {err:.3e}; "
        f"float32 probabilities {probs.dtype == torch.float32} {'ok' if ok else 'FAIL'}")
    return ok


def check_unet_bf16(dev):
    """A bf16 UNet2d on the card: each rounding layer of its forward from
    the card's own input to it against float64 sums, then one supervised
    step against the CPU's (UNET_BF16_*). Returns ok."""
    import torch

    from pda_torch.models import UNet2d
    from pda_torch.models import unet as mu
    from pda_torch.tools.ab import PDA_BOUNDS
    from pda_torch.train import adam, create_train_state, make_supervised_unet_step

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 17)
    unet = UNet2d(depth=UNET_BF16_DEPTH, initial_features=UNET_BF16_FEATURES,
                  final_activation="sigmoid", generator=torch.Generator().manual_seed(SEED),
                  dtype=bf16)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    p = UNET_BF16_PATCH
    x = torch.randn(UNET_BF16_BATCH, p, p, 1, generator=gen)
    gt = (x > 0.5).float()
    label = (f"algorithms bf16 UNet2d(depth {UNET_BF16_DEPTH}, {UNET_BF16_FEATURES}) {p}^2 batch "
             f"{UNET_BF16_BATCH}")
    ok = unet_bf16_layers(label, copy.deepcopy(unet).to(dev), x.to(dev))

    # one supervised step on the card and on the CPU, the CPU's convs summing
    # in float64
    step = make_supervised_unet_step()
    runs, conv_bf16 = {}, mu._conv_bf16
    for name, device in (("card", dev), ("cpu", "cpu")):
        m = copy.deepcopy(unet).to(device)
        state = create_train_state(m, adam(m.parameters(), UNET_LR))
        if device == "cpu":
            mu._conv_bf16 = unet_conv64
        try:
            _, aux = step(state, x.to(device), gt.to(device))
        finally:
            mu._conv_bf16 = conv_bf16
        runs[name] = (state, aux)
    card, cpu = runs["card"][0], runs["cpu"][0]
    u = torch.cat([q.grad.double().flatten().cpu() for q in card.model.parameters()])
    v = torch.cat([q.grad.double().flatten() for q in cpu.model.parameters()])
    loss, loss_cpu = float(runs["card"][1]["loss"]), float(runs["cpu"][1]["loss"])
    loss_rel, cos = abs(loss - loss_cpu) / abs(loss_cpu), 1.0 - float(u @ v / (u.norm() * v.norm()))
    tol = PDA_BOUNDS["bf16"]
    f32 = all(q.dtype == q.grad.dtype == torch.float32 for q in card.model.parameters())
    good = loss_rel <= tol["loss"] and cos <= tol["cos"] and f32 and card.model.dtype == bf16
    log(f"{label} supervised step card vs cpu (its convs' sums in float64): loss {loss:.6f} vs "
        f"{loss_cpu:.6f}, relative difference {loss_rel:.2e} (tol {tol['loss']:.0e}); gradients' "
        f"cosine 1 - {cos:.2e} (tol {tol['cos']:.0e}; pda's bf16 A/B bounds); float32 "
        f"parameters and gradients {f32}; the check {time.perf_counter() - t0:.1f} s "
        f"{'ok' if good else 'FAIL'}")
    return ok and good


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
    from pda_torch.tools.ab import kernel_wrappers, read_launches, reset_launches
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
        batch = batch_of(algo, ALG_STEP_CHECK_PATCH, "cpu")
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
        log(f"algorithms {algo} step {ALG_STEP_CHECK_PATCH}^2: launches {counts} (expected "
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
        log(f"algorithms {algo} step {ALG_STEP_CHECK_PATCH}^2: ReLU masks of the student's "
            f"{len(cpu_blocks)} ConvBlocks card vs cpu: {flips} px differ, each output within "
            f"{margin:.1e} of 0 (relative to its map's largest)")
        del card_blocks, cpu_blocks
        good &= check_step(f"algorithms {algo} step {ALG_STEP_CHECK_PATCH}^2", card, cpu, aux,
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

    def unet_state(device, dtype=torch.float32, compute=torch.float32):
        m = copy.deepcopy(unet).to(device=device, dtype=dtype)
        m.dtype = compute
        return create_train_state(m, adam(m.parameters(), UNET_LR))

    ok &= check_unet_bf16(dev)

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
    unet_ms = {}
    for name, (step, batch) in unet_steps.items():
        good, unet_ms[name] = time_steps(f"{name} step {p}^2 batch {UNET_BATCH} f32", step,
                                         unet_state(dev), tuple(a.to(dev) for a in batch),
                                         UNET_BATCH, wrappers, NO_LAUNCHES, ALG_WARMUP, ALG_TIMED)
        ok &= good
    # the supervised step in pda's bf16 configuration (cuDNN's bf16
    # convolutions), its first forward's layers held against float64 sums
    step, batch = unet_steps["supervised_unet"]
    label = f"supervised_unet step {p}^2 batch {UNET_BATCH} bf16"
    t0 = time.perf_counter()
    state = unet_state(dev, compute=torch.bfloat16)
    ok &= unet_bf16_layers(f"algorithms bf16 UNet2d(depth 4, 64) {p}^2 batch {UNET_BATCH}",
                           state.model, batch[0].to(dev))
    good, ms = time_steps(label, step, state, tuple(a.to(dev) for a in batch), UNET_BATCH,
                          wrappers, NO_LAUNCHES, ALG_WARMUP, ALG_TIMED)
    ok &= good
    del state
    log(f"time supervised_unet step {p}^2 batch {UNET_BATCH}: bf16 {ms:.2f} ms, peak "
        f"{STEP_PEAKS[label]:.2f} GiB against float32 {unet_ms['supervised_unet']:.2f} ms "
        f"({unet_ms['supervised_unet'] / ms:.2f}x); its layer check and timing "
        f"{time.perf_counter() - t0:.1f} s")
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


def mode_launches(wrappers, bf16=False):
    """The backward modes' launches since :func:`reset_launches`, by JSON
    entry (MODE_ENTRIES), of the float32 or (``bf16``) the bf16 instances."""
    suffix = "_bf16" if bf16 else ""
    return {name: getattr(wrappers[kernel], f"launches_{mode}{suffix}")
            for name, (kernel, mode) in MODE_ENTRIES.items()}


def route_launches(wrappers):
    """The bf16 forwards' and backwards' launches on the wgmma bodies since
    :func:`reset_launches`, by JSON entry (ROUTE_ENTRIES)."""
    return {name: getattr(wrappers[kernel], f"launches_{mode}_bf16")
            for name, (kernel, mode) in ROUTE_ENTRIES.items()}


def all_on_wgmma(wrappers):
    """(ok, counts): every bf16 forward and backward launch since
    :func:`reset_launches` ran on the wgmma bodies, and at least one did."""
    routes = route_launches(wrappers)
    ok = all(routes[name] == wrappers[kernel].launches_bf16
             for name, (kernel, _) in ROUTE_ENTRIES.items()) and any(routes.values())
    return ok, routes


def counted_launches(wrappers, results, bf16=False):
    """The launches since :func:`reset_launches` of a main path's run, added
    to the JSON line's counts (of the bf16 instances' entries with ``bf16``)."""
    from pda_torch.tools.ab import read_launches

    counts = read_launches(wrappers, bf16)
    for k, n in {**counts, **mode_launches(wrappers, bf16),
                 **(route_launches(wrappers) if bf16 else {})}.items():
        results[bf16_name(k) if bf16 else k]["launches"] += n
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


def adam_interval(grads, deltas, lr, betas, eps):
    """(low, high) of the total Adam update (the sum of a fit's steps) each
    element can take when step k's gradient may lie anywhere in
    ``grads[k] +- deltas[k]``: the moments m and v carried as intervals
    (v's from the squared gradient's interval), the bias-corrected update
    lr * m / (sqrt(v) + eps) bounded at the corners that bound it (it rises
    with m, and falls with v where m > 0 and rises with v where m < 0).
    Interval arithmetic ignores that m and v share one gradient, which
    Adam's own bound puts back where it matters (a gradient interval that
    holds 0 lets v's fall to 0): by Cauchy-Schwarz, |m_k| <= sqrt(v_k) *
    sqrt(sum_i a_i^2 / b_i) with m's weights a_i = (1 - b1) b1^(k-i) and v's
    b_i = (1 - b2) b2^(k-i), so a step moves an element by at most lr * R_k,
    R_k = that root * sqrt(1 - b2^k) / (1 - b1^k) (1 at step 1, 1.0014 at
    step 2 with pda's betas). Both bounds hold, so the interval is wider
    than the truth, never narrower. Float64."""
    import torch

    b1, b2 = betas
    m_lo = m_hi = v_lo = v_hi = torch.zeros_like(grads[0])
    lo_sum, hi_sum = torch.zeros_like(grads[0]), torch.zeros_like(grads[0])

    def update(m, v, c1, c2):
        return lr * (m / c1) / ((v / c2).sqrt() + eps)

    for k, (g, d) in enumerate(zip(grads, deltas), start=1):
        g_lo, g_hi = g - d, g + d
        sq_hi = torch.maximum(g_lo * g_lo, g_hi * g_hi)
        sq_lo = torch.where((g_lo <= 0) & (g_hi >= 0), 0.0, torch.minimum(g_lo * g_lo, g_hi * g_hi))
        m_lo, m_hi = b1 * m_lo + (1 - b1) * g_lo, b1 * m_hi + (1 - b1) * g_hi
        v_lo, v_hi = b2 * v_lo + (1 - b2) * sq_lo, b2 * v_hi + (1 - b2) * sq_hi
        c1, c2 = 1 - b1 ** k, 1 - b2 ** k
        most = lr * math.sqrt(sum((1 - b1) ** 2 * b1 ** (2 * (k - i)) / ((1 - b2) * b2 ** (k - i))
                                  for i in range(1, k + 1)) * c2) / c1
        hi = torch.where(m_hi > 0, update(m_hi, v_lo, c1, c2), update(m_hi, v_hi, c1, c2))
        lo = torch.where(m_lo < 0, update(m_lo, v_lo, c1, c2), update(m_lo, v_hi, c1, c2))
        hi_sum += hi.clamp(-most, most)
        lo_sum += lo.clamp(-most, most)
    return lo_sum, hi_sum


def check_fit(label, card, cpu, grads, init, lr):
    """The final student and teacher of a fit on the card against the same
    fit on the CPU, each step's gradients as :func:`check_step` judges one
    step's (within MT_GRAD_TOL of the CPU's float32 leaf, or by cosine to
    the float64 fit's). The weights: each step's gradient on the card lies
    within its leaf's measured error (the noise :func:`check_step` uses) of
    the CPU's, so each element's final value lies in the interval Adam
    (the trainer's own betas, eps and bias correction) maps those gradient
    intervals to (:func:`adam_interval`), and the teacher in the EMA of the
    student's intervals; the card's final student and teacher are held
    within that interval's half-width of its middle plus MT_PARAM_TOL (the
    CPU's, as a check of the interval, too). Where Adam's second step nearly
    cancels its first (m_2 near 0), a gradient error within the noise moves
    the update by a large part of lr: the interval follows it there."""
    import torch

    from pda_torch.tools.ab import SPREAD_FACTOR

    n_steps = len(grads["card"])
    params = list(cpu.state.model.parameters())
    deltas = [[None] * len(params) for _ in range(n_steps)]
    worst, worst_cos, n_beyond, n_bad = (0.0, ""), (1.0, "", 1.0), 0, 0
    names = [n for n, _ in card.state.model.named_parameters()]
    for k in range(n_steps):
        for i, name in enumerate(names):
            g, gc, g64 = grads["card"][k][i], grads["cpu"][k][i], grads["cpu64"][k][i]
            scale = float(gc.abs().max())
            err = float((g - gc).abs().max())
            worst = max(worst, (err / scale if scale else err, f"step {k} {name}"))
            deltas[k][i] = max(MT_GRAD_TOL * scale, err, float((g - g64).abs().max()),
                               float((gc - g64).abs().max()))
            if err > MT_GRAD_TOL * scale:
                n_beyond += 1
                cos, cos_cpu = (float(torch.nn.functional.cosine_similarity(
                    a.flatten(), g64.flatten(), dim=0)) for a in (g, gc))
                worst_cos = min(worst_cos, (cos, f"step {k} {name}", cos_cpu))
                n_bad += 1.0 - cos > max(GRAD_COS_TOL, SPREAD_FACTOR * (1.0 - cos_cpu))
    group = cpu.state.optimizer.param_groups[0]
    momentum = cpu.momentum
    student = teacher = cpu_off = 0.0
    widest = (0.0, "")
    for i, ((name, p), pc, tp, tc) in enumerate(zip(
            card.state.model.named_parameters(), params, card.state.teacher.parameters(),
            cpu.state.teacher.parameters())):
        p0 = init[name].double()
        lo, hi = adam_interval([grads["cpu"][k][i] for k in range(n_steps)],
                               [deltas[k][i] for k in range(n_steps)], lr, group["betas"],
                               group["eps"])
        # after step k the student lies in p0 - [hi_k, lo_k]; the teacher, an EMA
        # of the students from the same start, in the same EMA of those bounds
        t_lo, t_hi = p0.clone(), p0.clone()
        for k in range(1, n_steps + 1):
            lo_k, hi_k = adam_interval([grads["cpu"][j][i] for j in range(k)],
                                       [deltas[j][i] for j in range(k)], lr, group["betas"],
                                       group["eps"])
            t_lo = momentum * t_lo + (1 - momentum) * (p0 - hi_k)
            t_hi = momentum * t_hi + (1 - momentum) * (p0 - lo_k)
        mid, half = p0 - (lo + hi) / 2, (hi - lo) / 2
        t_mid, t_half = (t_lo + t_hi) / 2, (t_hi - t_lo) / 2
        student = max(student, float(((p.detach().cpu().double() - mid).abs() - half).max()))
        teacher = max(teacher, float(((tp.detach().cpu().double() - t_mid).abs() - t_half).max()))
        cpu_off = max(cpu_off, float(((pc.detach().double() - mid).abs() - half).max()),
                      float(((tc.detach().double() - t_mid).abs() - t_half).max()))
        widest = max(widest, (float(half.max()), name))
    good = (n_bad == 0 and student <= MT_PARAM_TOL and teacher <= MT_PARAM_TOL
            and cpu_off <= MT_PARAM_TOL)
    log(f"{label} card vs cpu: {n_steps} steps' gradients worst max_abs_err/max|ref| "
        f"{worst[0]:.3e} ({worst[1]}; tol {MT_GRAD_TOL:.0e}), {n_beyond} leaves beyond it, "
        f"their worst cosine to float64 {worst_cos[0]:.8f} ({worst_cos[1]}; the CPU's float32 "
        f"{worst_cos[2]:.8f}); final student beyond its Adam interval by {student:.3e}, teacher "
        f"{teacher:.3e}, the CPU's own {cpu_off:.3e} (tol {MT_PARAM_TOL:.0e}; widest half-width "
        f"{widest[0]:.3e} at {widest[1]}, lr {lr:g}) {'ok' if good else 'FAIL'}")
    return good


def small_mt_fits(root, dev, wrappers, loader_seed: int = 0):
    """The flagship's MT fit at 128^2 (2 steps, 1 validation) on the card, on
    the CPU (float32) and on the CPU in float64, each step's gradients
    recorded; the CPU fits take the card teacher's pseudo-labels, so that a
    consensus pixel flipped within the MC kernel's threshold window is no
    difference. ``loader_seed`` moves the train loader's seed. Returns the
    fits, the gradients, the pseudo-labels, the initial student, the card
    fit's launches and the CPU fits' seconds."""
    import torch

    from pda_torch.tools.ab import read_launches, reset_launches
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
        def mc_pseudo(model, x, n_samples, masking, eps=None, generator=None, mesh=None):
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
    with native.augmentation_path(native=False):  # the numpy field from the same draws
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

    from pda_torch.data.native import augmentation_path
    from pda_torch.tools import learning_smoke
    from pda_torch.tools.ab import kernel_wrappers, read_launches, reset_launches
    from pda_torch.tools.workload import livecell_mt_trainer
    from pda_torch.train import LATEST

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
        # (float32) and the CPU in float64, on the native views (the default),
        # the weights held to their Adam intervals (check_fit; every loader draw
        # of either view: pda_torch/tools/fit_check_seeds.py)
        with augmentation_path(native=True):
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

        # 4. learning: development/learning_smoke.py's run on the port, in
        # float32 (pda_torch/tools/learning_smoke.py runs it in bf16 too)
        learner = learning_smoke.learner(root, dev, batch=LEARN_BATCH, mixed_precision=False)
        reset()
        out = learning_smoke.run(learner, LEARN_ITERATIONS)
        stats, final, wall = out["stats"], out["final"], out["wall"]
        counts = read_launches(wrappers)
        n_val_steps = len(learner.val_history) * len(learner.val_loader)
        want = {"conv_block_fwd": 12 * LEARN_ITERATIONS + 20 * n_val_steps,
                "conv_block_fwd_dual": 3 * LEARN_ITERATIONS + 6 * n_val_steps,
                "mc_consensus": n_val_steps, "conv_block_bwd": 12 * LEARN_ITERATIONS,
                "conv_block_bwd_dual": 3 * LEARN_ITERATIONS}
        good = (final["dice"] > learning_smoke.BAR and counts == want
                and finite(learner.history))
        log(f"engine learning check (development/learning_smoke.py): PUNetTrainer, PUNet "
            f"{learning_smoke.FILTERS}, 64^2 batch {LEARN_BATCH}, lr {learning_smoke.LR:g} with "
            f"the plateau controller, {LEARN_ITERATIONS} iterations f32: validation dice by epoch "
            f"{[round(m['dice'], 4) for _, m in learner.val_history]}, final {final['dice']:.4f} "
            f"(bar {learning_smoke.BAR}; pda records 0.82-0.84 on its TPU in bf16, a reference "
            f"point); learning rate {learner.state.learning_rate:g}; "
            f"{stats['patches_per_sec']:.1f} patches/s (Throughput), {wall:.1f} s with the "
            f"validations; launches {counts} (expected {want}) {'ok' if good else 'FAIL'}")
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
            # the float64 references of the largest shapes (36 tiles of
            # 512^2) take tens of GiB: hand the cache of the one before back
            torch.cuda.empty_cache()
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
    from pda_torch.tools.ab import kernel_wrappers, reset_launches
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
# validation patches a validation of the DA trainers on VNC and UroCell (their
# CLIs' loaders draw 400; fewer keep the run's time for the bf16 phase)
MITO_DA_VAL_SAMPLES = 40
H5_DTYPES = ("uint8", "uint16", "int32", "float32", "float64")


def fewer_val_samples(get_dual_loaders):
    """``get_dual_loaders`` whose validation loader draws at most
    MITO_DA_VAL_SAMPLES patches (a depth cut of the smoke run)."""
    def get(*args, **kwargs):
        train, val = get_dual_loaders(*args, **kwargs)
        val.dataset._len = min(len(val.dataset), MITO_DA_VAL_SAMPLES)
        return train, val
    return get


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
    from pda_torch.tools.ab import kernel_wrappers, reset_launches
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
                em_types, loaders = mitoem_da.EM_TYPES, mitoem_common.get_dual_loaders
                mitoem_da.EM_TYPES = targets
                mitoem_common.get_dual_loaders = fewer_val_samples(loaders)
                try:
                    run(module, ["--train", "--predict", "--evaluate"] + flags, 1)
                finally:
                    mitoem_da.EM_TYPES, mitoem_common.get_dual_loaders = em_types, loaders
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
# the Lung MT step card vs CPU at 64^2 (at 128^2 its CPU side takes 9-13 s)
LUNG_CHECK_PATCH = 64


def lung_step(dev):
    """One 64^2 Mean-Teacher step of the Lung PUNet (BCE reconstruction,
    consensus masking) on the card against the same step on the CPU, in
    float32 and (the gradients' reference) float64; the CPU steps take the
    card teacher's pseudo-labels. Returns ok."""
    import numpy as np
    import torch

    from pda_torch.data.synthetic import make_lung_frame
    from pda_torch.experiments.common import lung_punet
    from pda_torch.tools.ab import kernel_wrappers, read_launches, reset_launches
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step, steps

    wrappers = kernel_wrappers()
    gen = torch.Generator().manual_seed(SEED + 7)
    model = lung_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED),
                       device="cpu")
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(LAST_SCALE)
    init = model.state_dict()
    raw, _ = make_lung_frame(LUNG_SIZE, np.random.default_rng(SEED))
    batch = mt_batch(gen, torch.from_numpy(raw)[..., None], LUNG_CHECK_PATCH, "cpu")
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
    log(f"lung MT step (BCE, masking) {LUNG_CHECK_PATCH}^2: launches {counts} (expected "
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
    ok &= check_step(f"lung MT step (BCE, masking) {LUNG_CHECK_PATCH}^2", card, cpu, aux, aux_cpu,
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
    from pda_torch.tools.ab import kernel_wrappers, reset_launches
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


PHASES = ("kernels", "serving", "training", "bf16", "parallel", "algorithms", "engine",
          "experiments", "mitoem", "lung")


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

    results = {name: {"name": name, "dtype": "float32", "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": 0.0, "ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None, "library_ms": None}
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
                    "pda/kernels/conv_block_bwd.py:502"),
                   ("conv_block_bwd_pool", "pda_torch/kernels/csrc/conv_block_bwd.cu",
                    "pda/kernels/conv_block_packed_bwd.py:501"),
                   ("conv_block_bwd_recompute", "pda_torch/kernels/csrc/conv_block_bwd.cu",
                    "pda/kernels/conv_block_bwd.py:610"),
                   ("conv_block_bwd_dual_recompute", "pda_torch/kernels/csrc/conv_block_bwd.cu",
                    "pda/kernels/conv_block_bwd.py:610"))}
    binding = {}  # (kernel, "operations" or "bytes") -> ms of bound that term sets
    ok = True
    try:
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
        t0, cpu0 = time.perf_counter(), time.process_time()

        def lap(name):
            # the process's CPU seconds (every thread's) against the wall and its
            # threads: whether a slow phase did more work, or left a thread behind
            nonlocal t0, cpu0
            torch.cuda.synchronize()
            log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
            log(f"host during {name}: this process's CPU {time.process_time() - cpu0:.1f} s, "
                f"{len(os.listdir('/proc/self/task'))} threads at its end")
            t0, cpu0 = time.perf_counter(), time.process_time()

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
            elif name == "bf16":
                ok &= phase_bf16(dev, results, binding, mt_ms)
            elif name == "parallel":
                ok &= phase_parallel(dev, results)
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
        f"bound at {PEAK_FLOPS / 1e12:.0f} TFLOP/s (3xTF32; the *_bf16 entries, pda's bf16 "
        f"configuration: 989 TFLOP/s dense bf16) and {PEAK_BYTES / 1e12:.2f} TB/s; "
        "library_ms: cuDNN's three convolutions (F.conv2d; in bf16 on bf16 tensors) for the "
        "forward, its three "
        "convolution_backward calls with the ReLU masks between them for the backward "
        "(cudnn.benchmark on at 128->256), TF32 off; none for mc_consensus (no single PyTorch "
        "call computes it); mc_consensus: the tiled forward's call; conv_block_bwd_pool: "
        "the MT step's 9 backwards that read the pooled cotangent (also in conv_block_bwd's "
        "sums and count), library_ms there after the pool's transpose (avg_pool2d_backward) "
        "and the add; conv_block_bwd[_dual]_recompute: one call at "
        "workload.RECOMPUTE[_DUAL]_SHAPE, library_ms cuDNN's first two layers then its "
        "backward; conv_block_fwd[_dual]_wgmma_bf16: the bf16 forward launches whose "
        "tensor-core layers all ran on the wgmma body (csrc/conv3x3_wgmma.cuh), with their "
        "kernel's times (every bf16 forward launch of the main paths); "
        "conv_block_bwd[_dual]_wgmma_bf16: the bf16 backward launches whose every dgrad "
        "(csrc/conv3x3_wgmma.cuh) and every wgrad but an entry layer's "
        "(csrc/wgrad_wgmma.cuh) ran on the wgmma bodies, with their kernel's times (every "
        "bf16 backward launch of the main paths); launches: the main "
        "paths' runs, each counted from 0: both serving entries, the checked MT step, the "
        "checked PDA_PALLAS_CONV_MODE=mixed step (the recompute entries' float32 count), the "
        "bf16 phase's timed MT steps (default and mixed) and tiled serving, the parallel "
        "phase's sharded MT steps (float32 and bf16) and sharded tiled frame, the "
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
