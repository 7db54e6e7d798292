"""The kernel work of the flagship PUNet's paths, in one place.

The shapes each kernel entry takes on the serving path (a tiled MC-16
forward of a 520x704 frame, 4 tiles of 512^2; the pseudo export of the same
frame, padded to 528x704) and in the Mean-Teacher step (512^2, batch 2), the
FLOPs and bytes a call needs, seeded He-scaled weights and MC-tail inputs,
and a CUDA-event timer. ``chip_smoke.py``, :mod:`.profile` and :mod:`.bench_variants` all read
them from here.
"""

from __future__ import annotations

import statistics

import torch

# (B, H, W, Cin, C): the single-input ConvBlocks of one tiled forward; each
# runs twice a forward, in the backbone and in the prior
K1_TILED = [(4, 512, 512, 1, 64), (4, 256, 256, 64, 128),
            (4, 128, 128, 128, 256), (4, 64, 64, 256, 512)]
# ... of one pseudo forward (batch 1, ragged against the 16x16 pixel tile
# but at 528x704), each run twice
K1_PSEUDO = [(1, 528, 704, 1, 64), (1, 264, 352, 64, 128),
             (1, 132, 176, 128, 256), (1, 66, 88, 256, 512)]
# the MT step's posterior entry block: image + mask
K1_POSTERIOR = (2, 512, 512, 2, 64)
# (B, H, W, Ca, Cb, C): the decoder blocks, input [upsample | skip], once a forward
K2_TILED = [(4, 128, 128, 512, 256, 256), (4, 256, 256, 256, 128, 128),
            (4, 512, 512, 128, 64, 64)]
K2_PSEUDO = [(1, 132, 176, 512, 256, 256), (1, 264, 352, 256, 128, 128),
             (1, 528, 704, 128, 64, 64)]
# The ConvBlock backwards of one MT step: ((B, H, W, Cin, C), need_dx, calls
# a step, g_mode). The entry blocks (backbone, prior: Cin 1; posterior: image
# + mask, Cin 2) take no dx; levels 1-3 run in all three nets. g_mode: the
# cotangents the block's output takes (pda's g_mode): "with" the skip's and
# the 2x2 pool's (the backbone's levels 0-2), "only" the pool's (the prior's
# and the posterior's levels 0-2), "full" its own (level 3)
BWD_SHAPES = [((2, 512, 512, 1, 64), False, 1, "with"), ((2, 512, 512, 1, 64), False, 1, "only"),
              ((2, 512, 512, 2, 64), False, 1, "only"),
              ((2, 256, 256, 64, 128), True, 1, "with"), ((2, 256, 256, 64, 128), True, 2, "only"),
              ((2, 128, 128, 128, 256), True, 1, "with"),
              ((2, 128, 128, 128, 256), True, 2, "only"),
              ((2, 64, 64, 256, 512), True, 3, "full")]
# (B, H, W, Ca, Cb, C): the decoder blocks' backward, once each a step
BWD_DUAL_SHAPES = [(2, 128, 128, 512, 256, 256), (2, 256, 256, 256, 128, 128),
                   (2, 512, 512, 128, 64, 64)]
# One backward with recompute (PDA_PALLAS_CONV_MODE=mixed) per entry: a
# backbone block of the MT step, (B, H, W, Cin, C), and its last decoder
# block, (B, H, W, Ca, Cb, C)
RECOMPUTE_SHAPE = (2, 256, 256, 64, 128)
RECOMPUTE_DUAL_SHAPE = (2, 512, 512, 128, 64, 64)
# The blocks at width 96 of development/learning_smoke.py's PUNet (16, 32,
# 64, 96) at 64^2, batch 8: the last encoder block (B, H, W, Cin, C) and the
# first decoder block (B, H, W, Ca, Cb, C), forward and backward
LEARN_BLOCK = (8, 8, 8, 64, 96)
LEARN_DUAL_BLOCK = (8, 16, 16, 96, 64, 64)


# The Lung suite's ConvBlock shapes (the flagship's widths on 256^2 patches,
# batch 2, and on single frames: a 256^2 frame, a 512^2 tile, 36 tiles of a
# 2048^2 JSRT frame; PERF.md §6, rows 1-18): the forward's (B, H, W, Cin, C)
# and (B, H, W, Ca, Cb, C), the backward's (B, H, W, Cin, C, need_dx) at
# batch 2 and its dual (B, H, W, Ca, Cb, C)
LUNG_K1 = [(b, 256 >> k, 256 >> k, cin, c)
           for k, (cin, c) in enumerate(((1, 64), (64, 128), (128, 256), (256, 512)))
           for b in (2, 1)] + [(2, 256, 256, 2, 64), (1, 256, 256, 2, 64)] + [
    (b, 512 >> k, 512 >> k, cin, c)
    for k, (cin, c) in enumerate(((1, 64), (64, 128), (128, 256), (256, 512))) for b in (1, 36)]
LUNG_K2 = [(b, s, s, ca, cb, c) for s0, ca, cb, c in ((64, 512, 256, 256), (128, 256, 128, 128),
                                                       (256, 128, 64, 64))
           for b, s in ((2, s0), (1, s0), (1, 2 * s0), (36, 2 * s0))]
LUNG_BWD = [(2, 256, 256, 1, 64, False), (2, 256, 256, 2, 64, False),
            (2, 128, 128, 64, 128, True), (2, 64, 64, 128, 256, True),
            (2, 32, 32, 256, 512, True)]
LUNG_BWD_DUAL = [(2, 64, 64, 512, 256, 256), (2, 128, 128, 256, 128, 128),
                 (2, 256, 256, 128, 64, 64)]



def wgrad_layers(blocks, duals) -> dict:
    """{(B, H, W, Ca, Cb, C): launches} of the wgrad layers of the
    single-input blocks ``blocks`` (((B, H, W, Cin, C), calls) pairs) and of
    the dual blocks ``duals`` ((B, H, W, Ca, Cb, C), once each): a block's
    first layer on its input, its layers 2 and 3 on C channels."""
    out = {}
    for (b, h, w, ca, cb, c), calls in ([((*s[:4], 0, s[4]), n) for s, n in blocks]
                                        + [(s, 1) for s in duals]):
        for shape, n in (((b, h, w, ca, cb, c), calls), ((b, h, w, c, 0, c), 2 * calls)):
            out[shape] = out.get(shape, 0) + n
    return out


# ... of one MT step (45 launches), and of the Lung suite's backward shapes
# at batch 2 (LUNG_BWD, LUNG_BWD_DUAL: each block once)
MT_WGRAD = wgrad_layers([(s, n) for s, _, n, _ in BWD_SHAPES], BWD_DUAL_SHAPES)
LUNG_WGRAD = wgrad_layers([(s[:5], 1) for s in LUNG_BWD], LUNG_BWD_DUAL)


def wgrad_flops(b, h, w, cin, c):
    """FLOPs of one layer's wgrad: 18 * Cin * Cout a pixel."""
    return 18 * b * h * w * cin * c


def wgrad_bytes(b, h, w, cin, c):
    """Bytes one float32 wgrad layer must move: its input and the cotangent
    read, dW and db written."""
    return 4 * (b * h * w * (cin + c) + 9 * cin * c + c)


# (name, (B, H, W, C), masking): the MC tail (K3, S = 16, n_mid 1) of a tiled
# forward, of the MT teacher (batch 2 of 512^2) and of a pseudo forward
K3_SHAPES = [("tiled", (4, 512, 512, 64), False), ("mt", (2, 512, 512, 64), True),
             ("pseudo", (1, 528, 704, 64), True)]
MC_SAMPLES = 16


def mc_inputs(gen, b, h, w, c, s=MC_SAMPLES, n_mid=1, dev="cpu"):
    """(feat_term, z_terms, mid_w, mid_b, last_w, last_b) of K3, seeded, with
    logits spread over both sides of the consensus band."""
    return ((torch.randn(b, h, w, c, generator=gen) * 2).to(dev),
            torch.randn(s, b, c, generator=gen).to(dev),
            (torch.randn(n_mid, c, c, generator=gen) / c ** 0.5).to(dev),
            (torch.randn(n_mid, c, generator=gen) * 0.1).to(dev),
            (torch.randn(c, 1, generator=gen) * 3 / c ** 0.5).to(dev),
            torch.randn(1, generator=gen).to(dev))


def mc_flops(b, h, w, c, s, n_mid):
    """FLOPs of K3: per pixel and sample, feature + latent term, the mid
    layers (2 C^2 + 2 C each), the last layer's dot product."""
    return b * h * w * s * (2 * c + n_mid * (2 * c * c + 2 * c) + 2 * c)


def mc_bytes(b, h, w, c, s, n_mid, feat_bytes=4):
    """Bytes K3 must move: feat (``feat_bytes`` an element: 4 in float32, 2
    in bf16), z and the float32 weights read, mean and consensus written
    (float32)."""
    return (feat_bytes * b * h * w * c
            + 4 * (2 * b * h * w + s * b * c + n_mid * (c * c + c) + c + 1))


def block_flops(b, h, w, cin, c):
    """FLOPs of one ConvBlock forward, or of its three wgrads: 18 * Cin * Cout
    a pixel and layer."""
    return 18 * b * h * w * (cin * c + 2 * c * c)


def dgrad_flops(b, h, w, cin, c, need_dx):
    """FLOPs of one ConvBlock backward's dgrads: layers 3 and 2, and layer 1
    when dx is asked for."""
    return 36 * b * h * w * c * c + (18 * b * h * w * cin * c if need_dx else 0)


def block_weight_bytes(cin, c):
    """Bytes of a ConvBlock's three kernels and biases, float32."""
    return 4 * (9 * (cin * c + 2 * c * c) + 3 * c)


# pda's bf16 configuration (bench.py's default Mean-Teacher step) is the
# flagship at these shapes with bf16 compute and float32 parameters
# (livecell_punet(dtype=torch.bfloat16), or a trainer's mixed_precision=True):
# its bytes (bf16 activations, float32 weights) and its bound against the H100
# SXM data sheet's 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# ... and the float32-accurate peak: 495 TFLOP/s TF32, three products a
# multiply-add in 3xTF32
PEAK_TF32X3_FLOPS = 495e12 / 3


def block_bytes(b, h, w, cin, c, act_bytes=2):
    """Bytes one ConvBlock forward must move: its input read and h1, h2, h3
    written (``act_bytes`` an element: 2 in bf16), the float32 weights read."""
    return act_bytes * b * h * w * (cin + 3 * c) + block_weight_bytes(cin, c)


def block_bwd_bytes(b, h, w, cin, c, need_dx, act_bytes=2, g_mode="full",
                    recompute=False):
    """Bytes one ConvBlock backward must move: x, h1, h2, h3 and the
    cotangents read (g; for ``g_mode`` "only" the pooled gp, a quarter of
    g's; for "with" both) and dx written (``act_bytes`` an element), the
    float32 weights read and dW, db written. With ``recompute`` h1 and h2 are
    not read (the biases b1, b2 are)."""
    cots = {"full": 1.0, "with": 1.25, "only": 0.25}[g_mode] * c
    acts = b * h * w * (cin * (2 if need_dx else 1) + (2 if recompute else 3) * c + cots)
    return int(act_bytes * acts) + 2 * block_weight_bytes(cin, c)


def recompute_flops(b, h, w, cin, c):
    """FLOPs of the recompute of h1 and h2 (two forward layers)."""
    return 18 * b * h * w * (cin * c + c * c)


def bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS, peak_bytes=PEAK_BYTES):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the FLOPs over ``peak_flops`` and the bytes over
    ``peak_bytes``."""
    ops_ms, bytes_ms = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bytes
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def conv_weights(gen, cin, c, dev):
    """[w1, b1, w2, b2, w3, b3]: He-scaled HWIO kernels and small biases, from
    ``gen`` on the CPU, then moved to ``dev``."""
    out = []
    for ci in (cin, c, c):
        out.append((torch.randn(3, 3, ci, c, generator=gen) * (2.0 / (9 * ci)) ** 0.5).to(dev))
        out.append((torch.randn(c, generator=gen) * 0.1).to(dev))
    return out


def cuda_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The flagship's Mean-Teacher trainer as the LIVECell MT experiment builds it
# (pda/experiments/livecell_da.py): 512^2 patches, batch 2, MC-16, consensus
# masking, Adam 1e-5, EMA 0.999, the plateau controller, the weak view recipe
# (pda_torch/experiments/common.py, pda's numpy path) for both views, on seeded
# synthetic frames of LIVECell's size
LIVECELL_FRAME = (520, 704)
FCOMB_LAST_SCALE = 8.0  # the random teacher's consensus share lies inside (0, 1)


def livecell_mt_trainer(save_root: str, *, device="cuda", patch: int = 512,
                        steps_per_epoch: int = 4, num_workers: int = 4, logger=True,
                        dtype=torch.float32, mixed_precision: bool = False):
    """``MeanTeacherTrainer`` of the flagship PUNet (seed-0 weights, the
    Fcomb's last layer x8) on 8 seeded synthetic 520x704 frames (6 to train,
    2 to validate), batch 2, epochs of ``steps_per_epoch`` steps, panels
    every 4 steps; the train loader samples in ``num_workers`` processes,
    the validation loader (one batch an epoch) inline. ``dtype``: the
    parameters' dtype (float64 for a CPU reference); ``mixed_precision``:
    the trainer's bf16 compute."""
    from ..data import DualImageCollectionDataset, Loader
    from ..data.synthetic import make_dataset_arrays
    from ..experiments.common import livecell_punet, weak_augmentations
    from ..train import MeanTeacherTrainer, ReduceLROnPlateau

    batch, seed = 2, 0
    raws, labels = make_dataset_arrays(8, LIVECELL_FRAME, seed=seed)
    weak = weak_augmentations()

    def loader(lo, hi, n, s, workers):
        ds = DualImageCollectionDataset(raws[lo:hi], labels[lo:hi], patch_shape=(patch, patch),
                                        augmentation1=weak, augmentation2=weak,
                                        n_samples=n * batch, seed=s)
        return Loader(ds, batch, seed=s, num_workers=workers)

    model = livecell_punet(consensus_masking=True, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(FCOMB_LAST_SCALE)
    return MeanTeacherTrainer("mean-teacher-livecell", model.to(dtype),
                              loader(0, 6, steps_per_epoch, seed, num_workers),
                              loader(6, 8, 1, seed + 1, 0), learning_rate=1e-5,
                              momentum=0.999, do_consensus_masking=True,
                              lr_scheduler=ReduceLROnPlateau(), logger=logger,
                              log_image_interval=4, save_root=save_root, device=device,
                              mixed_precision=mixed_precision, seed=seed)
