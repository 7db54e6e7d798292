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
  6. times    — CUDA-event medians of every kernel, its plain version and
                (ConvBlock forward and backward) cuDNN's convolutions, beside
                its bound from the shapes, with TFLOP/s; end-to-end ms/frame
                and tiles/s, MT ms/step and patches/s

Every comparison runs with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 both False), so the plain versions
compute in full float32. The last two lines of standard output are a JSON
line of per-kernel results and ``{"ok": true, "device": {...}}``; nothing of
the kind is printed when a phase fails or there is no card.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
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
# kernel launches of one MT step
MT_LAUNCHES = {"conv_block_fwd": 20, "conv_block_fwd_dual": 6, "mc_consensus": 1,
               "conv_block_bwd": 12, "conv_block_bwd_dual": 3}

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

    # every shape of the serving path and the MT step's posterior entry; the
    # JSON line's times and bounds sum one tiled forward's calls (weight 0:
    # checked and logged only)
    ok = True
    for shape, per_forward in ([(s, 2) for s in wl.K1_TILED] + [(s, 0) for s in wl.K1_PSEUDO]
                               + [(wl.K1_POSTERIOR, 0)]):
        b, h, w, cin, c = shape
        x = torch.randn(b, h, w, cin, generator=gen).to(dev)
        ok &= check_conv(k1, f"conv_block_fwd {cin}->{c} @{b}x{h}x{w}", kc.conv_block_fwd,
                         kc.conv_block_fwd_plain, (x, *conv_weights(gen, cin, c, dev)),
                         per_forward)
    for shape, per_forward in [(s, 1) for s in wl.K2_TILED] + [(s, 0) for s in wl.K2_PSEUDO]:
        b, h, w, ca, cb, c = shape
        xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
        xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
        ok &= check_conv(k2, f"conv_block_fwd_dual {ca}+{cb}->{c} @{b}x{h}x{w}",
                         kc.conv_block_fwd_dual, kc.conv_block_fwd_dual_plain,
                         (xa, xb, *conv_weights(gen, ca + cb, c, dev)), per_forward)

    for (b, h, w, cin, c), need_dx, per_step in wl.BWD_SHAPES:
        saved = saved_block(gen, b, h, w, cin, c, dev)
        ok &= check_bwd(results["conv_block_bwd"], f"conv_block_bwd {cin}->{c} @{b}x{h}x{w} "
                        f"need_dx={need_dx}", lambda *a: kc.conv_block_bwd(*a, need_dx=need_dx),
                        lambda *a: kc.conv_block_bwd_plain(*a, need_dx=need_dx), saved,
                        ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"), per_step, binding,
                        need_dx)
        del saved
    for b, h, w, ca, cb, c in wl.BWD_DUAL_SHAPES:
        g, x, *rest = saved_block(gen, b, h, w, ca + cb, c, dev)
        args = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *rest)
        del x
        ok &= check_bwd(results["conv_block_bwd_dual"], f"conv_block_bwd_dual {ca}+{cb}->{c} "
                        f"@{b}x{h}x{w}", kc.conv_block_bwd_dual, kc.conv_block_bwd_dual_plain,
                        args, ("dxa", "dxb", "dw1", "db1", "dw2", "db2", "dw3", "db3"), 1,
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


def phase_training(dev, results):
    """The Mean-Teacher step of the flagship: one step at 128^2 on the card
    against the port on the CPU, launch counts, then timed 512^2 steps."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.kernels import mc_consensus as km
    from pda_torch.models.punet import livecell_punet, mc_decode_logits
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step, steps

    wrappers = {"conv_block_fwd": kc.conv_block_fwd, "conv_block_fwd_dual": kc.conv_block_fwd_dual,
                "mc_consensus": km.mc_consensus, "conv_block_bwd": kc.conv_block_bwd,
                "conv_block_bwd_dual": kc.conv_block_bwd_dual}
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
    errs = {k: abs(float(aux[k]) - float(v)) / max(1.0, abs(float(v))) for k, v in aux_cpu.items()}
    good = all(e <= MT_LOSS_TOL for e in errs.values())
    log(f"training MT step card vs cpu: loss {float(aux['loss']):.6f} vs {float(aux_cpu['loss']):.6f}, "
        f"relative errors {', '.join(f'{k} {e:.2e}' for k, e in errs.items())} (tol "
        f"{MT_LOSS_TOL:.0e}) {'ok' if good else 'FAIL'}")
    ok &= good
    grad_worst, param_worst, sign_ok = (0.0, ""), 0.0, True
    init = model.state_dict()
    for (name, p), p_cpu in zip(card.model.named_parameters(), cpu.model.parameters()):
        g, g_cpu = p.grad.cpu(), p_cpu.grad
        scale = float(g_cpu.abs().max())
        grad_worst = max(grad_worst, (float((g - g_cpu).abs().max()) / scale, name))
        noisy = g_cpu.abs() <= MT_GRAD_TOL * scale  # there Adam's sign is noise
        diff = (p.detach().cpu() - p_cpu.detach()).abs()
        param_worst = max(param_worst, float(torch.where(noisy, 0.0, diff).max()))
        moved = (p_cpu.detach() - init[name]).abs()
        sign_ok &= float(torch.where(noisy, moved, 0.0).max()) <= MT_LR + MT_PARAM_TOL
    teacher_worst = max(float((p.cpu() - p_cpu).abs().max())
                        for p, p_cpu in zip(card.teacher.parameters(), cpu.teacher.parameters()))
    good = (grad_worst[0] <= MT_GRAD_TOL and param_worst <= MT_PARAM_TOL and sign_ok
            and teacher_worst <= MT_PARAM_TOL)
    log(f"training MT step card vs cpu: gradients worst max_abs_err/max|ref| {grad_worst[0]:.3e} "
        f"({grad_worst[1]}; tol {MT_GRAD_TOL:.0e}), updated student max_abs_err {param_worst:.3e}, "
        f"teacher {teacher_worst:.3e} (tol {MT_PARAM_TOL:.0e}); cpu {cpu_s:.1f} s "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    del card, cpu, logits, enc

    # 2. timed steps at 512^2, batch 2, fresh noise from a card generator
    state = state_on(dev)
    batch = mt_batch(gen, frame, MT_TIME_PATCH, dev)
    cuda_gen = torch.Generator(device=dev).manual_seed(SEED)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for _ in range(MT_WARMUP + MT_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, aux = step(state, *batch, generator=cuda_gen)
        end.record()
        losses.append(aux["loss"])
        events.append((start, end))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [s.elapsed_time(e) for s, e in events[MT_WARMUP:]]
    ms = statistics.median(times)
    counts = {k: w.launches for k, w in wrappers.items()}
    n = MT_WARMUP + MT_TIMED
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    good = finite and counts == {k: n * v for k, v in MT_LAUNCHES.items()} and state.step == n
    log(f"training MT step 512^2 batch {MT_BATCH}: losses {[round(float(v), 5) for v in losses]} "
        f"finite {finite}, launches {counts} over {n} steps {'ok' if good else 'FAIL'}")
    log(f"time MT step MC-{MC} 512^2 batch {MT_BATCH} f32: {ms:.2f} ms/step (median of "
        f"{MT_TIMED}, min {min(times):.2f}, max {max(times):.2f}), "
        f"{1000.0 * MT_BATCH / ms:.3f} patches/s, peak {peak:.2f} GiB")
    return ok and good


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
        with torch.inference_mode():
            ok &= phase_kernels(dev, results, binding)
        torch.cuda.synchronize()
        ok &= phase_serving(dev, results)
        torch.cuda.synchronize()
        ok &= phase_training(dev, results)
        torch.cuda.synchronize()
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
        "call computes it); mc_consensus: the tiled forward's call; launches: both serving "
        "entries and the checked MT step")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
