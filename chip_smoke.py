#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pda_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error or miss:
  1. device   — a CUDA card is present; print its name and power limit
  2. build    — compile the CUDA kernels from pda_torch/kernels/csrc/
  3. kernels  — each kernel against its plain PyTorch version at every
                geometry of the serving path and of the Mean-Teacher step,
                random seeded inputs; each backward twice, bit-equal
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
  6. times    — CUDA-event medians of every kernel and its plain version,
                end-to-end ms/frame and tiles/s, MT ms/step and patches/s

Every comparison runs with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 both False), so the plain versions
compute in full float32. The last two lines of standard output are a JSON
line of per-kernel results and ``{"ok": true, "device": {...}}``; nothing of
the kind is printed when a phase fails or there is no card.
"""

from __future__ import annotations

import copy
import json
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
K3_MEAN_TOL = 1e-5  # kernel 3: max abs error of the MC mean
K3_WINDOW = 1e-4  # kernel 3: consensus may differ only where a logit is this near a threshold
TILE_TOL = 1e-4  # one tile, card vs CPU: max abs error of the MC mean

# (B, H, W, Cin, C): the ConvBlocks of one tiled forward (4 tiles of 512^2);
# each runs twice per forward, in the backbone and in the prior
K1_SHAPES = [(4, 512, 512, 1, 64), (4, 256, 256, 64, 128),
             (4, 128, 128, 128, 256), (4, 64, 64, 256, 512)]
K1_PSEUDO = (1, 528, 704, 1, 64)  # the pseudo path's entry block (frame padded to 16)
# (B, H, W, Ca, Cb, C): the decoder blocks, input [upsample | skip]
K2_SHAPES = [(4, 128, 128, 512, 256, 256), (4, 256, 256, 256, 128, 128),
             (4, 512, 512, 128, 64, 64)]
K3_SHAPE = (4, 512, 512, 64)  # feature term of one tiled forward
# The ConvBlock backwards of one MT step (512^2, batch 2): ((B, H, W, Cin, C),
# need_dx, calls per step). The entry blocks (backbone, prior: Cin 1;
# posterior: image + mask, Cin 2) take no dx; levels 1-3 run in all three nets.
BWD_SHAPES = [((2, 512, 512, 1, 64), False, 2), ((2, 512, 512, 2, 64), False, 1),
              ((2, 256, 256, 64, 128), True, 3), ((2, 128, 128, 128, 256), True, 3),
              ((2, 64, 64, 256, 512), True, 3)]
# (B, H, W, Ca, Cb, C): the decoder blocks' backward, once each per step
BWD_DUAL_SHAPES = [(2, 128, 128, 512, 256, 256), (2, 256, 256, 256, 128, 128),
                   (2, 512, 512, 128, 64, 64)]
BWD_REL_TOL = 1e-4  # each of dx, dW, db: max |kernel - plain| <= 1e-4 * max |plain|

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


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    import torch

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


def conv_weights(gen, cin, c, dev):
    import torch

    out = []
    for ci in (cin, c, c):
        out.append((torch.randn(3, 3, ci, c, generator=gen) * (2.0 / (9 * ci)) ** 0.5).to(dev))
        out.append((torch.randn(c, generator=gen) * 0.1).to(dev))
    return out


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

    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    w1, b1, w2, b2, w3, b3 = conv_weights(gen, cin, c, dev)
    hs = [t.permute(0, 2, 3, 1).contiguous() for t in kc._plain_layers(x, w1, b1, w2, b2, w3, b3)]
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    return (g, x, *hs, w1, w2, w3)


def check_bwd(entry, label, kernel, plain, args, names, per_step):
    """A backward kernel against its plain version: every output within
    BWD_REL_TOL of the plain one's largest, and two runs bit-equal."""
    import torch

    out, again, ref = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    ok, worst = True, (0.0, "")
    same = all((a is None and a2 is None) or torch.equal(a, a2) for a, a2 in zip(out, again))
    for name, a, r in zip(names, out, ref):
        if r is None:
            ok &= a is None
            continue
        err = float((a - r).abs().max())
        scale = float(r.abs().max())
        ok &= bool(torch.isfinite(a).all()) and err <= BWD_REL_TOL * scale
        worst = max(worst, (err / scale if scale else err, name))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    ok &= same
    del out, again, ref
    ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
    log(f"kernel {label}: worst max_abs_err/max|plain| {worst[0]:.3e} ({worst[1]}; tol "
        f"{BWD_REL_TOL:.0e}), repeat bit-equal {same}, ms {ms:.3f} plain_ms {plain_ms:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    entry["ms"] += per_step * ms
    entry["plain_ms"] += per_step * plain_ms
    return ok


def phase_kernels(dev, results):
    """Kernels against their plain versions; fills ``results`` per kernel."""
    import torch

    from pda_torch.kernels import conv_block as kc
    from pda_torch.kernels import mc_consensus as km

    gen = torch.Generator().manual_seed(SEED)
    k1, k2, k3 = results["conv_block_fwd"], results["conv_block_fwd_dual"], results["mc_consensus"]

    def check_conv(entry, label, kernel, plain, args, per_forward):
        out, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = K12_REL_TOL * float(ref.abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= tol
        ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
        log(f"kernel {label}: max_abs_err {err:.3e} (tol {tol:.3e}) ms {ms:.3f} "
            f"plain_ms {plain_ms:.3f} {'ok' if ok else 'FAIL'}")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms"] += per_forward * ms
        entry["plain_ms"] += per_forward * plain_ms
        del out, ref
        return ok

    ok = True
    for b, h, w, cin, c in K1_SHAPES + [K1_PSEUDO]:
        x = torch.randn(b, h, w, cin, generator=gen).to(dev)
        per_forward = 0 if (b, h, w, cin, c) == K1_PSEUDO else 2
        ok &= check_conv(k1, f"conv_block_fwd {cin}->{c} @{b}x{h}x{w}", kc.conv_block_fwd,
                         kc.conv_block_fwd_plain, (x, *conv_weights(gen, cin, c, dev)),
                         per_forward)
    for b, h, w, ca, cb, c in K2_SHAPES:
        xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
        xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
        ok &= check_conv(k2, f"conv_block_fwd_dual {ca}+{cb}->{c} @{b}x{h}x{w}",
                         kc.conv_block_fwd_dual, kc.conv_block_fwd_dual_plain,
                         (xa, xb, *conv_weights(gen, ca + cb, c, dev)), 1)

    for (b, h, w, cin, c), need_dx, per_step in BWD_SHAPES:
        saved = saved_block(gen, b, h, w, cin, c, dev)
        ok &= check_bwd(results["conv_block_bwd"], f"conv_block_bwd {cin}->{c} @{b}x{h}x{w} "
                        f"need_dx={need_dx}", lambda *a: kc.conv_block_bwd(*a, need_dx=need_dx),
                        lambda *a: kc.conv_block_bwd_plain(*a, need_dx=need_dx), saved,
                        ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"), per_step)
        del saved
    for b, h, w, ca, cb, c in BWD_DUAL_SHAPES:
        g, x, *rest = saved_block(gen, b, h, w, ca + cb, c, dev)
        args = (g, x[..., :ca].contiguous(), x[..., ca:].contiguous(), *rest)
        del x
        ok &= check_bwd(results["conv_block_bwd_dual"], f"conv_block_bwd_dual {ca}+{cb}->{c} "
                        f"@{b}x{h}x{w}", kc.conv_block_bwd_dual, kc.conv_block_bwd_dual_plain,
                        args, ("dxa", "dxb", "dw1", "db1", "dw2", "db2", "dw3", "db3"), 1)
        del g, rest, args

    b, h, w, c = K3_SHAPE
    feat = (torch.randn(b, h, w, c, generator=gen) * 2).to(dev)
    args = (feat, torch.randn(MC, b, c, generator=gen).to(dev),
            (torch.randn(1, c, c, generator=gen) / c ** 0.5).to(dev),
            (torch.randn(1, c, generator=gen) * 0.1).to(dev),
            (torch.randn(c, 1, generator=gen) * 3 / c ** 0.5).to(dev),
            torch.randn(1, generator=gen).to(dev))
    logits = km.mc_logits_plain(*args)
    near = ((logits.abs() - torch.log(torch.tensor(9.0))).abs() < K3_WINDOW).any(dim=0)
    del logits
    for masking in (False, True):
        mean, cons = km.mc_consensus(*args, masking=masking)
        ref_mean, ref_cons = km.mc_consensus_plain(*args, masking)
        torch.cuda.synchronize()
        err = float((mean - ref_mean).abs().max())
        stray = int(((cons != ref_cons) & ~near).sum())
        flips = int((cons != ref_cons).sum())
        good = err <= K3_MEAN_TOL and stray == 0
        ms = cuda_ms(lambda: km.mc_consensus(*args, masking=masking))
        plain_ms = cuda_ms(lambda: km.mc_consensus_plain(*args, masking), iters=3)
        log(f"kernel mc_consensus S={MC} feat {b}x{h}x{w}x{c} masking={masking}: "
            f"mean max_abs_err {err:.3e} (tol {K3_MEAN_TOL:.0e}), consensus differs at {flips} "
            f"px, {stray} of them farther than {K3_WINDOW:.0e} from a threshold; ms {ms:.3f} "
            f"plain_ms {plain_ms:.3f} {'ok' if good else 'FAIL'}")
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        if not masking:  # the tiled forward's call
            k3["ms"], k3["plain_ms"] = ms, plain_ms
        ok &= good
        del mean, cons, ref_mean, ref_cons
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

    wrappers = {"conv_block_fwd": kc.conv_block_fwd,
                "conv_block_fwd_dual": kc.conv_block_fwd_dual,
                "mc_consensus": km.mc_consensus}
    expect = {"conv_block_fwd": 8, "conv_block_fwd_dual": 3, "mc_consensus": 1}
    gen = torch.Generator().manual_seed(SEED)
    model_cpu = livecell_punet(generator=torch.Generator().manual_seed(SEED)).eval()
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
    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(SEED))
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
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
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
    ok = True
    try:
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
        with torch.inference_mode():
            ok &= phase_kernels(dev, results)
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
    log("kernel ms/plain_ms: forward kernels summed over one tiled MC-16 forward's calls, "
        "backward kernels over one MT step's (512^2, batch 2); launches: both serving "
        "entries and the checked MT step")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
