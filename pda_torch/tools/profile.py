"""Where the card's time goes, for ``PERF.md`` section 5.

    python -m pda_torch.tools.profile [--what ptxas,sass,mt,serving,engine] [--steps 3]
        [--epoch 4] [--dtype float32|bf16]

Needs one CUDA card (exits 1 without). Five parts, each optional:

- ``ptxas``: each kernel source compiled as the build compiles it, plus
  ``-Xptxas -v``: registers, spill bytes and shared memory per kernel.
- ``sass`` (not in the default): the instruction mix of the MC tail's
  sample loop at the flagship's width (``mc_consensus_wgmma_tf32<64, 1>``;
  with ``--dtype bf16`` ``mc_consensus_wgmma<64, 1>``): ``cuobjdump -sass``
  of the object ``ptxas`` compiles, the innermost loop that holds its
  ``HGMMA``s, instructions by opcode, a loop iteration and a sample (an
  iteration runs 1 sample in float32, 8 in bf16).
- ``mt``: the flagship's Mean-Teacher step (512^2, batch 2, MC-16,
  consensus masking, Adam 1e-5, EMA 0.999, f32, seeded weights and data) under
  ``torch.profiler`` for ``--steps`` steps after 3 warm-ups: device time per
  kernel name a step, launches a step, share of the wall time (CUDA events
  around the window), busy share (device time summed over wall), and the
  ConvBlock kernels' and the MC tail's TFLOP/s from the FLOPs their shapes
  need.
- ``serving``: the same for the tiled MC-16 prediction and the MC-16 pseudo
  export of one seeded 520x704 frame, per frame.
- ``--dtype bf16``: ``mt`` and ``serving`` on the flagship in ``pda``'s bf16
  configuration (``livecell_punet(dtype=torch.bfloat16)``, float32
  parameters), the bf16 instances of the kernels.
- ``engine`` (not in the default): the flagship's ``MeanTeacherTrainer`` at
  512^2 (``workload.livecell_mt_trainer``: epochs of ``--epoch`` steps, a
  validation, the panels every 4 steps, checkpoints). After a warm-up
  epoch: the bare MT step on one of its batches (CUDA events), then
  ``--steps`` epochs unprofiled: the fit's Throughput with and without its
  checkpoint writes, beside the bare step's. Then one more epoch under
  ``torch.profiler``: the device's busy share over the epoch (kernels'
  union over wall time) and over its train loop (first step to the
  validation), the host seconds of each part of the loop (the engine's
  ``engine/<part>`` ranges), and the longest idle gaps of the device, each
  with the host part that was running when it began.

TF32 is off for cuDNN and matmul, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import conv_block as kc
from ..kernels import mc_consensus as km
from .workload import block_flops, cuda_ms, dgrad_flops, mc_flops, recompute_flops

# kernel name pattern -> label; the first that matches names a kernel
LABELS = (
    (r"conv3x3_tc<[^>]*true>", "forward layer, tensor cores (conv3x3_tc fwd)"),
    (r"conv3x3_wgmma_tf32<[^>]*DgradEpi", "dgrad, 3xTF32 wgmma (conv3x3_wgmma_tf32 DgradEpi)"),
    (r"conv3x3_wgmma_tf32<", "forward layer, 3xTF32 wgmma (conv3x3_wgmma_tf32)"),
    (r"tf32_planes", "float32 weight copies, kernel + hi + lo (tf32_planes)"),
    (r"conv3x3_wgmma<[^>]*DgradEpi", "dgrad, bf16 wgmma (conv3x3_wgmma DgradEpi)"),
    (r"conv3x3_wgmma<", "forward layer, bf16 wgmma (conv3x3_wgmma)"),
    (r"conv3x3_entry<", "forward entry layer, FMA (conv3x3_entry)"),
    (r"conv3x3_tc<[^>]*false>", "dgrad (conv3x3_tc)"),
    (r"wgrad_tc<", "wgrad (wgrad_tc)"),
    (r"wgrad_wgmma_tf32<", "wgrad, 3xTF32 wgmma (wgrad_wgmma_tf32)"),
    (r"wgrad_wgmma<", "wgrad, bf16 wgmma (wgrad_wgmma)"),
    (r"wgrad_entry<", "wgrad entry layer, FMA (wgrad_entry)"),
    (r"sum_chunks", "wgrad chunk reduce (sum_chunks)"),
    (r"masked_cotangent", "da3 mask and pooled cotangent (masked_cotangent)"),
    (r"mc_consensus_wgmma(_tf32)?<", "MC tail, tensor cores (mc_consensus_wgmma[_tf32])"),
)


def ptxas() -> None:
    nvcc = _build._nvcc()
    out_dir = _build.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in _build._sources():
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               str(out_dir / f"{src.stem}.o"), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(f"== ptxas {src.name} (rc {proc.returncode})")
        fn = None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = demangle(m.group(1))
            elif fn and ("registers" in line or "spill" in line):
                print(f"  {fn}: {line.split(':', 1)[-1].strip()}")


#: the MC tail's flagship instance by dtype: (mangled, as printed, the
#: samples an iteration of its sample loop runs)
SASS_KERNELS = {
    torch.float32: ("mc_consensus_wgmma_tf32ILi64ELi1E", "mc_consensus_wgmma_tf32<64, 1>", 1),
    torch.bfloat16: ("mc_consensus_wgmmaILi64ELi1E", "mc_consensus_wgmma<64, 1>", 8),
}


def sass(dtype=torch.float32) -> None:
    kernel, name, samples = SASS_KERNELS[dtype]
    obj = _build.BUILD_DIR / "ptxas" / "mc_consensus.o"
    if not obj.exists():
        ptxas()
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True, text=True).stdout
    body, keep = [], False
    for line in text.splitlines():
        if "Function : " in line:
            keep = kernel in line
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if keep and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    # the innermost backward branch whose span holds the products
    loops = []
    for addr, ins in body:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            span = [i for a, i in body if int(m.group(1), 16) <= a <= addr]
            if any(i.startswith("HGMMA") for i in span):
                loops.append(span)
    if not loops:
        print(f"== sass {name}: no loop with HGMMA found")
        return
    span = min(loops, key=len)
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
                              for i in span)
    print(f"== sass {name}: the sample loop, {len(span)} instructions an "
          f"iteration of {samples} samples ({len(span) / samples:.1f} a sample)")
    for op, n in ops.most_common():
        print(f"  {op}: {n} ({n / samples:.2f} a sample)")


def demangle(name: str) -> str:
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=10).stdout.strip() or name
    except OSError:
        return name


@contextlib.contextmanager
def count_flops():
    """Within the block, every ConvBlock launch adds the FLOPs its shapes need
    to the yielded counter (forward, wgrad and dgrad, 18 * Cin * Cout a pixel
    and layer), and every MC-tail launch its own (``mc``)."""
    flops = collections.Counter()
    weights = flops.weights = []  # the forward's (HWIO kernel, dtype), in launch order
    launch, launch_bwd, launch_mc = kc._launch, kc._launch_bwd, km._launch

    def fwd(xa, xb, w1, b1, w2, b2, w3, b3):
        b, h, w, ca = xa.shape
        cin, c = ca + (0 if xb is None else xb.shape[-1]), w1.shape[-1]
        flops["forward"] += block_flops(b, h, w, cin, c)
        weights.extend((w, xa.dtype) for w in (w1, w2, w3))
        return launch(xa, xb, w1, b1, w2, b2, w3, b3)

    def bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, workspaces=None, **kw):
        b, h, w, ca = xa.shape
        cin, c = ca + (0 if xb is None else xb.shape[-1]), w1.shape[-1]
        flops["wgrad"] += block_flops(b, h, w, cin, c)
        flops["dgrad"] += dgrad_flops(b, h, w, cin, c, need_dx or xb is not None)
        if h1 is None:  # the mixed mode's recompute of h1, h2
            flops["recompute"] += recompute_flops(b, h, w, cin, c)
        return launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, workspaces, **kw)

    def mc(feat, z_terms, mid_w, *rest):
        flops["mc"] += mc_flops(*feat.shape, z_terms.shape[0], mid_w.shape[0])
        return launch_mc(feat, z_terms, mid_w, *rest)

    kc._launch, kc._launch_bwd, km._launch = fwd, bwd, mc
    try:
        yield flops
    finally:
        kc._launch, kc._launch_bwd, km._launch = launch, launch_bwd, launch_mc


def profiled(run, n: int, flops: collections.Counter, what: str) -> None:
    """Profile ``n`` calls of ``run`` and print the device time by kernel a
    call; ``flops`` holds one call's (:func:`count_flops`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / n
    rows = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        # device activities only: a CPU op's device time is its kernels'
        # again; "Command Buffer Full" is the host waiting on a full queue
        if ev.device_type != DeviceType.CUDA or ev.key == "Command Buffer Full":
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0:
            continue
        label = next((lab for pat, lab in LABELS if re.search(pat, ev.key)), None)
        key = label or ev.key[:90]
        rows[key][0] += dev_us / 1e3 / n
        rows[key][1] += ev.count / n
    busy = sum(ms for ms, _ in rows.values())
    print(f"== {what}: wall {wall:.2f} ms per call (profiled), device busy {busy:.2f} ms "
          f"({busy / wall:.3f})")
    rates = {"forward layer, tensor cores (conv3x3_tc fwd)": "forward",
             "forward layer, bf16 wgmma (conv3x3_wgmma)": "forward",
             "forward layer, 3xTF32 wgmma (conv3x3_wgmma_tf32)": "forward",
             "dgrad, 3xTF32 wgmma (conv3x3_wgmma_tf32 DgradEpi)": "dgrad",
             "forward entry layer, FMA (conv3x3_entry)": "forward",
             "wgrad entry layer, FMA (wgrad_entry)": "wgrad",
             "wgrad, 3xTF32 wgmma (wgrad_wgmma_tf32)": "wgrad",
             "dgrad (conv3x3_tc)": "dgrad", "wgrad (wgrad_tc)": "wgrad",
             "dgrad, bf16 wgmma (conv3x3_wgmma DgradEpi)": "dgrad",
             "wgrad, bf16 wgmma (wgrad_wgmma)": "wgrad",
             "MC tail, tensor cores (mc_consensus_wgmma[_tf32])": "mc"}
    # a part's rate over all its rows (the entry layers, and in bf16 the
    # layers that stay on the mma.sync bodies, run beside the main body)
    part_ms = collections.Counter()
    for k, (ms, _) in rows.items():
        if k in rates:
            part_ms[rates[k]] += ms
    for key, (ms, count) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        rate = ""
        if key in rates and flops.get(rates[key]):
            total = part_ms[rates[key]]
            rate = f", {flops[rates[key]] / (total * 1e-3) / 1e12:.1f} TFLOP/s"
            rate += f" ({rates[key]}: {total:.3f} ms, all its rows)" if total != ms else ""
        print(f"  {ms:9.3f} ms {100 * ms / wall:5.1f}% {count:6.1f} launches  {key}{rate}")
    if flops.weights:
        copy_ms = hwoi_ms(flops.weights)
        print(f"  of the copies: the forward's weight copies, {len(flops.weights)} a call, "
              f"{copy_ms:.3f} ms ({100 * copy_ms / wall:.2f}%; CUDA events, alone)")


def hwoi_ms(weights) -> float:
    """Device ms of the forward wrapper's weight copies of ``weights`` ((HWIO
    kernel, the activations' dtype) pairs), one call's: the HWOI copy in
    bf16, the three planes in float32 (``conv_block._fwd_kernel``)."""
    return cuda_ms(lambda: [kc._fwd_kernel(w, d) for w, d in weights], iters=20)


_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def mt(dev, steps: int, dtype: torch.dtype = torch.float32) -> None:
    from ..models.punet import livecell_punet
    from ..train import adam, create_train_state, make_mean_teacher_step

    gen = torch.Generator().manual_seed(0)
    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(0),
                           device=dev, dtype=dtype)
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(8.0)
    state = create_train_state(model, adam(model.parameters(), 1e-5), with_teacher=True)
    step = make_mean_teacher_step(momentum=0.999, do_consensus_masking=True)
    x = torch.randn(2, 512, 512, 1, generator=gen)
    batch = [a.to(dev) for a in (x, x + 0.1 * torch.randn(x.shape, generator=gen),
                                 x + 0.3 * torch.randn(x.shape, generator=gen),
                                 (x > 1.0).float())]
    cuda_gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        step(state, *batch, generator=cuda_gen)
    with count_flops() as flops:  # one step's FLOPs, outside the profile
        step(state, *batch, generator=cuda_gen)
    profiled(lambda: step(state, *batch, generator=cuda_gen), steps, flops,
             f"MT step 512^2 batch 2 MC-16 {_NAMES[dtype]}")


def serving(dev, frames: int, dtype: torch.dtype = torch.float32) -> None:
    from ..infer import full_punet_pseudo, tiled_punet_probs
    from ..models.punet import livecell_punet

    gen = torch.Generator().manual_seed(0)
    model = livecell_punet(generator=torch.Generator().manual_seed(0), device=dev,
                           dtype=dtype).eval()
    frame = (torch.randn(520, 704, 1, generator=gen) * 40 + 100).to(dev)
    eps_tiled = torch.randn(16, 4, 6, generator=gen).to(dev)
    eps_pseudo = torch.randn(16, 1, 6, generator=gen).to(dev)
    for name, run in (
            (f"tiled_punet_probs MC-16 520x704 (4 tiles of 512^2) {_NAMES[dtype]}",
             lambda: tiled_punet_probs(model, frame, eps_tiled, 16, (384, 384), (64, 64))),
            (f"full_punet_pseudo MC-16 520x704 (padded 528x704) {_NAMES[dtype]}",
             lambda: full_punet_pseudo(model, frame, eps_pseudo, 16, masking=True))):
        for _ in range(3):
            run()
        with count_flops() as flops:
            run()
        profiled(run, frames, flops, name)


def _union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def engine(dev, epochs: int, epoch: int) -> None:
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .workload import livecell_mt_trainer

    with tempfile.TemporaryDirectory() as root:
        trainer = livecell_mt_trainer(root, device=dev, steps_per_epoch=epoch)
        trainer.fit(epoch)  # the loader's workers, the first epoch's validation and checkpoints
        batch = trainer._put(next(iter(trainer.train_loader)))
        bare_ms = cuda_ms(lambda: trainer.train_step(trainer.state, *batch, **trainer._noise),
                          iters=7)
        del batch
        before = dict(trainer.timings)
        stats = trainer.fit(trainer._iteration + epochs * epoch)
        writes = trainer.timings["checkpoint"] - before.get("checkpoint", 0.0)
        ms_iter = 1e3 * stats["elapsed_sec"] / stats["steps"]
        unwritten = 1e3 * (stats["elapsed_sec"] - writes) / stats["steps"]
        print(f"== engine: MeanTeacherTrainer 512^2 batch 2 MC-16 f32, epochs of {epoch} "
              f"(validation, panels every 4, checkpoints), {epochs * epoch} iterations after a "
              f"warm-up epoch: the fit's Throughput {ms_iter:.2f} ms/iteration, "
              f"{stats['patches_per_sec']:.3f} patches/s, {bare_ms / ms_iter:.3f} of the bare MT "
              f"step's {bare_ms:.2f} ms (CUDA events, the same batch); less its checkpoint "
              f"writes ({writes:.3f} s) {unwritten:.2f} ms/iteration, {bare_ms / unwritten:.3f}")
        before = dict(trainer.timings)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stats = trainer.fit(trainer._iteration + epoch)
            torch.cuda.synchronize()
    events = prof.events()
    kernels = _union((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len("engine/"):])
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("engine/"))
    t0, t1 = kernels[0][0], kernels[-1][1]
    busy = sum(b - a for a, b in kernels)
    print(f"  one more epoch profiled: {stats['patches_per_sec']:.3f} patches/s (Throughput), "
          f"device busy {busy / 1e3:.1f} of {(t1 - t0) / 1e3:.1f} ms ({busy / (t1 - t0):.3f})")
    a = next(x for x, _, name in spans if name == "step")  # the train loop: first step to validation
    b = next((x for x, _, name in spans if name == "validation" and x > a), t1)
    busy_loop = sum(max(0.0, min(y, b) - max(x, a)) for x, y in kernels)
    print(f"  train loop (first step to the validation): busy {busy_loop / 1e3:.1f} of "
          f"{(b - a) / 1e3:.1f} ms ({busy_loop / max(b - a, 1e-9):.3f})")
    host = {k: v - before.get(k, 0.0) for k, v in trainer.timings.items()}
    print("  host seconds by part: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                 sorted(host.items(), key=lambda kv: -kv[1])))
    gaps = [(b - a, a) for (_, a), (b, _) in zip(kernels, kernels[1:]) if b - a > 100.0]
    by_part = collections.Counter()
    rows = []
    for length, start in sorted(gaps, reverse=True):
        running = [name for x, y, name in spans if x <= start < y]
        part = running[-1] if running else "(none)"
        by_part[part] += length / 1e3
        rows.append((length, start, part))
    print(f"  idle gaps over 0.1 ms: {len(gaps)}, {sum(g for g, _ in gaps) / 1e3:.1f} ms; by "
          "the host part running when each began: " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in by_part.most_common()))
    for length, start, part in rows[:12]:
        print(f"    {length / 1e3:8.2f} ms at {(start - t0) / 1e3:9.1f} ms  ({part})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="ptxas,mt,serving")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--epoch", type=int, default=4, help="engine: iterations an epoch")
    ap.add_argument("--dtype", choices=("float32", "bf16"), default="float32",
                    help="mt, serving, sass: the flagship in float32 or in pda's bf16 "
                         "configuration")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if not torch.cuda.is_available():
        print("profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    what = args.what.split(",")
    if "ptxas" in what:
        ptxas()
    if "sass" in what:
        sass(dtype)
    if "mt" in what:
        mt(dev, args.steps, dtype)
    if "serving" in what:
        with torch.inference_mode():
            serving(dev, args.steps, dtype)
    if "engine" in what:
        engine(dev, args.steps, args.epoch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
