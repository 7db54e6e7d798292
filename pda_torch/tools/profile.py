"""Where the card's time goes, for ``PERF.md`` section 5.

    python -m pda_torch.tools.profile [--what ptxas,mt,serving] [--steps 3]

Needs one CUDA card (exits 1 without). Three parts, each optional:

- ``ptxas``: each kernel source compiled as the build compiles it, plus
  ``-Xptxas -v``: registers, spill bytes and shared memory per kernel.
- ``mt``: the flagship's Mean-Teacher step (512^2, batch 2, MC-16,
  consensus masking, Adam 1e-5, EMA 0.999, f32, seeded weights and data) under
  ``torch.profiler`` for ``--steps`` steps after 3 warm-ups: device time per
  kernel name a step, launches a step, share of the wall time (CUDA events
  around the window), busy share (device time summed over wall), and the
  ConvBlock kernels' and the MC tail's TFLOP/s from the FLOPs their shapes
  need.
- ``serving``: the same for the tiled MC-16 prediction and the MC-16 pseudo
  export of one seeded 520x704 frame, per frame.

TF32 is off for cuDNN and matmul, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import re
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels import conv_block as kc
from ..kernels import mc_consensus as km
from .workload import block_flops, cuda_ms, dgrad_flops, mc_flops

# kernel name pattern -> label; the first that matches names a kernel
LABELS = (
    (r"conv3x3_tc<\d, true>", "forward layer, tensor cores (conv3x3_tc fwd)"),
    (r"conv3x3_entry<", "forward entry layer, FMA (conv3x3_entry)"),
    (r"conv3x3_tc<\d, false>", "dgrad (conv3x3_tc)"),
    (r"wgrad_tc<", "wgrad (wgrad_tc)"),
    (r"sum_chunks", "wgrad chunk reduce (sum_chunks)"),
    (r"relu_mask", "da3 mask (relu_mask)"),
    (r"mc_consensus_tc<", "MC tail, tensor cores (mc_consensus_tc)"),
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
    weights = flops.weights = []  # the forward's HWIO kernels, in launch order
    launch, launch_bwd, launch_mc = kc._launch, kc._launch_bwd, km._launch

    def fwd(xa, xb, w1, b1, w2, b2, w3, b3):
        b, h, w, ca = xa.shape
        cin, c = ca + (0 if xb is None else xb.shape[-1]), w1.shape[-1]
        flops["forward"] += block_flops(b, h, w, cin, c)
        weights.extend((w1, w2, w3))
        return launch(xa, xb, w1, b1, w2, b2, w3, b3)

    def bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx):
        b, h, w, ca = xa.shape
        cin, c = ca + (0 if xb is None else xb.shape[-1]), w1.shape[-1]
        flops["wgrad"] += block_flops(b, h, w, cin, c)
        flops["dgrad"] += dgrad_flops(b, h, w, cin, c, need_dx or xb is not None)
        return launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx)

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
             "dgrad (conv3x3_tc)": "dgrad", "wgrad (wgrad_tc)": "wgrad",
             "MC tail, tensor cores (mc_consensus_tc)": "mc"}
    fwd_ms = sum(ms for k, (ms, _) in rows.items() if k.startswith("forward"))
    for key, (ms, count) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        rate = ""
        if key in rates and flops.get(rates[key]):
            total = fwd_ms if rates[key] == "forward" else ms
            rate = f", {flops[rates[key]] / (total * 1e-3) / 1e12:.1f} TFLOP/s"
            rate += " (entry layer included)" if rates[key] == "forward" else ""
        print(f"  {ms:9.3f} ms {100 * ms / wall:5.1f}% {count:6.1f} launches  {key}{rate}")
    if flops.weights:
        copy_ms = hwoi_ms(flops.weights)
        print(f"  of the copies: the forward's HWOI weight copies, {len(flops.weights)} a call, "
              f"{copy_ms:.3f} ms ({100 * copy_ms / wall:.2f}%; CUDA events, alone)")


def hwoi_ms(weights) -> float:
    """Device ms of the forward wrapper's HWOI copies of ``weights``, one call's."""
    return cuda_ms(lambda: [kc._hwoi(w) for w in weights], iters=20)


def mt(dev, steps: int) -> None:
    from ..models.punet import livecell_punet
    from ..train import adam, create_train_state, make_mean_teacher_step

    gen = torch.Generator().manual_seed(0)
    model = livecell_punet(consensus_masking=True, generator=torch.Generator().manual_seed(0),
                           device=dev)
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
             "MT step 512^2 batch 2 MC-16 f32")


def serving(dev, frames: int) -> None:
    from ..infer import full_punet_pseudo, tiled_punet_probs
    from ..models.punet import livecell_punet

    gen = torch.Generator().manual_seed(0)
    model = livecell_punet(generator=torch.Generator().manual_seed(0), device=dev).eval()
    frame = (torch.randn(520, 704, 1, generator=gen) * 40 + 100).to(dev)
    eps_tiled = torch.randn(16, 4, 6, generator=gen).to(dev)
    eps_pseudo = torch.randn(16, 1, 6, generator=gen).to(dev)
    for name, run in (
            ("tiled_punet_probs MC-16 520x704 (4 tiles of 512^2)",
             lambda: tiled_punet_probs(model, frame, eps_tiled, 16, (384, 384), (64, 64))),
            ("full_punet_pseudo MC-16 520x704 (padded 528x704)",
             lambda: full_punet_pseudo(model, frame, eps_pseudo, 16, masking=True))):
        for _ in range(3):
            run()
        with count_flops() as flops:
            run()
        profiled(run, frames, flops, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="ptxas,mt,serving")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
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
    if "mt" in what:
        mt(dev, args.steps)
    if "serving" in what:
        with torch.inference_mode():
            serving(dev, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
