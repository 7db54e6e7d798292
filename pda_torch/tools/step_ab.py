"""Time the flagship's Mean-Teacher step of two or more checkouts of the
repository against each other on one card.

    python -m pda_torch.tools.step_ab DIR [DIR ...] [--timed 10] [--dtype bf16|f32]
        [--what step|frame]

Each DIR is the root of a checkout (its ``pda_torch`` package and
``chip_smoke.py``; the parent commit unpacked with ``git archive``, say).
The checkouts run in turns (DIR1 .. DIRn, then DIRn .. DIR1, so A B B A for
two), each in a process of its own that imports only that checkout and builds
its kernels: the step as ``chip_smoke.py`` times it (512^2, batch 2, MC-16,
consensus masking, Adam 1e-5, EMA 0.999, seeded weights and data, ``pda``'s
bf16 configuration: ``bench.py``'s default, or float32 with ``--dtype f32``), the
CUDA-event median of ``--timed`` steps after 3 warm-ups, beside the host's time
inside the step call (the launches' cost: where it reaches the step's time, the
host sets the pace). ``--what frame``: the tiled MC-16 prediction of
``chip_smoke.py``'s seeded 520x704 frame instead (``tiled_punet_probs``, 4
tiles of 512^2), timed the same way. A whole
step's comparison needs this rather than ``bench_variants``: a checkout's
Python wrappers and its kernels change together.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def one(root: Path, timed: int, dtype: str = "bf16", what: str = "step") -> None:
    """Time the step of the checkout at ``root`` (run in its own process,
    this file as a script: its own folder leaves the import path, since its
    ``profile.py`` would shadow the standard library's)."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(root)] + [p for p in sys.path if Path(p or ".").resolve() != here]
    import torch

    import chip_smoke as cs
    from pda_torch.train import make_mean_teacher_step

    if not Path(cs.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    if dtype == "bf16":
        model = cs.bf16_model()
    else:
        from pda_torch.models.punet import livecell_punet

        model = livecell_punet(consensus_masking=True, device="cpu",
                               generator=torch.Generator().manual_seed(cs.SEED))
        with torch.no_grad():
            model.fcomb.last_layer.weight.mul_(cs.LAST_SCALE)
    frame = cs.synthetic_frame(gen, cs.FRAME, "cpu")
    if what == "frame":
        from pda_torch.infer import tiled_punet_probs

        net, frame = model.to(dev).eval(), frame.to(dev)
        eps = torch.randn(cs.MC, 4, 6, generator=gen).to(dev)

        def run():
            with torch.inference_mode():
                tiled_punet_probs(net, frame, eps, cs.MC, cs.BLOCK, cs.HALO)
    else:
        batch = cs.mt_batch(gen, frame, cs.MT_TIME_PATCH, dev)
        step = make_mean_teacher_step(momentum=cs.MT_MOMENTUM, do_consensus_masking=True)
        state = cs.bf16_state(model, dev)
        noise = torch.Generator(device=dev).manual_seed(cs.SEED)

        def run():
            step(state, *batch, generator=noise)
    times, host = [], []
    for i in range(3 + timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        run()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
            host.append(1000.0 * (t1 - t0))
    label = f"{dtype} {'MT step' if what == 'step' else 'tiled MC-16 frame'}"
    print(f"{root}: {label} {statistics.median(times):.2f} ms (median of "
          f"{timed}, min {min(times):.2f}, max {max(times):.2f}); host time inside the call "
          f"{statistics.median(host):.2f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--timed", type=int, default=10)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="the flagship's compute: pda's bf16 configuration or float32")
    ap.add_argument("--what", choices=("step", "frame"), default="step",
                    help="the MT step, or the tiled MC-16 prediction of one frame")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        one(args.dirs[0].resolve(), args.timed, args.dtype, args.what)
        return 0
    code = 0
    for d in args.dirs + args.dirs[::-1]:
        code |= subprocess.run([sys.executable, __file__, str(d.resolve()), "--one",
                                "--timed", str(args.timed), "--dtype", args.dtype,
                                "--what", args.what]).returncode
    return code


if __name__ == "__main__":
    sys.exit(main())
