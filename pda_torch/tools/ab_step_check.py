"""The flagship Mean-Teacher step on the kernels against the same step with
every plain version (``pda``'s ``development/ab_step_check.py``).

    python -m pda_torch.tools.ab_step_check [--hw 256|512] [--dtype f32|bf16]
        [--filters 64,128,256,512] [--device cuda|cpu] [--cudnn_benchmark]

The flagship PUNet (latent 6, Fcomb 3, rl_swap, consensus masking; seeded
weights, the Fcomb's last layer x8 so that the random teacher's consensus
share lies inside (0, 1)) on a batch of 2 of ``pda_torch/data/synthetic.py``'s
frames at ``--hw``^2 (standardized, a weak and a strong noisy view). From
one state, batch and noise, the step's compute runs twice
(:func:`~.ab.kernels_and_plain`): on the kernels, then under
``conv_block.plain_versions()``; each leg gives the teacher's MC-16
pseudo-label and consensus, the student's loss and its raw gradients, no
update. Reported, each with its bound:

  * max|dy|, the pseudo-label's largest difference;
  * the consensus pixels that differ: in bf16 at most 4x the pixels at
    which the plain leg's teacher in float32 and in float64 sums differs;
    in float32 only where a sample logit of either leg lies within 4x the
    plain leg's own largest float32-vs-float64 logit difference (at least
    1e-4, the window of ``chip_smoke.py``'s float32 teacher check) of a
    threshold (``pda``'s rule, no pixel at all, fails two valid float32
    orders: 2 of 524,288 pixels at 512^2 on the card);
  * the loss's relative difference, 1 - the gradients' global cosine, the
    worst leaf's relative L2 (floored at 1e-4 of the global norm).

Bounds: in float32 each measure within 4x the plain leg's own spread (the
same compute on a float64 copy of the state), and never beyond ``pda``'s
own bound (``ab.f32_bounds``); the loss and the aux values at least within
the kernels' own drift, 1.5e-6 a conv layer along the deepest path's 21
(the tensor cores' round-toward-zero adds shrink every layer's sums alike,
``csrc/tf32x3.cuh``: 1.0e-5 in the loss on an H100, 40-170x the plain
leg's own unbiased spread, while the kernels' gradients lie 20-50x nearer
float64's in cosine than the plain leg's); in bf16 the rule of ``chip_smoke.py``'s bf16
A/B (``ab.AB_*_TOL``, and ``pda``'s bf16 bound on max|dy|). On the card it
also times both legs' whole MT step (update included; CUDA events, the
median of 5 after 2 warm-ups), the plain leg's beside the value of
``torch.backends.cudnn.benchmark`` (``--cudnn_benchmark`` sets it for the
plain leg's timing; off, cuDNN's default dgrad at 128->256 can take 0.3 s a
call). TF32 is off. On the CPU (``--device cpu``) both legs run the plain
versions, so every difference is 0, and nothing is timed. Exits 1 if a
bound fails or, on the card, a kernel was not launched in the kernel leg or
was in the plain leg.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Optional

import torch

from . import ab
from .common import add_device_arg, card, tool_device

FILTERS = (64, 128, 256, 512)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BATCH, LR, MOMENTUM, SEED = 2, 1e-5, 0.999, 0


def flagship(filters, dtype: torch.dtype, seed: int):
    """The flagship PUNet at ``filters`` on the CPU, its Fcomb's last layer x8."""
    from ..models import ProbabilisticUnet
    from .workload import FCOMB_LAST_SCALE

    model = ProbabilisticUnet(input_channels=1, num_classes=1, num_filters=tuple(filters),
                              latent_dim=6, no_convs_fcomb=3, beta=1.0, rl_swap=True,
                              consensus_masking=True, dtype=dtype,
                              generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(FCOMB_LAST_SCALE)
    return model


def deepest_convs(filters) -> int:
    """The conv layers on a PUNet's deepest path: its UNet's encoder (three a
    level) and decoder (three a level but the lowest)."""
    return 3 * (2 * len(filters) - 1)


def synthetic_batch(hw: int, gen: torch.Generator, seed: int, dev, batch: int = BATCH):
    """(x, x1, x2, gt): ``batch`` synthetic frames of hw^2, standardized, a
    weak (noise 0.1) and a strong (0.3) view, and their foreground masks."""
    import numpy as np

    from ..data.synthetic import make_dataset_arrays
    from ..infer.tiling import tile_standardize

    raws, labels = make_dataset_arrays(batch, (hw, hw), seed=seed)
    x = tile_standardize(torch.from_numpy(np.stack(raws))[..., None])
    x1 = x + 0.1 * torch.randn(x.shape, generator=gen)
    x2 = x + 0.3 * torch.randn(x.shape, generator=gen)
    gt = torch.from_numpy((np.stack(labels) > 0).astype(np.float32))[..., None]
    return [a.to(dev) for a in (x, x1, x2, gt)]


def step_ms(make_state, batch, dev) -> float:
    """The whole MT step's CUDA-event median (5 after 2 warm-ups)."""
    from ..train import make_mean_teacher_step
    from .workload import cuda_ms

    step = make_mean_teacher_step(momentum=MOMENTUM, do_consensus_masking=True)
    state = make_state()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return cuda_ms(lambda: step(state, *batch, generator=gen), warmup=2, iters=5)


def check(hw: int, dtype_name: str, filters, dev):
    """The A/B at ``hw``^2 on ``dev``: ({criterion: passed}, the result's
    numbers, a function making a fresh state, the batch)."""
    from ..train import adam, create_train_state

    dtype = DTYPES[dtype_name]
    model = flagship(filters, dtype, SEED)
    gen = torch.Generator().manual_seed(SEED)
    batch = synthetic_batch(hw, gen, SEED, dev)
    noise = {"eps_teacher": torch.randn(ab.MC, BATCH, 6, generator=gen).to(dev),
             "eps_post": torch.randn(BATCH, 6, generator=gen).to(dev)}

    def make_state():
        student = copy.deepcopy(model).to(dev)
        return create_train_state(student, adam(student.parameters(), LR), with_teacher=True)

    label = f"ab_step_check MT step {hw}^2 batch {BATCH} {dtype_name} filters {tuple(filters)}"
    bf16 = dtype == torch.bfloat16
    kern, plain, spread, counts, plain_counts = ab.kernels_and_plain(
        make_state, batch, noise, label, bf16=bf16)
    if bf16:
        bounds = {"loss": ab.AB_LOSS_TOL, "cos": ab.AB_COS_TOL, "leaf": ab.AB_LEAF_TOL,
                  "y": ab.PDA_BOUNDS["bf16"]["y"]}
        rule = {"teacher_spread": spread}
    else:
        bounds = ab.f32_bounds(spread, deepest_convs(filters))
        rule = {"window": bounds["window"]}
    passed = ab.ab_compare(f"{label} kernels vs plain ({dev.type}; launches {counts}, plain "
                           f"leg {plain_counts})", kern, plain, bounds=bounds, **rule)
    if dev.type == "cuda":
        passed["launched"] = all(counts.values())
        passed["plain leg"] = not any(plain_counts.values())
    m = ab.ab_metrics(kern, plain)
    result = {"hw": hw, "dtype": dtype_name, "filters": list(filters),
              "loss": m["loss"], "cos": m["cos"], "leaf": m["leaf"][0], "leaf_name": m["leaf"][1],
              "dy": float((kern["y"] - plain["y"]).abs().max()),
              "consensus_px": int((kern["z"] != plain["z"]).sum()),
              "plain_own": {k: v[0] if k == "leaf" else v for k, v in spread.items()},
              "bounds": bounds, "launches": counts}
    if bf16:
        result["consensus_px_bound"] = ab.SPREAD_FACTOR * spread["px"]
    else:
        result["consensus_stray_px"] = ab.stray_flips(kern, plain, bounds["window"])
    return passed, result, make_state, batch


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=int, default=256)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    parser.add_argument("--filters", default=",".join(map(str, FILTERS)))
    parser.add_argument("--cudnn_benchmark", action="store_true",
                        help="time the plain leg with torch.backends.cudnn.benchmark on")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "ab_step_check")
    filters = tuple(int(f) for f in args.filters.split(","))
    passed, result, make_state, batch = check(args.hw, args.dtype, filters, dev)
    result.update(kernel_ms=None, plain_ms=None, cudnn_benchmark=None, card=card(dev))
    if dev.type == "cuda":
        from ..kernels import conv_block as kc

        result["kernel_ms"] = step_ms(make_state, batch, dev)
        before = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = before or args.cudnn_benchmark
        try:
            with kc.plain_versions():
                result["plain_ms"] = step_ms(make_state, batch, dev)
            result["cudnn_benchmark"] = torch.backends.cudnn.benchmark
        finally:
            torch.backends.cudnn.benchmark = before
        ab.log(f"ab_step_check MT step {args.hw}^2 {args.dtype} (update included): kernels "
               f"{result['kernel_ms']:.2f} ms, plain versions {result['plain_ms']:.2f} ms "
               f"(cudnn.benchmark {result['cudnn_benchmark']}), "
               f"{result['plain_ms'] / result['kernel_ms']:.2f}x")
    ok = all(passed.values())
    failed = [k for k, v in passed.items() if not v]
    print("ab_step_check result " + json.dumps({**result, "ok": ok, "failed": failed}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
