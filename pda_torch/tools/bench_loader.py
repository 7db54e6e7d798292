"""Can the host feed the card? The two-view loader's patches/s (``pda``'s
``development/bench_loader.py``).

    python -m pda_torch.tools.bench_loader [--hw 512] [--batch 2]
        [--workers 0,4,8,16] [--seconds 6] [--n_samples 400]
        [--step_rate STEPS_PER_S] [--device cuda|cpu]

The LIVECell Mean-Teacher pipeline's host side: ``DualImageCollectionDataset``
random crops of --hw^2 from 8 of ``pda_torch/data/synthetic.py``'s frames of
(hw + 64)^2, the joint geometric augmentations and two weak views a patch
(``experiments.common.weak_augmentations``), batched by ``Loader``, each
batch copied to the device as the trainer copies it (pinned, non-blocking;
``--device cpu``: no copy). For each augmentation path, chosen explicitly
(``native``: ``pda``'s C++ library, ``PDA_NATIVE_AUGS=1``; ``numpy``: ``0``)
and each worker count: patches/s over --seconds after one warm batch, in
epochs of --n_samples patches (0: one a frame, 8, as ``pda``'s script
samples; each new epoch then stalls the workers' pipeline, so short epochs
measure the epoch's start more than the steady rate).
Prints the host's usable cores and the best rate's margin against what the
step consumes: ``--batch`` x ``--step_rate``, or by default
:data:`STEP_PATCHES_PER_S`, the bf16 MT step's rate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .common import add_device_arg, card, tool_device

#: the bf16 MT step's patches/s at 512^2, batch 2: 2 patches in 48.21 ms
#: (PERF.md section 2: chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W power limit)
STEP_PATCHES_PER_S = 2 / 0.04821
STEP_SOURCE = "the bf16 MT step, 48.21 ms for 2 patches (PERF.md section 2, chip_smoke.py)"


def loader(images, labels, hw: int, batch: int, workers: int, n_samples: Optional[int] = None):
    """The two-view loader on the current augmentation path, epochs of
    ``n_samples`` patches (None: one a frame)."""
    from ..data import DualImageCollectionDataset, Loader
    from ..experiments.common import weak_augmentations

    weak = weak_augmentations()
    ds = DualImageCollectionDataset(images, labels, patch_shape=(hw, hw), augmentation1=weak,
                                    augmentation2=weak, n_samples=n_samples)
    return Loader(ds, batch_size=batch, shuffle=True, seed=0, num_workers=workers)


def measure(load, dev, seconds: float) -> float:
    """Patches/s of ``load`` over ``seconds`` (after one warm batch), each
    batch on ``dev``; then the loader's workers stop."""
    def put(batch):
        if dev.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(b)) for b in batch]
        return [torch.from_numpy(np.ascontiguousarray(b)).pin_memory().to(dev, non_blocking=True)
                for b in batch]

    try:
        it = iter(load)
        put(next(it))
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch = next(it, None)
            if batch is None:
                it = iter(load)
                batch = next(it)
            n += len(put(batch)[0])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)
    finally:
        load.close()


def main(argv: Optional[list] = None) -> int:
    from ..data.native import augmentation_path
    from ..data.synthetic import make_dataset_arrays

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=int, default=512)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--workers", default="0,4,8,16")
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--n_samples", type=int, default=400,
                        help="patches an epoch (0: one a frame, as pda's script)")
    parser.add_argument("--step_rate", type=float, default=None,
                        help="train steps/s the loader must feed (default: the bf16 MT step's)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "bench_loader")
    images, labels = make_dataset_arrays(8, (args.hw + 64, args.hw + 64), seed=0)
    labels = [(lab > 0).astype(np.float32) for lab in labels]
    rows = []
    for path in ("native", "numpy"):
        for workers in (int(w) for w in args.workers.split(",")):
            with augmentation_path(native={"native": True, "numpy": False}[path]):
                rate = measure(loader(images, labels, args.hw, args.batch, workers,
                                      args.n_samples or None), dev, args.seconds)
            rows.append({"path": path, "workers": workers, "patches_per_sec": rate})
            print(f"bench_loader {args.hw}^2 batch {args.batch} {path} workers {workers:2d}: "
                  f"{rate:8.1f} patches/s", flush=True)
    cores = len(os.sched_getaffinity(0))
    need = (args.batch * args.step_rate if args.step_rate is not None else STEP_PATCHES_PER_S)
    source = (f"--batch {args.batch} x --step_rate {args.step_rate:g}"
              if args.step_rate is not None else STEP_SOURCE)
    best = max(rows, key=lambda r: r["patches_per_sec"])
    print(f"bench_loader: best {best['patches_per_sec']:.1f} patches/s ({best['path']}, "
          f"{best['workers']} workers) on {cores} cores; the step needs {need:.1f} patches/s "
          f"({source}): margin {best['patches_per_sec'] / need:.2f}x", flush=True)
    print("bench_loader result " + json.dumps(
        {"hw": args.hw, "batch": args.batch, "n_samples": args.n_samples, "rows": rows,
         "cores": cores, "need": need, "need_source": source,
         "margin": best["patches_per_sec"] / need, "card": card(dev)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
