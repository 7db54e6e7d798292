"""``chip_smoke.py``'s engine check of the 128^2 Mean-Teacher fit, card vs
CPU, over views and loader draws.

    python -m pda_torch.tools.fit_check_seeds [--seeds 0,1,2] [--views numpy,native]

Run from the repository root (it imports ``chip_smoke``). For each view
(``PDA_NATIVE_AUGS`` "0" or "1") and each offset of the train loader's seed,
the flagship's MT fit at 128^2 (2 steps, 1 validation) runs on the card, on
the CPU in float32 and on the CPU in float64 (``chip_smoke.small_mt_fits``),
and ``chip_smoke.check_fit`` judges it: each step's gradients, and the final
student and teacher within 1e-6 of the interval Adam maps each step's
gradient, give or take its measured error, to. Prints its line and the
seconds a draw. The
first native draw loads the native library, which sets flush-to-zero in the
process (``pda_torch.data.native``): a seed given twice runs its numpy draw
without and with it. Needs a CUDA card; TF32 off for cuDNN and matmul.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--views", default="numpy,native")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fit_check_seeds: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from pda_torch.data.native import augmentation_path
    from pda_torch.tools.ab import kernel_wrappers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    wrappers = kernel_wrappers()
    good = True
    with tempfile.TemporaryDirectory() as root:
        for run, seed in enumerate(int(s) for s in args.seeds.split(",")):
            for views in args.views.split(","):
                t0 = time.perf_counter()
                with augmentation_path(native=views == "native"):
                    fits, grads, _, init, _, _ = cs.small_mt_fits(
                        os.path.join(root, f"{run}{views}"), dev, wrappers, loader_seed=seed)
                good &= cs.check_fit(f"fit check, {views} views, loader seed +{seed}",
                                     fits["card"], fits["cpu"], grads, init, cs.MT_LR)
                print(f"  {time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
