"""Mean-Teacher self-training from a source checkpoint: does it keep or
improve the ground-truth dice? (``pda``'s ``development/mt_smoke.py``)

    python -m pda_torch.tools.mt_smoke [--iterations 50] [--contrast 1.0]
        [--noise 0.0] [--save_root DIR] [--num_workers 4] [--device cuda|cpu]

Student and teacher start from :mod:`.learning_smoke`'s best checkpoint
under ``--save_root`` (the smoke runs first, with its defaults, where there
is none; if that run fails its bar, so does this one, with no Mean Teacher
run). The target: ``pda_torch/data/synthetic.py``'s 96x96 frames (seed
99) scaled by ``--contrast`` plus Gaussian noise of ``--noise``, 24 to
train and 8 to validate; both views standardize and add noise (0-0.15),
64^2 patches, batch 8. ``MeanTeacherTrainer`` with consensus masking, Adam
1e-4, the plateau controller, ``mixed_precision=True``, MC-16 pseudo-labels.
Prints the student's ground-truth dice (1 - ``gt_metric``) before and after
``--iterations`` steps, the fit's patches/s and, on the card, each kernel's
bf16 launches and those on the wgmma bodies. Fails (exit 1) if the dice
after is below 0.5, or more than 0.05 below the dice before. ``pda``
records 0.844 -> 0.859 with no shift (its TPU, 50 steps).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from . import ab, learning_smoke
from .common import add_device_arg, card, tool_device

ITERATIONS, BATCH, LR = 50, 8, 1e-4
#: the dice after must be at least FLOOR, and at most DROP below the dice before
FLOOR, DROP = 0.5, 0.05


def trainer(save_root: str, device, ckpt: str, *, contrast: float = 1.0, noise: float = 0.0,
            num_workers: int = 4):
    """The smoke's ``MeanTeacherTrainer``, warm-started from ``ckpt``."""
    from ..data import AdditiveGaussianNoise, Compose, DualImageCollectionDataset, Loader
    from ..data import standardize
    from ..data.synthetic import make_dataset_arrays
    from ..models import ProbabilisticUnet
    from ..train import MeanTeacherTrainer, ReduceLROnPlateau

    raws, labels = make_dataset_arrays(32, (96, 96), seed=99)
    rng = np.random.default_rng(0)
    raws = [(contrast * r + noise * rng.standard_normal(r.shape)).astype(np.float32)
            for r in raws]
    aug = Compose(standardize, AdditiveGaussianNoise(scale=(0.0, 0.15)))
    tr = DualImageCollectionDataset(raws[:24], labels[:24], patch_shape=(64, 64),
                                    augmentation1=aug, augmentation2=aug, n_samples=128)
    va = DualImageCollectionDataset(raws[24:], labels[24:], patch_shape=(64, 64),
                                    augmentation1=aug, augmentation2=aug)
    model = ProbabilisticUnet(num_filters=learning_smoke.FILTERS, latent_dim=6,
                              no_convs_fcomb=3, beta=1.0, rl_swap=True, consensus_masking=True)
    return MeanTeacherTrainer("mt-smoke", model,
                              Loader(tr, BATCH, seed=0, num_workers=num_workers),
                              Loader(va, 4, seed=1), learning_rate=LR,
                              lr_scheduler=ReduceLROnPlateau(), save_root=save_root,
                              logger=False, mixed_precision=True, ckpt_model=ckpt,
                              ckpt_teacher=ckpt, do_consensus_masking=True, device=device)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=ITERATIONS)
    parser.add_argument("--contrast", type=float, default=1.0, help="the target's contrast scale")
    parser.add_argument("--noise", type=float, default=0.0,
                        help="the target's additive noise (standard deviation)")
    parser.add_argument("--save_root", default=learning_smoke.SAVE_ROOT)
    parser.add_argument("--num_workers", type=int, default=4)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "mt_smoke")
    from ..train import checkpoint_dir
    from ..train.checkpoint import checkpoint_exists

    ckpt = checkpoint_dir(learning_smoke.NAME, args.save_root)
    if not checkpoint_exists(ckpt):
        print(f"mt_smoke: no source checkpoint under {ckpt}: running learning_smoke first",
              flush=True)
        if learning_smoke.main(["--save_root", args.save_root, "--device", args.device,
                                "--num_workers", str(args.num_workers)]) != 0:
            print("mt_smoke result " + json.dumps({"ok": False, "failed": "learning_smoke",
                                                   "checkpoint": ckpt, "card": card(dev)}),
                  flush=True)
            return 1
    mt = trainer(args.save_root, dev, ckpt, contrast=args.contrast, noise=args.noise,
                 num_workers=args.num_workers)
    mt.initialize()
    before = 1.0 - mt.validate()["gt_metric"]
    wrappers = ab.kernel_wrappers()
    ab.reset_launches(wrappers)
    out = learning_smoke.run(mt, args.iterations)
    counts = learning_smoke.launches(wrappers, True) if dev.type == "cuda" else None
    after = 1.0 - out["final"]["gt_metric"]
    ok = after >= FLOOR and after >= before - DROP
    result = {"iterations": args.iterations, "contrast": args.contrast, "noise": args.noise,
              "gt_dice_before": before, "gt_dice_after": after, "floor": FLOOR, "drop": DROP,
              "patches_per_sec": out["stats"]["patches_per_sec"], "seconds": out["wall"],
              "host_seconds": dict(mt.timings), "launches": counts, "checkpoint": ckpt,
              "card": card(dev)}
    print("mt_smoke result " + json.dumps({**result, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
