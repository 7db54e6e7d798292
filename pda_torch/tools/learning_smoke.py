"""Does the port learn? The source PUNet trained on synthetic blobs
(``pda``'s ``development/learning_smoke.py``).

    python -m pda_torch.tools.learning_smoke [--iterations 300] [--batch 8]
        [--save_root DIR] [--float32] [--num_workers 4] [--device cuda|cpu]

A PUNet (16, 32, 64, 96), latent 6, Fcomb 3, rl_swap, seeded weights, on
``pda_torch/data/synthetic.py``'s 96x96 blob frames (24 to train, 8 to
validate, seed 7), 64^2 patches, batch 8, Adam 1e-3 with the plateau
controller, ``mixed_precision=True`` as ``pda`` runs it (``--float32``: off):
``PUNetTrainer.fit`` then a validation. Prints the validation dice by
epoch, the final dice against the bar of 0.5, the fit's patches/s, the
host's seconds by part of the loop (``Trainer.timings``) and, on the card,
each kernel's launches (bf16: also those on the wgmma bodies,
``launches_wgmma_bf16``). The checkpoints go to
``<save_root>/checkpoints/learning-smoke`` (default ``save_root``: a
folder in the temporary directory), where :mod:`.mt_smoke` reads them.
Exits 1 if the final dice is not above the bar.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from . import ab
from .common import add_device_arg, card, tool_device

FILTERS = (16, 32, 64, 96)
ITERATIONS, BATCH, LR, BAR = 300, 8, 1e-3, 0.5
NAME = "learning-smoke"
SAVE_ROOT = os.path.join(tempfile.gettempdir(), "pda_torch_smoke")


def learner(save_root: str, device, *, batch: int = BATCH, mixed_precision: bool = True,
            num_workers: int = 4, seed: int = 0):
    """The smoke's ``PUNetTrainer`` (no logger)."""
    from ..data import ImageCollectionDataset, Loader
    from ..data.synthetic import make_dataset_arrays
    from ..models import ProbabilisticUnet
    from ..train import PUNetTrainer, ReduceLROnPlateau

    raws, labels = make_dataset_arrays(32, (96, 96), seed=7)
    train_ds = ImageCollectionDataset(raws[:24], labels[:24], patch_shape=(64, 64),
                                      n_samples=batch * 16)
    val_ds = ImageCollectionDataset(raws[24:], labels[24:], patch_shape=(64, 64))
    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=6, no_convs_fcomb=3, beta=1.0,
                              rl_swap=True, generator=torch.Generator().manual_seed(seed))
    return PUNetTrainer(NAME, model, Loader(train_ds, batch, seed=0, num_workers=num_workers),
                        Loader(val_ds, 4, seed=1), learning_rate=LR,
                        lr_scheduler=ReduceLROnPlateau(), save_root=save_root, logger=False,
                        device=device, mixed_precision=mixed_precision)


def run(trainer, iterations: int) -> dict:
    """``trainer.fit(iterations)`` then a validation: {"stats": the fit's,
    "final": the validation's metrics, "wall": seconds of both}."""
    t0 = time.perf_counter()
    stats = trainer.fit(iterations)
    final = trainer.validate()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return {"stats": stats, "final": final, "wall": time.perf_counter() - t0}


def launches(wrappers, bf16: bool) -> dict:
    """The launches since :func:`ab.reset_launches`; in bf16 also each
    wrapper's launches on the wgmma bodies (``<name>_wgmma``)."""
    out = ab.read_launches(wrappers, bf16)
    if bf16:
        out.update({f"{k}_wgmma": w.launches_wgmma_bf16 for k, w in wrappers.items()
                    if hasattr(w, "launches_wgmma_bf16")})
    return out


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=ITERATIONS)
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--save_root", default=SAVE_ROOT)
    parser.add_argument("--float32", action="store_true", help="mixed_precision=False")
    parser.add_argument("--num_workers", type=int, default=4)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "learning_smoke")
    bf16 = not args.float32
    trainer = learner(args.save_root, dev, batch=args.batch, mixed_precision=bf16,
                      num_workers=args.num_workers)
    wrappers = ab.kernel_wrappers()
    ab.reset_launches(wrappers)
    out = run(trainer, args.iterations)
    dice = out["final"]["dice"]
    finite = all(math.isfinite(v) for _, h in trainer.history for v in h.values())
    ok = dice > BAR and finite
    result = {"iterations": args.iterations, "batch": args.batch,
              "mixed_precision": bf16, "filters": list(FILTERS),
              "dice_by_epoch": [round(m["dice"], 4) for _, m in trainer.val_history],
              "dice": dice, "bar": BAR, "learning_rate": trainer.state.learning_rate,
              "patches_per_sec": out["stats"]["patches_per_sec"], "seconds": out["wall"],
              "host_seconds": dict(trainer.timings),
              "launches": launches(wrappers, bf16) if dev.type == "cuda" else None,
              "checkpoint": trainer.ckpt_dir, "card": card(dev)}
    print("learning_smoke result " + json.dumps({**result, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
