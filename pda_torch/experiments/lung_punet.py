"""Supervised PUNet source models on Lung X-Ray, one a domain (port of
``experiments/Lung-XRay/lung_punet.py``):

  --train     ``punet-source-lung-<domain>`` for each domain: the Lung PUNet
              (the flagship with a BCE reconstruction), 256^2 patches,
              batch 2, Adam 1e-5 and ReduceLROnPlateau(0.9, 10), 100k
              iterations
  --predict   tiled MC-16 predictions of every source model on every
              domain's test images
  --evaluate  lung dice of each (source, target)

    python -m pda_torch.experiments.lung_punet --train --predict --evaluate \\
        [--data ./data/] [--pred_path ./predictions/] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU, and
``domains`` narrows the domains.
"""

from __future__ import annotations

import os

from ..data.builders import LUNG_DOMAINS
from ..eval import run_lung_dice_evaluation
from ..infer import punet_prediction
from ..train import PUNetTrainer, ReduceLROnPlateau, checkpoint_dir, checkpoint_exists, load_params
from .common import (lung_punet, on_main_rank, rank_device, release,
                     standard_parser)
from .lung import get_lung_loaders, test_gt_dir, test_image_glob


def do_punet_training(args, *, domains=LUNG_DOMAINS, device="cuda", mesh=None):
    for domain in domains:
        train_loader, val_loader = get_lung_loaders(domain, args.data)
        trainer = PUNetTrainer(
            name=f"punet-source-lung-{domain}",
            model=lung_punet(device=device),
            train_loader=train_loader,
            val_loader=val_loader,
            learning_rate=1e-5,
            lr_scheduler=ReduceLROnPlateau(factor=0.9, patience=10),
            save_root=args.save_root,
            log_image_interval=100,
            mesh=mesh,
            device=device,
        )
        trainer.fit(args.iterations or 100_000)
        release(trainer)


def do_punet_predictions(args, *, domains=LUNG_DOMAINS, device="cuda"):
    model = lung_punet(device=device)
    for src in domains:
        ckpt = checkpoint_dir(f"punet-source-lung-{src}", args.save_root)
        if not checkpoint_exists(ckpt):
            print("The source model couldn't be found/hasn't been trained yet")
            continue
        model.load_state_dict(load_params(ckpt))
        for trg in domains:
            output_path = os.path.join(args.pred_path, "punet_source",
                                       f"source-{src}-target-{trg}")
            punet_prediction(test_image_glob(args.data, trg), output_path, model,
                             prior_samples=16)


def do_punet_evaluations(args, *, domains=LUNG_DOMAINS):
    for src in domains:
        for trg in domains:
            pred_dir = os.path.join(args.pred_path, "punet_source",
                                    f"source-{src}-target-{trg}") + os.sep
            if not os.path.exists(pred_dir):
                print("The punet predictions couldn't be found")
                continue
            run_lung_dice_evaluation(test_gt_dir(args.data, trg), pred_dir, trg)
            print(f"Dice on {trg} from {src}")


def get_parser():
    return standard_parser(__doc__)


def main(argv=None, *, domains=LUNG_DOMAINS, device="cuda"):
    args = get_parser().parse_args(argv)
    mesh, device = rank_device(args, device)
    if args.train:
        print("Training PUNet source models on Lung X-Ray datasets")
        do_punet_training(args, domains=domains, device=device, mesh=mesh)
    if args.predict:
        print("Getting PUNet predictions on Lung X-Ray datasets")
        on_main_rank(mesh, do_punet_predictions, args, domains=domains, device=device)
    if args.evaluate:
        print("Evaluating the PUNet predictions")
        on_main_rank(mesh, do_punet_evaluations, args, domains=domains)


if __name__ == "__main__":
    main()
