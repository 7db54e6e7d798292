"""Supervised UNet source models on Lung X-Ray, one a domain (port of
``experiments/Lung-XRay/lung_unet.py``): ``unet-source-lung-<domain>``
(UNet2d, depth 4, 64 initial features, sigmoid), dice loss, Adam 1e-5, 100k
iterations on the domain's loaders; padded predictions of every source
model on every domain's test images, and the lung dice of each.

    python -m pda_torch.experiments.lung_unet --train --predict --evaluate \\
        [--data ./data/] [--pred_path ./predictions/] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU, and
``domains`` narrows the domains. UNet2d runs no kernel of the port.
"""

from __future__ import annotations

import os

from ..data.builders import LUNG_DOMAINS
from ..eval import run_lung_dice_evaluation
from ..infer import unet_prediction
from ..models import UNet2d
from ..train import UNetTrainer, checkpoint_dir, checkpoint_exists, load_params
from .common import on_main_rank, rank_device, release, standard_parser
from .lung import get_lung_loaders, test_gt_dir, test_image_glob


def make_model(device="cuda"):
    return UNet2d(in_channels=1, out_channels=1, final_activation="sigmoid", depth=4,
                  initial_features=64).to(device)


def do_unet_training(args, *, domains=LUNG_DOMAINS, device="cuda", mesh=None):
    for domain in domains:
        train_loader, val_loader = get_lung_loaders(domain, args.data)
        trainer = UNetTrainer(
            name=f"unet-source-lung-{domain}",
            model=make_model(device),
            train_loader=train_loader,
            val_loader=val_loader,
            learning_rate=1e-5,
            save_root=args.save_root,
            log_image_interval=100,
            mesh=mesh,
            device=device,
        )
        trainer.fit(args.iterations or 100_000)
        release(trainer)


def do_unet_predictions(args, *, domains=LUNG_DOMAINS, device="cuda"):
    model = make_model(device)
    for src in domains:
        ckpt = checkpoint_dir(f"unet-source-lung-{src}", args.save_root)
        if not checkpoint_exists(ckpt):
            print("The source model couldn't be found/hasn't been trained yet")
            continue
        model.load_state_dict(load_params(ckpt))
        for trg in domains:
            output_path = os.path.join(args.pred_path, "unet_source",
                                       f"source-{src}-target-{trg}")
            unet_prediction(test_image_glob(args.data, trg), output_path, model)


def do_unet_evaluations(args, *, domains=LUNG_DOMAINS):
    for src in domains:
        for trg in domains:
            pred_dir = os.path.join(args.pred_path, "unet_source",
                                    f"source-{src}-target-{trg}") + os.sep
            if not os.path.exists(pred_dir):
                print("The source model predictions couldn't be found")
                continue
            run_lung_dice_evaluation(test_gt_dir(args.data, trg), pred_dir, trg)
            print(f"Dice on {trg} from {src}")


def get_parser():
    return standard_parser(__doc__)


def main(argv=None, *, domains=LUNG_DOMAINS, device="cuda"):
    args = get_parser().parse_args(argv)
    mesh, device = rank_device(args, device)
    if args.train:
        print("Training 2D UNet on Lung X-Ray datasets")
        do_unet_training(args, domains=domains, device=device, mesh=mesh)
    if args.predict:
        print("Getting predictions on Lung X-Ray datasets from the trained UNet")
        on_main_rank(mesh, do_unet_predictions, args, domains=domains, device=device)
    if args.evaluate:
        print("Evaluating the UNet predictions of Lung X-Ray datasets")
        on_main_rank(mesh, do_unet_evaluations, args, domains=domains)


if __name__ == "__main__":
    main()
