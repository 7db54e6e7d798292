"""The supervised UNet source model on MitoEM (port of
``experiments/MitoEM/mitoem_unet.py``): one ``unet-source-mitoem`` model
(UNet2d, depth 4, 64 initial features, sigmoid), Adam 1e-5, 100k
iterations on the MitoEM source loaders; tiled predictions and dice on
vnc, lucchi and urocell.

    python -m pda_torch.experiments.mitoem_unet --train --predict --evaluate \\
        [--data ./data/] [--pred_path ./predictions/] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU. UNet2d runs
no kernel of the port.
"""

from __future__ import annotations

import os

from ..eval import run_dice_evaluation
from ..infer import unet_prediction
from ..models import UNet2d
from ..train import UNetTrainer, checkpoint_dir, checkpoint_exists, load_params
from . import mitoem_common as common
from .common import on_main_rank, rank_device, release, standard_parser


def make_model(device="cuda"):
    return UNet2d(in_channels=1, out_channels=1, final_activation="sigmoid", depth=4,
                  initial_features=64).to(device)


def do_unet_training(args, *, device="cuda", mesh=None):
    train_loader, val_loader = common.get_mitoem_loaders(os.path.join(args.data, "mitoem"))
    trainer = UNetTrainer(
        name="unet-source-mitoem",
        model=make_model(device),
        train_loader=train_loader,
        val_loader=val_loader,
        learning_rate=1e-5,
        save_root=args.save_root,
        log_image_interval=1000,
        mesh=mesh,
        device=device,
    )
    trainer.fit(args.iterations or 100_000)
    release(trainer)


def do_unet_predictions(args, em_type: str, *, device="cuda"):
    ckpt = checkpoint_dir("unet-source-mitoem", args.save_root)
    if not checkpoint_exists(ckpt):
        print("The source model couldn't be found / hasn't been trained yet")
        return
    model = make_model(device)
    model.load_state_dict(load_params(ckpt))
    output_path = os.path.join(args.pred_path, "unet_predictions", em_type)
    unet_prediction(common.em_input_glob(args.data, em_type), output_path, model)


def get_parser():
    return standard_parser(__doc__)


def main(argv=None, *, device="cuda"):
    args = get_parser().parse_args(argv)
    mesh, device = rank_device(args, device)
    if args.train:
        print("Training a 2D UNet on MitoEM dataset")
        do_unet_training(args, device=device, mesh=mesh)
    if args.predict:
        for em_type in common.EM_TYPES:
            on_main_rank(mesh, do_unet_predictions, args, em_type, device=device)
    if args.evaluate:
        for em_type in common.EM_TYPES:
            output_path = os.path.join(args.pred_path, "unet_predictions", em_type)
            on_main_rank(mesh, run_dice_evaluation, common.em_gt_glob(args.data, em_type),
                         output_path, subtype=em_type)


if __name__ == "__main__":
    main()
