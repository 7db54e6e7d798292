"""The supervised PUNet source model on MitoEM (port of
``experiments/MitoEM/mitoem_punet.py``):

  --train     one source model ``punet-source-mitoem`` (the flagship PUNet)
              on the MitoEM volumes with MinForegroundSampler(0.05), 512^2
              patches, batch 4, Adam 1e-5 and ReduceLROnPlateau(0.9, 10),
              100k iterations
  --predict   tiled MC prediction on the vnc, lucchi and urocell raw frames
  --evaluate  dice against each target's ground truth, names remapped

    python -m pda_torch.experiments.mitoem_punet --train --predict --evaluate \\
        [--data ./data/] [--pred_path ./predictions/] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os

from ..eval import run_dice_evaluation
from ..infer import punet_prediction
from ..train import PUNetTrainer, ReduceLROnPlateau, checkpoint_dir, checkpoint_exists, load_params
from . import mitoem_common as common
from .common import (mitoem_punet, on_main_rank, rank_device, release,
                     standard_parser)


def do_punet_training(args, *, device="cuda", mesh=None):
    train_loader, val_loader = common.get_mitoem_loaders(os.path.join(args.data, "mitoem"))
    trainer = PUNetTrainer(
        name="punet-source-mitoem",
        model=mitoem_punet(device=device),
        train_loader=train_loader,
        val_loader=val_loader,
        learning_rate=1e-5,
        lr_scheduler=ReduceLROnPlateau(factor=0.9, patience=10),
        save_root=args.save_root,
        log_image_interval=1000,
        mesh=mesh,
        device=device,
    )
    trainer.fit(args.iterations or 100_000)
    release(trainer)


def do_punet_predictions(args, em_type: str, *, device="cuda"):
    ckpt = checkpoint_dir("punet-source-mitoem", args.save_root)
    if not checkpoint_exists(ckpt):
        print("The source model couldn't be found / hasn't been trained yet")
        return
    model = mitoem_punet(device=device)
    model.load_state_dict(load_params(ckpt))
    output_path = os.path.join(args.pred_path, "punet_predictions", em_type)
    punet_prediction(common.em_input_glob(args.data, em_type), output_path, model)


def do_punet_evaluations(args, em_type: str):
    output_path = os.path.join(args.pred_path, "punet_predictions", em_type)
    run_dice_evaluation(common.em_gt_glob(args.data, em_type), output_path, subtype=em_type)


def get_parser():
    return standard_parser(__doc__)


def main(argv=None, *, device="cuda"):
    args = get_parser().parse_args(argv)
    mesh, device = rank_device(args, device)
    if args.train:
        print("Training a 2D PUNet on MitoEM dataset")
        do_punet_training(args, device=device, mesh=mesh)
    if args.predict:
        print("Getting predictions on Lucchi / VNC / UroCell datasets")
        for em_type in common.EM_TYPES:
            on_main_rank(mesh, do_punet_predictions, args, em_type, device=device)
    if args.evaluate:
        print("Evaluating the PUNet predictions")
        for em_type in common.EM_TYPES:
            on_main_rank(mesh, do_punet_evaluations, args, em_type)


if __name__ == "__main__":
    main()
