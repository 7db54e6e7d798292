"""Supervised UNet source models on LIVECell, one per cell type (port of
``experiments/LIVECell/livecell_unet.py``):

  --train     UNet2d (depth 4, 64 initial features, sigmoid), dice loss,
              Adam 1e-4, 100k iterations, 256^2 patches, batch 4
              (reference :14-59)
  --predict   tiled predictions for every source x target pair (:62-87)
  --evaluate  dice against the ground truth (:90-104)

    python -m pda_torch.experiments.livecell_unet --train --predict --evaluate \\
        [--data ./data/livecell/] [--pred_path ./predictions/livecell/] \\
        [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, cell_types=..., device="cpu")`` narrows the
cell types and runs on the CPU. UNet2d runs no kernel of the port.
"""

from __future__ import annotations

import argparse
import os

from ..data.builders import CELL_TYPES, get_livecell_loader
from ..eval import run_dice_evaluation
from ..infer import unet_prediction
from ..models import UNet2d
from ..train import UNetTrainer, checkpoint_dir, checkpoint_exists, load_params
from .common import MESH_HELP, on_main_rank, rank_device, release


def make_model(device="cuda"):
    return UNet2d(
        in_channels=1, out_channels=1, final_activation="sigmoid",
        depth=4, initial_features=64,
    ).to(device)


def _train_one(args, ctype, patch_shape, device, mesh):
    train_loader = get_livecell_loader(
        path=args.data, split="train", binary=True, patch_shape=patch_shape,
        batch_size=4, cell_types=[ctype], download=True,
    )
    val_loader = get_livecell_loader(
        path=args.data, split="val", binary=True, patch_shape=patch_shape,
        batch_size=1, cell_types=[ctype], download=True,
    )
    trainer = UNetTrainer(
        name=f"unet-source-livecell-{ctype}",
        model=make_model(device),
        train_loader=train_loader,
        val_loader=val_loader,
        learning_rate=1e-4,
        save_root=args.save_root,
        log_image_interval=1000,
        mesh=mesh,
        device=device,
    )
    trainer.fit(args.iterations or 100_000)
    release(trainer)


def do_unet_training(args, patch_shape=(256, 256), *, cell_types=CELL_TYPES, device="cuda",
                     mesh=None):
    for ctype in cell_types:
        _train_one(args, ctype, patch_shape, device, mesh)


def do_unet_predictions(args, *, cell_types=CELL_TYPES, device="cuda"):
    model = make_model(device)
    for ctype1 in cell_types:
        ckpt = checkpoint_dir(f"unet-source-livecell-{ctype1}", args.save_root)
        if not checkpoint_exists(ckpt):
            print("The source model couldn't be found/hasn't been trained yet")
            continue
        model.load_state_dict(load_params(ckpt))
        for ctype2 in cell_types:
            input_path = os.path.join(
                args.data, "images", "livecell_test_images", f"{ctype2}*.tif"
            )
            output_path = os.path.join(args.pred_path, "unet_source", ctype1, ctype2)
            # pda's pattern, which matches nothing in LIVECell's per-type
            # folders: search one folder down
            unet_prediction(input_path, output_path, model, search_subfolders=True)


def do_unet_evaluations(args, *, cell_types=CELL_TYPES):
    for ctype1 in cell_types:
        gt_dir = os.path.join(
            args.data, "annotations", "livecell_test_images", ctype1, "*"
        )
        for ctype2 in cell_types:
            pred_dir = os.path.join(args.pred_path, "unet_source", ctype2, ctype1)
            if not os.path.exists(pred_dir):
                print("The source model predictions couldn't be found")
                continue
            run_dice_evaluation(gt_dir, pred_dir)
            print(f"Dice for Target Cells - {ctype1} from Source Cells - {ctype2}")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--predict", action="store_true")
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--data", type=str, default="./data/livecell/")
    parser.add_argument("--pred_path", type=str, default="./predictions/livecell/")
    parser.add_argument("--save_root", type=str, default=None)
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--mesh", type=str, default=None, help=MESH_HELP)
    return parser


def main(argv=None, *, cell_types=CELL_TYPES, device="cuda"):
    args = get_parser().parse_args(argv)
    mesh, device = rank_device(args, device)
    if args.train:
        print("Training a 2D UNet on LiveCELL dataset")
        do_unet_training(args, cell_types=cell_types, device=device, mesh=mesh)
    if args.predict:
        print("Getting predictions on LiveCELL dataset from the trained UNet")
        on_main_rank(mesh, do_unet_predictions, args, cell_types=cell_types, device=device)
    if args.evaluate:
        print("Evaluating the UNet predictions of LiveCELL dataset")
        on_main_rank(mesh, do_unet_evaluations, args, cell_types=cell_types)


if __name__ == "__main__":
    main()
