"""PUNet target self-training on LIVECell through pseudo-labels on disk
(port of ``experiments/LIVECell/livecell_punet_target.py``), in three
stages:

  --get_pseudo_labels  MC-16 whole-image pseudo-labels and consensus masks
                       from every source model (reference :14-53)
  --train              PseudoTrainerPUNet for every (source, target) pair,
                       256^2 patches, batch 2, consensus weighting with
                       --consensus (:56-117)
  --predict/--evaluate tiled MC-16 predictions and dice (:120-172)

    python -m pda_torch.experiments.livecell_punet_target --get_pseudo_labels \\
        --train --predict --evaluate [--consensus] [--data ./data/livecell/] \\
        [--pred_path ./predictions/livecell/] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, cell_types=..., device="cpu")`` narrows the
cell types and runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

from ..data.builders import CELL_TYPES, get_my_livecell_loader
from ..eval import run_dice_evaluation
from ..infer import punet_prediction, punet_pseudo_prediction
from ..train import (
    PseudoTrainerPUNet,
    ReduceLROnPlateau,
    checkpoint_dir,
    checkpoint_exists,
    load_params,
)
from .common import livecell_punet, release


def do_punet_source_predictions(args, *, cell_types=CELL_TYPES, device="cuda"):
    """Pseudo-labels and consensus masks of every (source model, cell type)
    pair into punet_source_predictions/<src>/ (reference :14-53)."""
    model = livecell_punet(device=device)
    for cellname in cell_types:
        ckpt = checkpoint_dir(f"punet-source-livecell-{cellname}", args.save_root)
        if not checkpoint_exists(ckpt):
            print("The source trained model couldn't be found/hasn't been trained yet")
            continue
        model.load_state_dict(load_params(ckpt))
        for cellname_ in cell_types:
            split_name = "livecell_train_val_images"
            input_path = os.path.join(args.data, "images", split_name)
            output_path = os.path.join(
                args.pred_path, "punet_source_predictions", cellname
            ) + os.sep
            punet_pseudo_prediction(
                input_path, output_path, model,
                prior_samples=16, cellname=cellname_, split_name=split_name,
            )


def _train_pair(args, src, trg, patch_shape, device):
    pseudo_label_path = os.path.join(args.pred_path, "punet_source_predictions", src)
    train_loader = get_my_livecell_loader(
        path=args.data, split="train", patch_shape=patch_shape,
        batch_size=2, cell_types=[trg], label_path=pseudo_label_path,
    )
    val_loader = get_my_livecell_loader(
        path=args.data, split="val", patch_shape=patch_shape,
        batch_size=1, cell_types=[trg], label_path=pseudo_label_path,
    )
    my_name = f"punet-livecell-source-{src}-target-{trg}"
    trainer = PseudoTrainerPUNet(
        name=my_name if not args.consensus else my_name + "-consensus",
        model=livecell_punet(consensus_masking=args.consensus, device=device),
        train_loader=train_loader,
        val_loader=val_loader,
        learning_rate=1e-5,
        lr_scheduler=ReduceLROnPlateau(factor=0.9, patience=10),
        save_root=args.save_root,
        log_image_interval=1000,
        device=device,
    )
    trainer.fit(args.iterations or 100_000)
    release(trainer)


def do_punet_target_training(args, patch_shape=(256, 256), *, cell_types=CELL_TYPES,
                             device="cuda"):
    for trg in cell_types:
        for src in cell_types:
            if src == trg:
                continue
            print(f"Transferring {src} learnings on {trg}")
            _train_pair(args, src, trg, patch_shape, device)


def do_punet_target_predictions(args, *, cell_types=CELL_TYPES, device="cuda"):
    model = livecell_punet(device=device)
    for trg in cell_types:
        for src in cell_types:
            if src == trg:
                continue
            name = f"punet-livecell-source-{src}-target-{trg}"
            if args.consensus:
                name += "-consensus"
            ckpt = checkpoint_dir(name, args.save_root)
            if not checkpoint_exists(ckpt):
                print("The model couldn't be found/hasn't been trained yet")
                continue
            model.load_state_dict(load_params(ckpt))
            input_path = os.path.join(
                args.data, "images", "livecell_test_images", f"{trg}*"
            )
            output_path = os.path.join(
                args.pred_path, "punet_target", f"source-{src}-target-{trg}"
            )
            punet_prediction(input_path, output_path, model, prior_samples=16)


def do_punet_target_evaluations(args, *, cell_types=CELL_TYPES):
    for trg in cell_types:
        gt_path = os.path.join(
            args.data, "annotations", "livecell_test_images", trg, "*"
        )
        for src in cell_types:
            if src == trg:
                continue
            pred_dir = os.path.join(
                args.pred_path, "punet_target", f"source-{src}-target-{trg}"
            )
            if not os.path.exists(pred_dir):
                print("The predictions haven't been generated, hence no evaluation")
                continue
            run_dice_evaluation(gt_path, pred_dir)
            print(f"dice for {trg} from {src}-{trg}")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--get_pseudo_labels", action="store_true")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--predict", action="store_true")
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--consensus", action="store_true")
    parser.add_argument("--data", type=str, default="./data/livecell/")
    parser.add_argument("--pred_path", type=str, default="./predictions/livecell/")
    parser.add_argument("--save_root", type=str, default=None)
    parser.add_argument("--iterations", type=int, default=None)
    return parser


def main(argv=None, *, cell_types=CELL_TYPES, device="cuda"):
    args = get_parser().parse_args(argv)
    if args.get_pseudo_labels:
        print("Generating pseudo labels + consensus masks from source models")
        do_punet_source_predictions(args, cell_types=cell_types, device=device)
    if args.train:
        print("Training PUNet on pseudo labels (target self-training)")
        do_punet_target_training(args, cell_types=cell_types, device=device)
    if args.predict:
        print("Getting target PUNet predictions")
        do_punet_target_predictions(args, cell_types=cell_types, device=device)
    if args.evaluate:
        print("Evaluating target PUNet predictions")
        do_punet_target_evaluations(args, cell_types=cell_types)


if __name__ == "__main__":
    main()
