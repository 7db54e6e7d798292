"""The four LIVECell domain-adaptation experiments (port of
``pda/experiments/livecell_da.py``).

The reference scripts livecell_{mt,fm,adamt,adamatch}.py differ only in the
trainer class, the augmentation recipe, the iteration budget and which
weights predict; this module holds their common 8x7 cross-cell-type loop,
and the thin CLIs (:mod:`.livecell_mt`, :mod:`.livecell_fm`,
:mod:`.livecell_adamt`, :mod:`.livecell_adamatch`) call :func:`run` with
their method's name.

  mean-teacher  MeanTeacherTrainer, weak/weak views 512^2 batch 2, 10k
                iterations, student and teacher warm-started from the
                source run's best.pt, the teacher predicts
  fixmatch      FixMatchTrainer, weak/strong (p 0.9) views 512^2 batch 2, 10k
                iterations, the student warm-started, distribution alignment
                from the exported source pseudo-labels, the student predicts
  adamt         AdaMTTrainer, source patches 256^2 batch 2 beside target
                weak/weak views, 100k iterations, the teacher predicts
  adamatch      AdaMatchTrainer, weak/strong (p 0.5), 100k iterations, the
                student predicts

``cell_types`` narrows the loop and ``device`` chooses the card (default)
or the CPU; each pair's trainer is released (:func:`.common.release`)
before the next pair starts.
"""

from __future__ import annotations

import os

from ..data.builders import (
    CELL_TYPES,
    compute_class_distribution,
    get_dual_livecell_loader,
    get_livecell_loader,
)
from ..eval import run_dice_evaluation
from ..infer import punet_prediction
from ..train import (
    BEST,
    AdaMatchTrainer,
    AdaMTTrainer,
    FixMatchTrainer,
    MeanTeacherTrainer,
    ReduceLROnPlateau,
    checkpoint_dir,
    checkpoint_exists,
    load_params,
)
from ..train.checkpoint import checkpoint_path
from .common import (
    adamatch_strong_augmentations,
    da_name,
    fm_strong_augmentations,
    livecell_punet,
    on_main_rank,
    rank_device,
    release,
    weak_augmentations,
)

PRED_SUBDIR = {
    "mean-teacher": "mean_teacher",
    "fixmatch": "fixmatch",
    "adamt": "adamt",
    "adamatch": "adamatch",
}


def _dual_loaders(data_path, ctype, patch_shape, aug1, aug2):
    train = get_dual_livecell_loader(
        path=data_path, binary=True, split="train", patch_shape=patch_shape,
        batch_size=2, cell_types=[ctype], augmentation1=aug1, augmentation2=aug2,
        download=True,
    )
    val = get_dual_livecell_loader(
        path=data_path, binary=True, split="val", patch_shape=patch_shape,
        batch_size=1, cell_types=[ctype], augmentation1=aug1, augmentation2=aug2,
        download=True,
    )
    return train, val


def _train_pair(args, method, src, trg, device, mesh):
    """Build, fit and release one (source, target) pair's trainer."""
    name = da_name(method, "livecell", src, trg, args.consensus, args.masking)
    model = livecell_punet(consensus_masking=args.consensus, device=device)
    sched = ReduceLROnPlateau(factor=0.9, patience=10)
    common = dict(
        learning_rate=1e-5,
        lr_scheduler=sched,
        save_root=args.save_root,
        log_image_interval=10,
        mesh=mesh,
        device=device,
    )

    if method in ("mean-teacher", "fixmatch"):
        src_ckpt_dir = checkpoint_dir(f"punet-source-livecell-{src}", args.save_root)
        if not checkpoint_exists(src_ckpt_dir):
            print(
                "The checkpoint directory couldn't be found/"
                "source network hasn't been trained"
            )
            return
        src_ckpt = checkpoint_path(src_ckpt_dir, BEST)

        if method == "mean-teacher":
            weak = weak_augmentations()
            train_l, val_l = _dual_loaders(args.data, trg, (512, 512), weak, weak)
            trainer = MeanTeacherTrainer(
                name, model, train_l, val_l,
                ckpt_model=src_ckpt, ckpt_teacher=src_ckpt,
                do_consensus_masking=args.masking, **common,
            )
        else:
            train_l, val_l = _dual_loaders(
                args.data, trg, (512, 512),
                weak_augmentations(), fm_strong_augmentations(),
            )
            src_dist = None
            if getattr(args, "distribution_alignment", True):
                pred_folder = os.path.join(
                    args.pred_path, "punet_source_predictions", src,
                    "annotations", "livecell_train_val_images", trg,
                )
                if os.path.exists(pred_folder):
                    src_dist = compute_class_distribution(pred_folder)
                else:
                    print(f"no source pseudo-labels at {pred_folder}; "
                          "training without distribution alignment")
            trainer = FixMatchTrainer(
                name, model, train_l, val_l,
                ckpt_model=src_ckpt,
                source_distribution=src_dist,
                do_consensus_masking=args.masking, **common,
            )
        iters = 10_000
    else:
        source_train = get_livecell_loader(
            path=args.data, split="train", binary=True,
            patch_shape=(256, 256), batch_size=2, cell_types=[src],
            download=True,
        )
        if method == "adamt":
            weak = weak_augmentations()
            tgt_train, tgt_val = _dual_loaders(args.data, trg, (256, 256), weak, weak)
            trainer = AdaMTTrainer(
                name, model, source_train, tgt_train, tgt_val,
                do_consensus_masking=args.masking, **common,
            )
        else:
            tgt_train, tgt_val = _dual_loaders(
                args.data, trg, (256, 256),
                weak_augmentations(), adamatch_strong_augmentations(),
            )
            trainer = AdaMatchTrainer(
                name, model, source_train, tgt_train, tgt_val,
                do_consensus_masking=args.masking, **common,
            )
        iters = 100_000

    trainer.fit(args.iterations or iters)
    release(trainer)


def train(args, method: str, *, cell_types=CELL_TYPES, device="cuda", mesh=None):
    for trg in cell_types:
        for src in cell_types:
            if src == trg:
                continue
            print(f"Transferring {src} network learnings on {trg} using {method}")
            _train_pair(args, method, src, trg, device, mesh)


def predict(args, method: str, *, cell_types=CELL_TYPES, device="cuda"):
    """Tiled MC-16 predictions of every trained pair on the target's test
    images: the teacher's weights for Mean Teacher and AdaMT, the student's
    otherwise."""
    use_teacher = method in ("mean-teacher", "adamt")
    model = livecell_punet(device=device)
    for trg in cell_types:
        for src in cell_types:
            if src == trg:
                continue
            name = da_name(method, "livecell", src, trg, args.consensus, args.masking)
            ckpt = checkpoint_dir(name, args.save_root)
            if not checkpoint_exists(ckpt):
                print("The model couldn't be found/hasn't been trained yet")
                continue
            model.load_state_dict(load_params(
                ckpt, key="teacher_state" if use_teacher else "model_state"))
            input_path = os.path.join(
                args.data, "images", "livecell_test_images", f"{trg}*"
            )
            output_path = os.path.join(
                args.pred_path, PRED_SUBDIR[method], f"source-{src}-target-{trg}"
            )
            punet_prediction(input_path, output_path, model, prior_samples=16)


def evaluate(args, method: str, *, cell_types=CELL_TYPES):
    for trg in cell_types:
        gt_path = os.path.join(
            args.data, "annotations", "livecell_test_images", trg, "*"
        )
        for src in cell_types:
            if src == trg:
                continue
            pred_dir = os.path.join(
                args.pred_path, PRED_SUBDIR[method], f"source-{src}-target-{trg}"
            )
            if not os.path.exists(pred_dir):
                print("The model predictions haven't been generated, hence no evaluation")
                continue
            run_dice_evaluation(gt_path, pred_dir)
            print(f"dice for {trg} from {src}-{trg}")


def run(args, method: str, *, cell_types=CELL_TYPES, device="cuda"):
    mesh, device = rank_device(args, device)
    if args.train:
        print(f"Training PUNet with {method} on LiveCELL dataset")
        train(args, method, cell_types=cell_types, device=device, mesh=mesh)
    if args.predict:
        print(f"Getting {method} predictions on LiveCELL dataset")
        on_main_rank(mesh, predict, args, method, cell_types=cell_types, device=device)
    if args.evaluate:
        print(f"Evaluating {method} predictions of LiveCELL dataset")
        on_main_rank(mesh, evaluate, args, method, cell_types=cell_types)
