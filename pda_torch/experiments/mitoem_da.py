"""The four MitoEM -> {vnc, lucchi, urocell} domain-adaptation experiments
(port of ``pda/experiments/mitoem_da.py``): one source model,
``punet-source-mitoem``, three targets, checkpoint names
``<method>-mito-source-mitoem-target-<em>[-consensus-*]``, the loaders and
globs of :mod:`.mitoem_common`. The thin CLIs (:mod:`.mitoem_mt`,
:mod:`.mitoem_fm`, :mod:`.mitoem_adamt`, :mod:`.mitoem_adamatch`) call
:func:`run` with their method's name.

  mean-teacher  MeanTeacherTrainer, weak views on both sides (as the
                reference, mitoem_mt.py:22-23), student and teacher
                warm-started, the teacher predicts
  fixmatch      FixMatchTrainer, weak/strong views, lr 1e-7 (mitoem_fm.py:39),
                the student warm-started and predicting
  adamt         AdaMTTrainer on the MitoEM source loaders beside the target's
                weak/weak views, the teacher predicts
  adamatch      AdaMatchTrainer, weak/strong views, the student predicts

Each 10k iterations, plateau patience 5; ``--type`` restricts training to
one target. ``device`` chooses the card (default) or the CPU; each target's
trainer is released (:func:`.common.release`) before the next starts.
"""

from __future__ import annotations

import os

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
    da_name,
    on_main_rank,
    rank_device,
    mitoem_punet,
    mitoem_strong_augmentations,
    release,
    weak_augmentations,
)

EM_TYPES = ["vnc", "lucchi", "urocell"]

PRED_SUBDIR = {
    "mean-teacher": "mean_teacher",
    "fixmatch": "fixmatch",
    "adamt": "adamt",
    "adamatch": "adamatch",
}


def _suffix(args) -> str:
    if args.masking:
        return "-consensus-masking"
    if args.consensus:
        return "-consensus-weighting"
    return ""


def _train_target(args, method, em_data, common_mod, device, mesh):
    """Build, fit and release one target's trainer."""
    name = da_name(method, "mito", "mitoem", em_data, args.consensus, args.masking)
    model = mitoem_punet(consensus_masking=args.consensus, device=device)
    common_kw = dict(lr_scheduler=ReduceLROnPlateau(factor=0.9, patience=5),
                     save_root=args.save_root, log_image_interval=100,
                     mesh=mesh, device=device)

    if method in ("mean-teacher", "fixmatch"):
        src_root = (args.source_checkpoints if os.path.isabs(args.source_checkpoints or "")
                    else args.save_root)
        src_dir = checkpoint_dir("punet-source-mitoem", src_root)
        if not checkpoint_exists(src_dir):
            print("The checkpoint directory couldn't be found / source network hasn't been "
                  "trained")
            return
        src_ckpt = checkpoint_path(src_dir, BEST)
        if method == "mean-teacher":
            train_l, val_l = common_mod.get_dual_loaders(
                em_data=em_data, root_input_dir=args.data,
                weak_augs=weak_augmentations(), strong_augs=weak_augmentations())
            trainer = MeanTeacherTrainer(
                name, model, train_l, val_l, learning_rate=1e-5, ckpt_model=src_ckpt,
                ckpt_teacher=src_ckpt, do_consensus_masking=args.masking, **common_kw)
        else:
            train_l, val_l = common_mod.get_dual_loaders(
                em_data=em_data, root_input_dir=args.data,
                weak_augs=weak_augmentations(), strong_augs=mitoem_strong_augmentations())
            trainer = FixMatchTrainer(
                name, model, train_l, val_l, learning_rate=1e-7, ckpt_model=src_ckpt,
                do_consensus_masking=args.masking, **common_kw)
    else:
        source_train, _ = common_mod.get_mitoem_loaders(os.path.join(args.data, "mitoem"))
        strong = weak_augmentations() if method == "adamt" else mitoem_strong_augmentations()
        tgt_train, tgt_val = common_mod.get_dual_loaders(
            em_data=em_data, root_input_dir=args.data, weak_augs=weak_augmentations(),
            strong_augs=strong)
        cls = AdaMTTrainer if method == "adamt" else AdaMatchTrainer
        trainer = cls(name, model, source_train, tgt_train, tgt_val, learning_rate=1e-5,
                      do_consensus_masking=args.masking, **common_kw)

    trainer.fit(args.iterations or 10_000)
    release(trainer)


def train(args, method: str, common_mod, *, device="cuda", mesh=None):
    em_types = [args.type] if getattr(args, "type", None) else EM_TYPES
    for em_data in em_types:
        print(f"Training on {em_data} using {method}")
        _train_target(args, method, em_data, common_mod, device, mesh)


def predict(args, method: str, common_mod, *, device="cuda"):
    """Tiled MC predictions of every trained target on its raw frames: the
    teacher's weights for Mean Teacher and AdaMT, the student's otherwise."""
    use_teacher = method in ("mean-teacher", "adamt")
    model = mitoem_punet(device=device)
    for em_type in EM_TYPES:
        name = da_name(method, "mito", "mitoem", em_type, args.consensus, args.masking)
        ckpt = checkpoint_dir(name, args.save_root)
        if not checkpoint_exists(ckpt):
            print("The model couldn't be found / hasn't been trained yet")
            continue
        model.load_state_dict(load_params(
            ckpt, key="teacher_state" if use_teacher else "model_state"))
        output_path = os.path.join(args.pred_path, PRED_SUBDIR[method],
                                   f"source-mitoem-target-{em_type}{_suffix(args)}")
        punet_prediction(common_mod.em_input_glob(args.data, em_type), output_path, model)


def evaluate(args, method: str, common_mod):
    for em_type in EM_TYPES:
        output_path = os.path.join(args.pred_path, PRED_SUBDIR[method],
                                   f"source-mitoem-target-{em_type}{_suffix(args)}")
        if not os.path.exists(output_path):
            print("The predictions haven't been generated, hence no evaluation")
            continue
        run_dice_evaluation(common_mod.em_gt_glob(args.data, em_type), output_path,
                            subtype=em_type)


def run(args, method: str, common_mod, *, device="cuda"):
    mesh, device = rank_device(args, device)
    if args.train:
        print(f"Training PUNet with {method} on MitoEM targets")
        train(args, method, common_mod, device=device, mesh=mesh)
    if args.predict:
        print(f"Getting {method} predictions on MitoEM targets")
        on_main_rank(mesh, predict, args, method, common_mod, device=device)
    if args.evaluate:
        print(f"Evaluating {method} predictions")
        on_main_rank(mesh, evaluate, args, method, common_mod)
