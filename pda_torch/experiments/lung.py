"""The Lung X-Ray suite's shared pieces (port of ``pda/experiments/lung.py``):
each domain's train/val loaders, the test-image and ground-truth folders,
and the 4x3 cross-domain loop of the two domain-adaptation methods, which
the thin CLIs (:mod:`.lung_mt`, :mod:`.lung_adamt`) call through
:func:`da_run`:

  mean-teacher  MeanTeacherTrainer, weak views on both sides, 10k
                iterations, student and teacher warm-started from
                ``punet-source-lung-<source>``'s best.pt, the teacher predicts
  adamt         AdaMTTrainer on the source's supervised patches beside the
                target's weak views, 100k iterations, the teacher predicts

Both use the Lung PUNet (BCE reconstruction, :func:`.common.lung_punet`),
Adam 1e-5 and ReduceLROnPlateau(0.9, 10); predictions are tiled MC-16 and
scored by the lung dice runner. ``domains`` narrows the loop (default
:data:`LUNG_DOMAINS`) and ``device`` chooses the card (default) or the CPU;
each pair's trainer is released (:func:`.common.release`) before the next
pair starts.
"""

from __future__ import annotations

import os

from ..data.builders import LUNG_DOMAINS, get_lung_loader
from ..eval import run_lung_dice_evaluation
from ..infer import punet_prediction
from ..train import (
    BEST,
    AdaMTTrainer,
    MeanTeacherTrainer,
    ReduceLROnPlateau,
    checkpoint_dir,
    checkpoint_exists,
    load_params,
)
from ..train.checkpoint import checkpoint_path
from .common import (
    da_name,
    lung_data_path,
    lung_punet,
    on_main_rank,
    rank_device,
    release,
    weak_augmentations,
)

PRED_SUBDIR = {"mean-teacher": "mean_teacher", "adamt": "adamt"}


def get_lung_loaders(domain: str, root: str, augs=None, batch_train: int = 2):
    """One domain's train (batch ``batch_train``) and val (batch 1) loaders,
    two-view with ``augs`` on both views where given (reference
    lung_punet.py:14-49, lung_mt.py:29-60)."""
    kwargs = {} if augs is None else {"augmentation1": augs, "augmentation2": augs}
    train = get_lung_loader(domain, lung_data_path(root, domain), "train",
                            batch_size=batch_train, **kwargs)
    val = get_lung_loader(domain, lung_data_path(root, domain), "val", batch_size=1, **kwargs)
    return train, val


def test_image_glob(root: str, domain: str) -> str:
    return {
        "jsrt1": os.path.join(root, "jsrt1", "test", "org", "*"),
        "jsrt2": os.path.join(root, "jsrt2", "org_test", "*"),
        "nih": os.path.join(root, "nih_processed", "images", "test", "*"),
        "montgomery": os.path.join(root, "montgomery_processed", "images", "test", "*"),
    }[domain]


def test_gt_dir(root: str, domain: str) -> str:
    return {
        "jsrt1": os.path.join(root, "jsrt1", "test", "label") + os.sep,
        "jsrt2": os.path.join(root, "jsrt2", "label_test") + os.sep,
        "nih": os.path.join(root, "nih_processed", "labels", "test") + os.sep,
        "montgomery": os.path.join(root, "montgomery_processed", "labels", "test") + os.sep,
    }[domain]


def _train_pair(args, method: str, src: str, trg: str, device, mesh) -> None:
    """Build, fit and release one (source, target) pair's trainer."""
    name = da_name(method, "lung", src, trg, args.consensus, args.masking)
    model = lung_punet(consensus_masking=args.consensus, device=device)
    common = dict(learning_rate=1e-5, lr_scheduler=ReduceLROnPlateau(factor=0.9, patience=10),
                  save_root=args.save_root, log_image_interval=10,
                  do_consensus_masking=args.masking, mesh=mesh,
                  device=device)
    augs = weak_augmentations()
    if method == "mean-teacher":
        src_dir = checkpoint_dir(f"punet-source-lung-{src}", args.save_root)
        if not checkpoint_exists(src_dir):
            print("The source checkpoint couldn't be found")
            return
        src_ckpt = checkpoint_path(src_dir, BEST)
        train_l, val_l = get_lung_loaders(trg, args.data, augs=augs)
        trainer = MeanTeacherTrainer(name, model, train_l, val_l, ckpt_model=src_ckpt,
                                     ckpt_teacher=src_ckpt, **common)
        iters = 10_000
    elif method == "adamt":
        # pda builds the source's val loader too and never reads it
        src_train, src_val = get_lung_loaders(src, args.data)
        src_val.close()
        tgt_train, tgt_val = get_lung_loaders(trg, args.data, augs=augs)
        trainer = AdaMTTrainer(name, model, src_train, tgt_train, tgt_val, **common)
        iters = 100_000
    else:
        raise ValueError(method)
    trainer.fit(args.iterations or iters)
    release(trainer)


def da_train(args, method: str, *, domains=LUNG_DOMAINS, device="cuda", mesh=None) -> None:
    """The 4x3 cross-domain self-training (reference lung_mt.py:63-155,
    lung_adamt.py)."""
    for trg in domains:
        for src in domains:
            if src == trg:
                continue
            print(f"Transferring {src} learnings on {trg} using {method}")
            _train_pair(args, method, src, trg, device, mesh)


def da_predict(args, method: str, *, domains=LUNG_DOMAINS, device="cuda") -> None:
    """Tiled MC-16 predictions of every trained pair on the target's test
    images, with the teacher's weights."""
    model = lung_punet(device=device)
    for src in domains:
        for trg in domains:
            if src == trg:
                continue
            name = da_name(method, "lung", src, trg, args.consensus, args.masking)
            ckpt = checkpoint_dir(name, args.save_root)
            if not checkpoint_exists(ckpt):
                print("The model couldn't be found/hasn't been trained yet")
                continue
            model.load_state_dict(load_params(ckpt, key="teacher_state"))
            output_path = os.path.join(args.pred_path, PRED_SUBDIR[method],
                                       f"source-{src}-target-{trg}")
            punet_prediction(test_image_glob(args.data, trg), output_path, model,
                             prior_samples=16)


def da_evaluate(args, method: str, *, domains=LUNG_DOMAINS) -> None:
    for src in domains:
        for trg in domains:
            if src == trg:
                continue
            pred_dir = os.path.join(args.pred_path, PRED_SUBDIR[method],
                                    f"source-{src}-target-{trg}") + os.sep
            if not os.path.exists(pred_dir):
                print("The predictions couldn't be found/haven't been generated")
                continue
            run_lung_dice_evaluation(test_gt_dir(args.data, trg), pred_dir, lung_domain=trg)
            print(f"Dice on {trg} from {src}")


def da_run(args, method: str, *, domains=LUNG_DOMAINS, device="cuda") -> None:
    mesh, device = rank_device(args, device)
    if args.train:
        print(f"Training PUNet with {method} on Lung X-Ray datasets")
        da_train(args, method, domains=domains, device=device, mesh=mesh)
    if args.predict:
        print(f"Getting {method} predictions on Lung X-Ray datasets")
        on_main_rank(mesh, da_predict, args, method, domains=domains, device=device)
    if args.evaluate:
        print(f"Evaluating {method} predictions")
        on_main_rank(mesh, da_evaluate, args, method, domains=domains)
