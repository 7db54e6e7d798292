"""Shared experiment configuration (port of ``pda/experiments/common.py``):
the augmentation recipes, the model configurations, checkpoint naming and
the common command line.

The weak views run in the native library under ``PDA_NATIVE_AUGS`` (default
``"1"``), as ``pda``'s do; ``"0"`` selects the numpy recipe. The models are
built on the card unless the caller passes ``device="cpu"``. Checkpoint names are ``pda``'s, which
are the reference's (they tie the --train, --predict and --evaluate phases
together); as in ``pda``, masking takes precedence over weighting in a name.
``--mesh`` is parsed as ``pda`` parses it and gives a data mesh, or a
(data, space) mesh that also shards image rows, over ``torch.distributed``
(:mod:`pda_torch.parallel`), one process a rank:
``torchrun --nproc-per-node N -m pda_torch.experiments.<cli> --mesh data=N``,
``torchrun --nproc-per-node N*M ... --mesh data=N,space=M``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Union

import torch

from ..data import native
from ..data.transforms import (
    AdditiveGaussianNoise,
    Compose,
    GaussianBlur,
    RandomApply,
    RandomContrast,
    standardize,
)
from ..models import ProbabilisticUnet
from ..models.punet import livecell_punet

Device = Union[str, torch.device]


def weak_augmentations(p: float = 0.25):
    """Weak views: standardize, then blur and noise (0-0.15), each with
    probability ``p`` (reference LIVECell/livecell_mt.py:16-26,
    MitoEM/common.py:51-58, Lung-XRay/lung_mt.py:16-26): one native call a
    sample under ``PDA_NATIVE_AUGS``, else the numpy ``Compose``."""
    if native.enabled():
        return native.NativeWeakAugmentation(p=p)
    return Compose(
        standardize,
        RandomApply([GaussianBlur()], p=p),
        RandomApply([AdditiveGaussianNoise(scale=(0, 0.15), clip_kwargs=False)], p=p),
    )


def fm_strong_augmentations(p: float = 0.9):
    """FixMatch strong views: blur sigma 1-4, noise 0.1-0.35, contrast
    0.33-3, each with probability ``p`` (reference LIVECell/livecell_fm.py:56-67)."""
    return Compose(
        standardize,
        RandomApply([GaussianBlur(sigma=(1.0, 4.0))], p=p),
        RandomApply([AdditiveGaussianNoise(scale=(0.1, 0.35), clip_kwargs=False)], p=p),
        RandomApply([RandomContrast(alpha=(0.33, 3), mean=0.0, clip_kwargs=False)], p=p),
    )


def adamatch_strong_augmentations(p: float = 0.5):
    """AdaMatch strong views: blur 0.6-3 (``p``), noise 0.05-0.25 (``p/2``),
    contrast 0.33-3 (``p``) (reference LIVECell/livecell_adamatch.py:29-40,
    MitoEM/common.py:60-68)."""
    return Compose(
        standardize,
        RandomApply([GaussianBlur(sigma=(0.6, 3.0))], p=p),
        RandomApply(
            [AdditiveGaussianNoise(scale=(0.05, 0.25), clip_kwargs=False)], p=p / 2
        ),
        RandomApply(
            [RandomContrast(mean=0.0, alpha=(0.33, 3.0), clip_kwargs=False)], p=p
        ),
    )


# MitoEM uses the AdaMatch recipe as its strong views (MitoEM/common.py:60-68).
mitoem_strong_augmentations = adamatch_strong_augmentations

# MitoEM uses the LIVECell architecture and loss (livecell_punet: the
# flagship, num_filters 64..512, latent 6, Fcomb 3, beta 1, rl_swap).
mitoem_punet = livecell_punet


def lung_punet(consensus_masking: bool = False, generator: Optional[torch.Generator] = None,
               device: Device = "cuda", dtype: torch.dtype = torch.float32) -> ProbabilisticUnet:
    """The Lung PUNet: the flagship with a BCE reconstruction
    (``rl_swap=False``, reference Lung-XRay/lung_punet.py:55-63), in
    ``dtype`` (float32, or bf16 compute with float32 parameters) as
    :func:`~pda_torch.models.punet.livecell_punet` takes it."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lung_punet: no CUDA card (torch.cuda.is_available() is False); "
                           "pass device='cpu' to build on the CPU")
    model = ProbabilisticUnet(input_channels=1, num_classes=1, num_filters=(64, 128, 256, 512),
                              latent_dim=6, no_convs_fcomb=3, beta=1.0, rl_swap=False,
                              consensus_masking=consensus_masking, generator=generator,
                              dtype=dtype)
    return model.to(device)


def da_name(
    method: str, suite: str, src: str, trg: str, consensus: bool, masking: bool
) -> str:
    """Domain-adaptation checkpoint name, e.g.
    ``mean-teacher-livecell-source-A172-target-BT474-consensus-weighting``
    (reference livecell_mt.py:87-92 et al.)."""
    base = f"{method}-{suite}-source-{src}-target-{trg}"
    if masking:
        return base + "-consensus-masking"
    if consensus:
        return base + "-consensus-weighting"
    return base


def standard_parser(description: str, extra_flags=()) -> argparse.ArgumentParser:
    """The reference's common command line: --train/--predict/--evaluate
    (+ --consensus/--masking, --get_pseudo_labels, --type where asked),
    --data, --pred_path, --source_checkpoints, --save_root, --iterations,
    --mesh (reference livecell_mt.py:199-222)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--predict", action="store_true")
    parser.add_argument("--evaluate", action="store_true")
    if "consensus" in extra_flags:
        parser.add_argument("--consensus", action="store_true",
                            help="Consensus weighting of the ELBO")
        parser.add_argument("--masking", action="store_true",
                            help="Consensus masking (binarized) of the ELBO")
    if "pseudo" in extra_flags:
        parser.add_argument("--get_pseudo_labels", action="store_true")
    if "type" in extra_flags:
        parser.add_argument(
            "--type", type=str, default=None,
            help="Whether to run on a particular type of data domain.",
        )
    parser.add_argument("--data", type=str, default="./data/")
    parser.add_argument("--pred_path", type=str, default="./predictions/")
    parser.add_argument("--source_checkpoints", type=str, default="checkpoints/")
    parser.add_argument("--save_root", type=str, default=None)
    parser.add_argument("--iterations", type=int, default=None,
                        help="Override the default iteration budget")
    parser.add_argument("--mesh", type=str, default=None, help=MESH_HELP)
    return parser


#: what ``--mesh`` takes in the port
MESH_HELP = ("Mesh over torch.distributed, one process a rank (additive over the "
             "reference CLI): 'auto' (the launcher's world, or 1 without torchrun), "
             "'data=N' (launch with torchrun --nproc-per-node N) or 'data=N,space=M' "
             "(M-way image-row sharding; torchrun --nproc-per-node N*M)")


def mesh_from_arg(args, device: Device = "cuda"):
    """The mesh asked for by ``--mesh`` (or the ``PDA_MESH`` environment
    variable), on ``device`` (its rank's card, or the CPU): None without
    one. ``auto`` is the launcher's world (a world of 1 without one);
    ``data=N`` needs a world of N (launched by ``torchrun --nproc-per-node
    N``) and raises, saying so, in another; ``data=N,space=M`` with M > 1
    is the (data, space) mesh of N * M ranks, as in ``pda``."""
    spec = getattr(args, "mesh", None) or os.environ.get("PDA_MESH")
    if not spec:
        return None
    from ..parallel import get_mesh, get_mesh_2d

    if spec == "auto":
        return get_mesh(device=device)
    axes = {}
    for token in spec.split(","):
        key, eq, value = token.partition("=")
        if not eq or key in axes or not value.isdigit() or int(value) < 1:
            raise ValueError(
                f"bad --mesh spec {spec!r}: expected "
                "'auto', 'data=N', or 'data=N,space=M' (N, M >= 1)"
            )
        axes[key] = int(value)
    n_data = axes.pop("data", 1)
    n_space = axes.pop("space", 1)
    if axes:
        raise ValueError(f"unknown mesh axes in --mesh: {sorted(axes)}")
    if n_space > 1:
        return get_mesh_2d(n_data, n_space, device=device)
    return get_mesh(n_data, device=device)


def rank_device(args, device: Device = "cuda"):
    """``(mesh, device)`` of a CLI run: the mesh asked for by ``--mesh`` (or
    None) and the device the run's models and trainers take, the rank's on a
    mesh."""
    mesh = mesh_from_arg(args, device)
    return mesh, (device if mesh is None else mesh.device)


def on_main_rank(mesh, phase, *args, **kwargs) -> None:
    """Run one of a CLI's file phases (predictions, pseudo-labels, dice) as
    ``pda``'s CLIs run them, on one device: on a mesh, on rank 0 alone, the
    other ranks waiting until it is done (the next phase may read its
    files)."""
    if mesh is None or mesh.rank == 0:
        phase(*args, **kwargs)
    if mesh is not None:
        mesh.wait_for_rank0()


def lung_data_path(root_input_dir: str, domain: str) -> str:
    """Per-domain lung data directory (reference Lung-XRay/lung_punet.py:14-49)."""
    sub = {
        "jsrt1": "jsrt1/",
        "jsrt2": "jsrt2/",
        "nih": "nih_processed/",
        "montgomery": "montgomery_processed/",
    }[domain]
    return os.path.join(root_input_dir, sub)


def release(trainer) -> None:
    """Stop a finished trainer's loader workers, close its logger's event
    file and drop its train state (optimizer moments, teacher), so that the
    next run of an experiment's loop starts on an empty card."""
    for name in ("train_loader", "val_loader", "source_train_loader", "target_train_loader",
                 "logger"):
        close = getattr(getattr(trainer, name, None), "close", None)
        if close is not None:
            close()
    if hasattr(trainer, "state"):
        trainer.state = None
