"""FixMatch PUNet self-training, MitoEM -> {vnc, lucchi, urocell} (port of
``experiments/MitoEM/mitoem_fm.py``): weak and strong views, learning rate
1e-7 (mitoem_fm.py:39), 10k iterations, the student warm-started from
punet-source-mitoem's best.pt. The student predicts.

    python -m pda_torch.experiments.mitoem_fm --train --predict --evaluate \
        [--consensus] [--masking] [--data ./data/] [--pred_path DIR] \
        [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from . import mitoem_common
from .common import standard_parser
from .mitoem_da import run


def get_parser():
    return standard_parser(__doc__, extra_flags=('consensus',))


def main(argv=None, *, device="cuda"):
    run(get_parser().parse_args(argv), "fixmatch", mitoem_common, device=device)


if __name__ == "__main__":
    main()
