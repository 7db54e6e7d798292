"""Mean-Teacher PUNet self-training, MitoEM -> {vnc, lucchi, urocell} (port
of ``experiments/MitoEM/mitoem_mt.py``): weak views on both sides, as the
reference passes (mitoem_mt.py:22-23), 512^2 patches, batch 4, 10k
iterations, student and teacher warm-started from punet-source-mitoem's
best.pt, EMA 0.999. The teacher predicts.

    python -m pda_torch.experiments.mitoem_mt --train --predict --evaluate \
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
    run(get_parser().parse_args(argv), "mean-teacher", mitoem_common, device=device)


if __name__ == "__main__":
    main()
