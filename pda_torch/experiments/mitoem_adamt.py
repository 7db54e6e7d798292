"""AdaMT joint training, MitoEM source + {vnc, lucchi, urocell} targets (port
of ``experiments/MitoEM/mitoem_adamt.py``): the supervised source ELBO on
MitoEM patches beside the teacher-pseudo target ELBO on weak/weak views,
ramped EMA, 10k iterations; ``--type`` trains one target. The teacher
predicts.

    python -m pda_torch.experiments.mitoem_adamt --train --predict --evaluate \
        [--type vnc|lucchi|urocell] [--consensus] [--masking] [--data ./data/] \
        [--pred_path DIR] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

from . import mitoem_common
from .common import standard_parser
from .mitoem_da import run


def get_parser():
    return standard_parser(__doc__, extra_flags=('consensus', 'type'))


def main(argv=None, *, device="cuda"):
    run(get_parser().parse_args(argv), "adamt", mitoem_common, device=device)


if __name__ == "__main__":
    main()
