"""Mean-Teacher PUNet self-training on Lung X-Ray, 4x3 cross-domain (port
of ``experiments/Lung-XRay/lung_mt.py``): weak views on both sides, student
and teacher warm-started from the source domain's ``punet-source-lung-*``
best.pt, 10k iterations, EMA 0.999. The teacher predicts.

    python -m pda_torch.experiments.lung_mt --train --predict --evaluate \\
        [--consensus] [--masking] [--data ./data/] [--pred_path DIR] \\
        [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU, and
``domains`` narrows the domains.
"""

from __future__ import annotations

from ..data.builders import LUNG_DOMAINS
from .common import standard_parser
from .lung import da_run


def get_parser():
    return standard_parser(__doc__, extra_flags=("consensus",))


def main(argv=None, *, domains=LUNG_DOMAINS, device="cuda"):
    da_run(get_parser().parse_args(argv), "mean-teacher", domains=domains, device=device)


if __name__ == "__main__":
    main()
