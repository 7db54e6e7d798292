"""AdaMT joint source and target training on Lung X-Ray, 4x3 cross-domain
(port of ``experiments/Lung-XRay/lung_adamt.py``): the supervised source
ELBO beside the teacher's pseudo-labelled target ELBO, the EMA ramped,
100k iterations. The teacher predicts.

    python -m pda_torch.experiments.lung_adamt --train --predict --evaluate \\
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
    da_run(get_parser().parse_args(argv), "adamt", domains=domains, device=device)


if __name__ == "__main__":
    main()
