"""AdaMT joint source and target Mean-Teacher training on LIVECell (port of
``experiments/LIVECell/livecell_adamt.py``): each step one supervised source
ELBO and one teacher-pseudo-label target ELBO, averaged, the EMA ramped as
min(1 - 1/(t+1), 0.999), 256^2 patches, 100k iterations. The teacher
predicts (reference :166).

    python -m pda_torch.experiments.livecell_adamt --train --predict --evaluate \
        [--consensus] [--masking] [--data ./data/livecell/] [--pred_path DIR] \
        [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, cell_types=..., device="cpu")`` narrows the
cell types and runs on the CPU.
"""

from __future__ import annotations

from ..data.builders import CELL_TYPES
from .common import standard_parser
from .livecell_da import run


def get_parser():
    parser = standard_parser(__doc__, extra_flags=("consensus",))
    return parser


def main(argv=None, *, cell_types=CELL_TYPES, device="cuda"):
    args = get_parser().parse_args(argv)
    args.data = args.data if args.data != "./data/" else "./data/livecell/"
    run(args, "adamt", cell_types=cell_types, device=device)


if __name__ == "__main__":
    main()
