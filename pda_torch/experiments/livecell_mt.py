"""Mean-Teacher PUNet self-training on LIVECell, every (source, target) pair
(port of ``experiments/LIVECell/livecell_mt.py``): weak views on both sides
(512^2 patches, batch 2, 10k iterations), student and teacher warm-started
from the source run's best.pt, EMA 0.999; the teacher's MC-16 pseudo-labels
and consensus in the step. The teacher predicts.

    python -m pda_torch.experiments.livecell_mt --train --predict --evaluate \
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
    run(args, "mean-teacher", cell_types=cell_types, device=device)


if __name__ == "__main__":
    main()
