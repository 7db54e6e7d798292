"""FixMatch PUNet self-training on LIVECell, every (source, target) pair
(port of ``experiments/LIVECell/livecell_fm.py``): the student's MC-16
pseudo-labels on the weak view train it on the strong view (blur 1-4, noise
0.1-0.35, contrast 0.33-3, p 0.9), aligned to the class distribution of the
exported source pseudo-labels (run livecell_punet_target --get_pseudo_labels
first) unless --no_distribution_alignment; 10k iterations. The student
predicts.

    python -m pda_torch.experiments.livecell_fm --train --predict --evaluate \
        [--consensus] [--masking] [--no_distribution_alignment] \
        [--data ./data/livecell/] [--pred_path DIR] [--save_root DIR] [--iterations N]

Runs on the card; ``main(argv, cell_types=..., device="cpu")`` narrows the
cell types and runs on the CPU.
"""

from __future__ import annotations

from ..data.builders import CELL_TYPES
from .common import standard_parser
from .livecell_da import run


def get_parser():
    parser = standard_parser(__doc__, extra_flags=("consensus",))
    parser.add_argument(
        "--no_distribution_alignment", dest="distribution_alignment",
        action="store_false", default=True,
    )
    return parser


def main(argv=None, *, cell_types=CELL_TYPES, device="cuda"):
    args = get_parser().parse_args(argv)
    args.data = args.data if args.data != "./data/" else "./data/livecell/"
    run(args, "fixmatch", cell_types=cell_types, device=device)


if __name__ == "__main__":
    main()
