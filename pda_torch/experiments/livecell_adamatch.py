"""AdaMatch joint source and target training on LIVECell, no teacher (port
of ``experiments/LIVECell/livecell_adamatch.py``): supervised source
patches beside self-pseudo-labels on weak/strong target views (blur 0.6-3,
noise 0.05-0.25, contrast 0.33-3, p 0.5), 256^2 patches, 100k iterations.
The student predicts.

    python -m pda_torch.experiments.livecell_adamatch --train --predict --evaluate \
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
    run(args, "adamatch", cell_types=cell_types, device=device)


if __name__ == "__main__":
    main()
