"""The MitoEM suite's volumes (port of ``experiments/MitoEM/prepare_data.py``):
fetches each archive the suite needs where it is missing, then builds the
VNC and Lucchi++ volumes, the UroCell volumes and their evaluation slices,
and (unless ``--skip_mitoem``) the MitoEM source volumes, with the port's
codecs.

    python -m pda_torch.experiments.mitoem_prepare_data [--data ./data/] [--skip_mitoem]

``device`` is accepted as by the other CLIs and unused (no model runs here).
"""

from __future__ import annotations

import argparse
import os

from ..data.builders.em import _get_vnc_data, _require_lucchi_data
from ..data.builders.prepare import prepare_mitoem_sample, prepare_urocell_slices


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="./data/")
    parser.add_argument(
        "--skip_mitoem", action="store_true",
        help="Skip the MitoEM zips (tens of GB; the source-training volumes).")
    return parser


def main(argv=None, *, device="cuda"):
    args = get_parser().parse_args(argv)
    _get_vnc_data(os.path.join(args.data, "vnc"), download=True)
    print("vnc volumes ready")
    _require_lucchi_data(os.path.join(args.data, "lucchi"), download=True)
    print("lucchi volumes ready")
    prepare_urocell_slices(args.data, download=True)
    print("urocell volumes + evaluation slices ready")
    if not args.skip_mitoem:
        for sample in ("human", "rat"):
            prepare_mitoem_sample(os.path.join(args.data, "mitoem"), sample, download=True)
        print("mitoem volumes ready")


if __name__ == "__main__":
    main()
