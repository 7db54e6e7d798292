"""The Lung X-Ray suite's data (port of ``experiments/Lung-XRay/prepare_data.py``):
Montgomery's left and right lung masks merged and every image and mask
resized to 256^2 with an 80/20 train/test split, NIH's images and masks
resized to 256^2 in their own splits, and JSRT's two trees copied into the
jsrt1/jsrt2 layout; the port's PNG codec and numpy resize, no OpenCV.

    python -m pda_torch.experiments.lung_prepare_data INPUT --data OUT
        INPUT holds the distributed trees data/Montgomery/MontgomerySet,
        data/NIH, jsrt/Segmentation01 and jsrt/segmentation02/segmentation;
        the prepared and copied datasets land under OUT
    python -m pda_torch.experiments.lung_prepare_data --data ROOT
        ROOT holds montgomery/ and nih/ (and jsrt1/, jsrt2/ as distributed);
        montgomery_processed/ and nih_processed/ are written beside them
"""

from __future__ import annotations

import argparse
import os
from shutil import copytree

from ..data.builders import prepare_montgomery, prepare_nih


def get_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("input", nargs="?", default=None,
                        help="Raw distribution root (reference layout); "
                             "omit to use the combined --data layout")
    parser.add_argument("--data", type=str, default="./data/lung/",
                        help="Output root (with INPUT) or combined raw+output "
                             "root (without)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.input is not None:
        mont_raw = os.path.join(args.input, "data", "Montgomery", "MontgomerySet")
        nih_raw = os.path.join(args.input, "data", "NIH")
        jsrt1_raw = os.path.join(args.input, "jsrt", "Segmentation01")
        jsrt2_raw = os.path.join(args.input, "jsrt", "segmentation02", "segmentation")
    else:
        mont_raw = os.path.join(args.data, "montgomery")
        nih_raw = os.path.join(args.data, "nih")
        jsrt1_raw = jsrt2_raw = None

    if os.path.exists(mont_raw):
        out = os.path.join(args.data, "montgomery_processed")
        os.makedirs(out, exist_ok=True)
        prepare_montgomery(mont_raw, out)
        print("montgomery prepared")
    if os.path.exists(nih_raw):
        out = os.path.join(args.data, "nih_processed")
        os.makedirs(out, exist_ok=True)
        prepare_nih(nih_raw, out)
        print("nih prepared")
    for src, name in ((jsrt1_raw, "jsrt1"), (jsrt2_raw, "jsrt2")):
        if src and os.path.exists(src):
            dst = os.path.join(args.data, name)
            if not os.path.exists(dst):
                copytree(src, dst)
            print(f"{name} copied")
    if args.input is None:
        print("jsrt1/jsrt2 are used in their distributed layout — nothing to do")


if __name__ == "__main__":
    main()
