"""LIVECell's images and COCO annotations, and the label TIFFs rasterized
from them (port of ``experiments/LIVECell/prepare_data.py``): fetches
images.zip and the train/test annotation JSONs where they are missing, then
writes a uint16 instance-label TIFF per train and test image.

    python -m pda_torch.experiments.livecell_prepare_data [--data ./data/livecell/]

``main(argv, cell_types=...)`` rasterizes only those cell types (all eight
by default); ``device`` is accepted as by the other CLIs and unused (no
model runs here).
"""

from __future__ import annotations

import argparse

from ..data.builders.livecell import (
    CELL_TYPES,
    _annotation_file,
    _download_images,
    _image_and_label_paths,
)


def download_livecell_data(path, cell_types=None):
    _download_images(path, download=True)
    for split in ("train", "test"):
        _annotation_file(path, split, download=True)
        _image_and_label_paths(path, split, download=True, cell_types=cell_types)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="./data/livecell/")
    return parser


def main(argv=None, *, cell_types=CELL_TYPES, device="cuda"):
    args = get_parser().parse_args(argv)
    download_livecell_data(args.data, cell_types)


if __name__ == "__main__":
    main()
