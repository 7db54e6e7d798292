"""Dataset builders (port of ``pda/data/builders``): LIVECell (COCO).

The EM volume builders (MitoEM, VNC, Lucchi, UroCell) and the Lung X-Ray
folders are still to come (ROADMAP §1)."""

from .livecell import (
    CELL_TYPES,
    compute_class_distribution,
    get_dual_livecell_loader,
    get_livecell_loader,
    get_my_livecell_loader,
)

__all__ = [
    "CELL_TYPES",
    "get_livecell_loader",
    "get_my_livecell_loader",
    "get_dual_livecell_loader",
    "compute_class_distribution",
]
