"""Dataset builders (port of ``pda/data/builders``): LIVECell (COCO) and
the EM volumes (MitoEM, VNC, Lucchi++, UroCell).

The Lung X-Ray folders are still to come (ROADMAP §1)."""

from .em import (
    get_lucchi_loader,
    get_mitoem_loader,
    get_uro_cell_loader,
    get_vnc_mito_loader,
)
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
    "get_mitoem_loader",
    "get_vnc_mito_loader",
    "get_lucchi_loader",
    "get_uro_cell_loader",
]
