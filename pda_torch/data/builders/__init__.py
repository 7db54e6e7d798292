"""Dataset builders (port of ``pda/data/builders``): LIVECell (COCO), the
EM volumes (MitoEM, VNC, Lucchi++, UroCell) and the Lung X-Ray folders
(JSRT segmentation01 and 02, NIH, Montgomery) with their prepare step."""

from .em import (
    get_lucchi_loader,
    get_mitoem_loader,
    get_uro_cell_loader,
    get_vnc_mito_loader,
)
from .lung import (
    LUNG_DOMAINS,
    get_jsrt_s1_loader,
    get_jsrt_s2_loader,
    get_lung_loader,
    get_montgomery_loader,
    get_nih_loader,
    my_label_transform,
    prepare_montgomery,
    prepare_nih,
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
    "LUNG_DOMAINS",
    "my_label_transform",
    "get_jsrt_s1_loader",
    "get_jsrt_s2_loader",
    "get_nih_loader",
    "get_montgomery_loader",
    "get_lung_loader",
    "prepare_montgomery",
    "prepare_nih",
]
