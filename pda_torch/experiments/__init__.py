"""Experiment plumbing (port of ``pda.experiments``): the shared
configuration (:mod:`.common`) and the LIVECell, MitoEM and Lung X-Ray
suites' command lines, each run as ``python -m pda_torch.experiments.<name>``:

  livecell_prepare_data  images, annotations and label TIFFs
  livecell_punet         supervised PUNet source models
  livecell_punet_target  pseudo-label export and PUNets on pseudo-labels
  livecell_unet          supervised UNet2d source models
  livecell_mt, livecell_fm, livecell_adamt, livecell_adamatch
                         the domain-adaptation methods (:mod:`.livecell_da`)
  mitoem_prepare_data    the VNC, Lucchi++, UroCell and MitoEM volumes
  mitoem_punet, mitoem_unet
                         the MitoEM source models, predicted and scored on
                         vnc, lucchi and urocell
  mitoem_mt, mitoem_fm, mitoem_adamt, mitoem_adamatch
                         the domain-adaptation methods (:mod:`.mitoem_da`,
                         loaders in :mod:`.mitoem_common`)
  lung_prepare_data      Montgomery and NIH resized to 256^2, JSRT copied
  lung_punet, lung_unet  the Lung X-Ray source models, one a domain,
                         predicted and scored on every domain
  lung_mt, lung_adamt    the 4x3 domain-adaptation pairs (:mod:`.lung`)

The flagship's factory is ``pda_torch.experiments.common.livecell_punet``
and the Lung PUNet's ``pda_torch.experiments.common.lung_punet`` (``pda``
exports both here too): in this package the names ``livecell_punet`` and
``lung_punet`` are the factories, the command-line modules are imported by
their full names.
"""

from .common import (
    adamatch_strong_augmentations,
    da_name,
    fm_strong_augmentations,
    lung_data_path,
    lung_punet,
    mitoem_strong_augmentations,
    standard_parser,
    weak_augmentations,
)

__all__ = [
    "weak_augmentations",
    "fm_strong_augmentations",
    "adamatch_strong_augmentations",
    "mitoem_strong_augmentations",
    "lung_punet",
    "da_name",
    "standard_parser",
    "lung_data_path",
]
