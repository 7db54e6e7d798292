"""Experiment plumbing (port of ``pda.experiments``): the shared
configuration (:mod:`.common`) and the LIVECell and MitoEM suites' command
lines, each run as ``python -m pda_torch.experiments.<name>``:

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

The Lung X-Ray suite is still to come (ROADMAP §1). The
flagship's factory is ``pda_torch.experiments.common.livecell_punet``
(``pda`` exports it here too): the name ``livecell_punet`` in this package
is the command-line module.
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
