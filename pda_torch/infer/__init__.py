from .predict import (  # noqa: F401
    full_punet_pseudo,
    padded_unet_probs,
    punet_prediction,
    punet_pseudo_prediction,
    tiled_punet_probs,
    tiled_unet_probs,
    unet_prediction,
)
from .tiling import (  # noqa: F401
    extract_tiles,
    pad_to_divisible,
    stitch_tiles,
    tile_standardize,
)
