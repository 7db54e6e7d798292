from .blocks import (  # noqa: F401
    ConvBlock,
    EncoderPyramid,
    UpBlock,
    avg_pool_2x2,
    upsample_2x_align_corners,
)
from .convert import state_dict_from_pda  # noqa: F401
from .punet import (  # noqa: F401
    Fcomb,
    GaussianEncoder,
    ProbabilisticUnet,
    PUNetEncoding,
    livecell_punet,
    mc_decode_logits,
    mc_predict_probs,
    mc_pseudo,
)
from .unet import PUNetBackbone  # noqa: F401
