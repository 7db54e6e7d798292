from .blocks import (  # noqa: F401
    ConvBlock,
    EncoderPyramid,
    UpBlock,
    avg_pool_2x2,
    upsample_2x_align_corners,
)
from .convert import (  # noqa: F401
    backbone_state_dict_from_pda,
    state_dict_from_pda,
    unet_state_dict_from_pda,
)
from .punet import (  # noqa: F401
    Fcomb,
    GaussianEncoder,
    ProbabilisticUnet,
    PUNetEncoding,
    livecell_punet,
    mc_decode_logits,
    mc_predict_probs,
    mc_pseudo,
    uses_mc_kernel,
)
from .unet import PUNetBackbone, UNet2d  # noqa: F401
