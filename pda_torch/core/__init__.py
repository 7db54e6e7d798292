from .consensus import (  # noqa: F401
    LOWER_THRESHOLD,
    UPPER_THRESHOLD,
    consensus_from_logits,
    consensus_from_probs,
    distribution_alignment,
)
from .distributions import DiagGaussian, kl_divergence, mc_kl_divergence  # noqa: F401
from .ema import ema_update, ramped_momentum  # noqa: F401
from .losses import bce_with_logits, dice_loss, dice_loss_with_logits, neg_elbo  # noqa: F401
from .metrics import dice_score, dice_score_torch  # noqa: F401
from .regularization import l2_regularisation  # noqa: F401
