from .consensus import (  # noqa: F401
    LOWER_THRESHOLD,
    UPPER_THRESHOLD,
    consensus_from_logits,
    consensus_from_probs,
)
from .distributions import DiagGaussian, kl_divergence  # noqa: F401
