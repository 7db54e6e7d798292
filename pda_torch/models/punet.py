"""Probabilistic U-Net (port of ``pda/models/punet.py``), NHWC.

``encode(x, segm=None) -> PUNetEncoding(features, prior, posterior)``;
``decode`` / ``decode_feature_term`` / ``decode_from_term`` as in ``pda``.
The first Fcomb 1x1 conv on ``concat([features, z_tiled])`` is split into a
spatial matmul on the features (``feature_term``, shared by all MC samples)
and a per-sample latent projection (``z_term``).

MC sampling: :func:`mc_decode_logits` is the plain path (the whole
``(n, B, H, W, C)`` logit stack); :func:`mc_pseudo` runs the per-sample tail
and the consensus in the MC-consensus kernel, which never writes that stack.
Noise is explicit everywhere: ``eps`` of shape ``(n, B, latent_dim)``, or a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.distributions import DiagGaussian
from ..kernels.mc_consensus import mc_consensus, mc_logits_plain
from .blocks import ConvParams, EncoderPyramid
from .unet import PUNetBackbone


class PUNetEncoding(NamedTuple):
    features: torch.Tensor  # (B, H, W, num_filters[0])
    prior: DiagGaussian  # (B, latent_dim)
    posterior: Optional[DiagGaussian]  # (B, latent_dim) when segm was given


class GaussianEncoder(nn.Module):
    """Conv pyramid -> global spatial mean -> 1x1 conv (a Dense) to
    2*latent_dim -> (mu, log_sigma), kept in float32 (reference
    ``AxisAlignedConvGaussian``)."""

    def __init__(self, input_channels: int, num_filters: Sequence[int], latent_dim: int = 6):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = EncoderPyramid(input_channels, num_filters)
        self.conv_layer = ConvParams(num_filters[-1], 2 * latent_dim, 1, init="orthogonal")

    def forward(self, x: torch.Tensor, segm: Optional[torch.Tensor] = None) -> DiagGaussian:
        if segm is not None:
            x = torch.cat([x, segm.to(x.dtype)], dim=-1)
        enc = self.encoder(x).mean(dim=(1, 2))
        stats = (enc @ self.conv_layer.dense() + self.conv_layer.bias).float()
        return DiagGaussian(stats[:, : self.latent_dim], stats[:, self.latent_dim:])


class Fcomb(nn.Module):
    """Latent sample + feature map -> logits via 1x1 convs (reference
    ``Fcomb``): ``layers`` = conv(C0+L -> C0), relu, (conv(C0 -> C0), relu) x
    (no_convs_fcomb - 2); then ``last_layer``."""

    def __init__(self, num_filters0: int, latent_dim: int, num_classes: int = 1,
                 no_convs_fcomb: int = 4):
        super().__init__()
        c0 = num_filters0
        self.num_filters0 = c0
        mods = [ConvParams(c0 + latent_dim, c0, 1, init="orthogonal",
                           row_blocks=(c0, latent_dim)), nn.ReLU()]
        for _ in range(no_convs_fcomb - 2):
            mods += [ConvParams(c0, c0, 1, init="orthogonal"), nn.ReLU()]
        self.layers = nn.Sequential(*mods)
        self.last_layer = ConvParams(c0, num_classes, 1, init="orthogonal")

    def convs(self) -> list:
        return [m for m in self.layers if isinstance(m, ConvParams)]

    def mid_layers(self) -> list:
        """(kernel (in, out), bias) of the mid layers, in layer order."""
        return [(m.dense(), m.bias) for m in self.convs()[1:]]

    def feature_term(self, features: torch.Tensor) -> torch.Tensor:
        """The z-independent half of the first 1x1 conv (no bias)."""
        return features @ self.convs()[0].dense()[: self.num_filters0]

    def z_term(self, z: torch.Tensor) -> torch.Tensor:
        """The latent half of the first 1x1 conv, with its bias: (..., C0)."""
        first = self.convs()[0]
        return z @ first.dense()[self.num_filters0:] + first.bias

    def decode_from_term(self, feat_term: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(feat_term + self.z_term(z)[:, None, None, :])
        for w, b in self.mid_layers():
            h = F.relu(h @ w + b)
        return (h @ self.last_layer.dense() + self.last_layer.bias).float()

    def forward(self, features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.decode_from_term(self.feature_term(features), z)


class ProbabilisticUnet(nn.Module):
    """Probabilistic U-Net (https://arxiv.org/abs/1806.05034), float32.

    Defaults mirror ``pda``'s; the experiments use ``num_filters=(64, 128,
    256, 512), no_convs_fcomb=3, beta=1, rl_swap=True``
    (:func:`livecell_punet`). ``beta``, ``rl_swap``, ``consensus_masking``
    and ``analytic_kl`` are loss settings the module carries, as in ``pda``;
    :func:`pda_torch.core.losses.neg_elbo` reads them. Parameters are drawn
    from ``generator`` (default: a CPU generator seeded 0) on the CPU; move
    the module with ``.to(device)``."""

    def __init__(self, input_channels: int = 1, num_classes: int = 1,
                 num_filters: Sequence[int] = (32, 64, 128, 192), latent_dim: int = 6,
                 no_convs_fcomb: int = 4, beta: float = 10.0,
                 consensus_masking: bool = False, rl_swap: bool = False,
                 analytic_kl: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        nf = tuple(num_filters)
        self.latent_dim = latent_dim
        self.beta = beta
        self.consensus_masking = consensus_masking
        self.rl_swap = rl_swap
        self.analytic_kl = analytic_kl
        self.unet = PUNetBackbone(input_channels, nf)
        self.prior = GaussianEncoder(input_channels, nf, latent_dim)
        self.posterior = GaussianEncoder(input_channels + num_classes, nf, latent_dim)
        self.fcomb = Fcomb(nf[0], latent_dim, num_classes, no_convs_fcomb)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, ConvParams):
                m.reset_parameters(generator)

    def encode(self, x: torch.Tensor, segm: Optional[torch.Tensor] = None) -> PUNetEncoding:
        posterior = self.posterior(x, segm) if segm is not None else None
        return PUNetEncoding(features=self.unet(x), prior=self.prior(x), posterior=posterior)

    def decode(self, features: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.fcomb(features, z)

    def decode_feature_term(self, features: torch.Tensor) -> torch.Tensor:
        return self.fcomb.feature_term(features)

    def decode_from_term(self, feat_term: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.fcomb.decode_from_term(feat_term, z)

    def forward(self, x: torch.Tensor, segm: Optional[torch.Tensor] = None) -> PUNetEncoding:
        return self.encode(x, segm)


def livecell_punet(consensus_masking: bool = False,
                   generator: Optional[torch.Generator] = None) -> ProbabilisticUnet:
    """The flagship PUNet every LIVECell/MitoEM/Lung experiment builds
    (``pda/experiments/common.py`` ``livecell_punet``), float32."""
    return ProbabilisticUnet(input_channels=1, num_classes=1, num_filters=(64, 128, 256, 512),
                             latent_dim=6, no_convs_fcomb=3, beta=1.0, rl_swap=True,
                             consensus_masking=consensus_masking, generator=generator)


def tail_weights(model: ProbabilisticUnet):
    """(mid_w (n_mid, C, C), mid_b (n_mid, C), last_w (C, n_cls), last_b
    (n_cls,)), contiguous, mid layers in the Fcomb's own (numeric) order."""
    fc = model.fcomb
    mids = fc.mid_layers()
    c = fc.num_filters0
    ref = fc.last_layer.weight
    mid_w = (torch.stack([w for w, _ in mids]) if mids
             else ref.new_zeros((0, c, c)))
    mid_b = (torch.stack([b for _, b in mids]) if mids
             else ref.new_zeros((0, c)))
    return (mid_w.contiguous(), mid_b.contiguous(),
            fc.last_layer.dense().contiguous(), fc.last_layer.bias.contiguous())


def mc_decode_logits(model: ProbabilisticUnet, features: torch.Tensor, dist: DiagGaussian,
                     n_samples: int, eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(n_samples, B, H, W, C) logits from one feature map + n latent draws;
    the feature term is computed once and shared (plain path)."""
    zs = dist.sample_n(n_samples, eps=eps, generator=generator)
    feat_term = model.decode_feature_term(features)
    return mc_logits_plain(feat_term, model.fcomb.z_term(zs), *tail_weights(model))


def mc_pseudo(model: ProbabilisticUnet, x: torch.Tensor, n_samples: int,
              eps: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
              masking: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pseudo, consensus), each (B, H, W, 1): encode, feature term, latent
    terms ``z @ W_z + b_z``, then the MC-consensus kernel (``pda``'s
    ``mc_pseudo_fused``). Single-class PUNets only."""
    enc = model.encode(x)
    feat_term = model.decode_feature_term(enc.features)
    zs = enc.prior.sample_n(n_samples, eps=eps, generator=generator)
    z_terms = model.fcomb.z_term(zs)
    return mc_consensus(feat_term.contiguous(), z_terms.contiguous(), *tail_weights(model),
                        masking=masking)


def mc_predict_probs(model: ProbabilisticUnet, x: torch.Tensor, n_samples: int,
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean sigmoid over n prior samples, (B, H, W, 1) — the PUNet
    inference primitive (reference ``_custom_punet_prediction``)."""
    return mc_pseudo(model, x, n_samples, eps=eps, generator=generator)[0]
