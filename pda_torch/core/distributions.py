"""Diagonal Gaussian latent distribution (port of ``pda/core/distributions.py``).

torch cannot reproduce ``jax.random`` streams, so every draw takes its noise
explicitly: a standard-normal ``eps`` tensor, or a ``torch.Generator`` that
the draw uses to make one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


def _noise(shape, like: torch.Tensor, eps: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if eps is None:
        if generator is None:
            raise ValueError("pass the noise as eps or a torch.Generator")
        eps = torch.randn(shape, generator=generator,
                          device=generator.device, dtype=like.dtype)
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {tuple(shape)}")
    return eps.to(device=like.device, dtype=like.dtype)


class DiagGaussian(NamedTuple):
    """A batch of axis-aligned Gaussians; mu, log_sigma: (..., latent_dim)."""

    mu: torch.Tensor
    log_sigma: torch.Tensor

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(self.log_sigma)

    def sample(self, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Reparameterized sample mu + sigma * eps, eps of mu's shape."""
        eps = _noise(self.mu.shape, self.mu, eps, generator)
        return self.mu + torch.exp(self.log_sigma) * eps

    def sample_n(self, n: int, eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``n`` samples at once -> (n, ..., latent_dim); eps is (n, ..., L).

        ``pda``'s ``sample_n(key, n)`` draws ``jax.random.normal(key, (n, B,
        L))``; handing that array in as ``eps`` gives the same samples."""
        eps = _noise((n, *self.mu.shape), self.mu, eps, generator)
        return self.mu[None] + torch.exp(self.log_sigma)[None] * eps

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        """Log density, summed over the (last) latent axis."""
        log_unnorm = -0.5 * torch.square((z - self.mu) / torch.exp(self.log_sigma))
        log_norm = -0.5 * math.log(2.0 * math.pi) - self.log_sigma
        return torch.sum(log_unnorm + log_norm, dim=-1)


def kl_divergence(q: DiagGaussian, p: DiagGaussian) -> torch.Tensor:
    """Analytic KL(q || p) for diagonal Gaussians, summed over the latent axis."""
    var_ratio = torch.exp(2.0 * (q.log_sigma - p.log_sigma))
    t1 = torch.square((q.mu - p.mu) / torch.exp(p.log_sigma))
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1)


def mc_kl_divergence(q: DiagGaussian, p: DiagGaussian, z: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo KL estimate log q(z) - log p(z) at the draw ``z``."""
    return q.log_prob(z) - p.log_prob(z)
