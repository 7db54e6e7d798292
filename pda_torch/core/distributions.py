"""Diagonal Gaussian latent distribution (port of ``pda/core/distributions.py``).

torch cannot reproduce ``jax.random`` streams, so every draw takes its noise
explicitly: a standard-normal ``eps`` tensor, or a ``torch.Generator`` that
the draw uses to make one.

On a data mesh (:mod:`pda_torch.parallel`) a draw is the rank's slice of the
global batch's noise (:func:`sharded_normal`, ``pda``'s): ``eps`` is then
the global batch's, and a generator draws the global batch's, so every rank,
its generator in the same state as the others', keeps its own rows of one
draw and a sharded step sees the noise of the single-device step. On a
(``data``, ``space``) mesh the rows are those of the rank's ``data`` index:
the row shards of one image share its noise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..parallel.mesh import DATA_AXIS


def sharded_normal(shape, eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, mesh=None,
                   batch_axis: int = 0) -> torch.Tensor:
    """Standard normals of ``shape``, the local shape. Without a mesh: ``eps``
    (checked against ``shape``) or a draw from ``generator``. On a mesh of N
    ranks: the global shape (``shape[batch_axis] * N``) is drawn from
    ``generator`` or taken from ``eps``, and this rank's block of rows on
    ``batch_axis`` comes back, contiguous (``pda``'s ``sharded_normal``)."""
    if mesh is not None:
        mesh = mesh.axis(DATA_AXIS)
    n = 1 if mesh is None else mesh.world
    gshape = list(shape)
    gshape[batch_axis] *= n
    if eps is None:
        if generator is None:
            raise ValueError("pass the noise as eps or a torch.Generator")
        # drawn in float32 whatever the model's dtype, so that a float64
        # model on the same generator sees the same noise
        eps = torch.randn(gshape, generator=generator, device=generator.device)
    if tuple(eps.shape) != tuple(gshape):
        where = "" if mesh is None else f" (the global batch's, {mesh})"
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {tuple(gshape)}{where}")
    if mesh is None:
        return eps
    rows = mesh.rows(gshape[batch_axis])
    return eps.narrow(batch_axis, rows.start, rows.stop - rows.start).contiguous()


def _noise(shape, like: torch.Tensor, eps: Optional[torch.Tensor],
           generator: Optional[torch.Generator], mesh=None, batch_axis: int = 0) -> torch.Tensor:
    eps = sharded_normal(shape, eps, generator, mesh, batch_axis)
    if eps.device.type == "cpu" and like.device.type == "cuda":
        # from pinned memory, so the host does not wait for the card's queue
        return eps.pin_memory().to(device=like.device, dtype=like.dtype, non_blocking=True)
    return eps.to(device=like.device, dtype=like.dtype)


class DiagGaussian(NamedTuple):
    """A batch of axis-aligned Gaussians; mu, log_sigma: (..., latent_dim)."""

    mu: torch.Tensor
    log_sigma: torch.Tensor

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(self.log_sigma)

    def sample(self, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
        """Reparameterized sample mu + sigma * eps, eps of mu's shape (on a
        ``mesh``, of the global batch's: :func:`sharded_normal`)."""
        eps = _noise(self.mu.shape, self.mu, eps, generator, mesh)
        return self.mu + torch.exp(self.log_sigma) * eps

    def sample_n(self, n: int, eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
        """``n`` samples at once -> (n, ..., latent_dim); eps is (n, ..., L),
        on a ``mesh`` the global batch's (sliced on axis 1).

        ``pda``'s ``sample_n(key, n)`` draws ``jax.random.normal(key, (n, B,
        L))``; handing that array in as ``eps`` gives the same samples."""
        eps = _noise((n, *self.mu.shape), self.mu, eps, generator, mesh, batch_axis=1)
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
