"""Shared set-up for the port's tests (tests/test_torch_*.py): one small
PUNet in ``pda`` (the reference, JAX on the CPU) and the same weights in
``pda_torch`` through the weight bridge."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)  # tier-1 runs several test workers side by side

FILTERS = (4, 8, 12, 16)
LATENT = 6


@functools.lru_cache(maxsize=None)
def pda_punet(no_convs_fcomb: int = 3, seed: int = 0, consensus_masking: bool = False):
    """(flax module, params) of a small pda PUNet, posterior included, with
    the flagship's loss settings (beta 1, rl_swap).

    The tree's structure and shapes are pda's own (``jax.eval_shape`` of
    ``model.init``, which traces without compiling the initializers); the
    values are seeded normals: He-scaled 3x3 kernels, 1/sqrt(fan_in)-scaled
    Dense kernels and biases of scale 0.1, so that every leaf matters."""
    from pda.models import ProbabilisticUnet

    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT,
                              no_convs_fcomb=no_convs_fcomb, beta=1.0, rl_swap=True,
                              consensus_masking=consensus_masking)
    x = jnp.zeros((1, 16, 16, 1))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) == 1:
            scale = 0.1
        else:
            scale = np.sqrt((2.0 if len(shape) == 4 else 1.0) / np.prod(shape[:-1]))
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return model, jax.tree_util.tree_map(draw, shapes)


def port_punet(params, no_convs_fcomb: int = 3, consensus_masking: bool = False):
    """The port's PUNet carrying ``params`` (a pda tree), with the loss
    settings of :func:`pda_punet`."""
    from pda_torch.models import ProbabilisticUnet, state_dict_from_pda

    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT,
                              no_convs_fcomb=no_convs_fcomb, beta=1.0, rl_swap=True,
                              consensus_masking=consensus_masking)
    model.load_state_dict(state_dict_from_pda(params))
    return model.eval()


def t(a) -> torch.Tensor:
    """numpy/jax array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close_scaled(out, ref, rel: float = 1e-5) -> None:
    """max |out - ref| <= rel * max(1, max |ref|)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"max abs err {err} > {tol}"


def assert_consensus_matches(cons, cons_ref, logits_ref, window: float = 1e-5,
                             max_share: float = 1e-3) -> None:
    """Consensus maps agree except at pixels where some sample's logit lies
    within ``window`` of +-log 9 (a threshold); at most ``max_share`` of the
    pixels may be such pixels."""
    cons, cons_ref = np.asarray(cons), np.asarray(cons_ref)
    logits = np.asarray(logits_ref)
    near = (np.abs(np.abs(logits) - np.log(9.0)) < window).any(axis=0)
    assert near.mean() <= max_share, f"{near.mean():.4%} of pixels near a threshold"
    bad = (cons != cons_ref) & ~near
    assert not bad.any(), f"{int(bad.sum())} consensus mismatches away from a threshold"
