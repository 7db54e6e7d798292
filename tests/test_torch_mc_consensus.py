"""Kernel 3's plain version (the MC Fcomb tail + consensus) and the
consensus functions, against pda's mc_decode_logits + consensus_from_logits
with the same weights and the same latent noise."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.core import consensus as jcons
from pda.core.distributions import DiagGaussian as JGauss
from pda.models.punet import mc_decode_logits as j_mc_decode_logits
from pda_torch.core import consensus as tcons
from pda_torch.core.distributions import DiagGaussian as TGauss
from pda_torch.kernels import mc_consensus as kmc
from pda_torch.kernels.mc_consensus import mc_consensus
from pda_torch.models.punet import mc_decode_logits, tail_weights
from torch_port_utils import (FILTERS, LATENT, assert_consensus_matches, pda_punet,
                              port_punet, t)

N_SAMPLES = 8


def _inputs(seed, scale):
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(2, 12, 10, FILTERS[0])) * scale).astype(np.float32)
    mu = rng.normal(size=(2, LATENT)).astype(np.float32)
    ls = (rng.normal(size=(2, LATENT)) * 0.3).astype(np.float32)
    return feats, mu, ls


@pytest.mark.parametrize("no_convs_fcomb", [2, 3, 4])
@pytest.mark.parametrize("masking", [False, True])
def test_mc_tail_and_consensus_match_pda(no_convs_fcomb, masking):
    jmodel, params = pda_punet(no_convs_fcomb)
    port = port_punet(params, no_convs_fcomb)
    # deeper tails shrink the logits: wider features keep both consensus sides
    feats, mu, ls = _inputs(no_convs_fcomb, 3.0 * no_convs_fcomb)
    key = jax.random.PRNGKey(11)
    logits = j_mc_decode_logits(jmodel, params, jnp.asarray(feats),
                                JGauss(jnp.asarray(mu), jnp.asarray(ls)), key, N_SAMPLES)
    ref_mean, ref_cons = jcons.consensus_from_logits(logits, masking=masking)
    eps = t(jax.random.normal(key, (N_SAMPLES, 2, LATENT)))

    with torch.no_grad():
        dist = TGauss(t(mu), t(ls))
        port_logits = mc_decode_logits(port, t(feats), dist, N_SAMPLES, eps=eps)
        feat_term = port.decode_feature_term(t(feats))
        z_terms = port.fcomb.z_term(dist.sample_n(N_SAMPLES, eps=eps))
        mean, cons = mc_consensus(feat_term, z_terms, *tail_weights(port), masking=masking)

    np.testing.assert_allclose(port_logits.numpy(), logits, atol=1e-5)
    assert mean.shape == cons.shape == (2, 12, 10, 1)
    assert float(np.abs(mean.numpy() - np.asarray(ref_mean)).max()) <= 1e-6
    assert_consensus_matches(cons.numpy(), ref_cons, logits)
    if masking:
        assert set(np.unique(cons.numpy())) <= {0.0, 1.0}
        assert 0.0 < float(cons.mean()) < 1.0  # the inputs reach both sides


@pytest.mark.parametrize("masking", [False, True])
def test_consensus_functions_match_pda(masking):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(16, 2, 9, 7, 1)) * 3).astype(np.float32)
    probs = jax.nn.sigmoid(jnp.asarray(logits))
    for tfn, jfn, arr in (
        (tcons.consensus_from_logits, jcons.consensus_from_logits, logits),
        (tcons.consensus_from_probs, jcons.consensus_from_probs, np.asarray(probs)),
    ):
        p, c = tfn(t(arr), masking=masking)
        jp, jc = jfn(jnp.asarray(arr), masking=masking)
        np.testing.assert_allclose(p.numpy(), jp, atol=1e-6)
        assert_consensus_matches(c.numpy(), jc, logits)


def test_shared_memory_reckoning_follows_the_kernel_source():
    """The wrapper refuses an S that the kernel's shared memory cannot hold by
    the kernel's own block shape (``csrc/mc_consensus.cu``): each mid layer's
    W split into hi and lo (8 bytes a weight), with n_mid >= 2 a 16 x C
    hidden tile a warp, the biases, w_last and S latent terms. The bf16 body
    (``mcw::Layout``): each mid layer's W in bf16, the last layer's LAST_N B
    operands of C x LAST_N bf16, each latent row as bf16 pairs padded to a
    whole 16-byte load for each of four lane quads, the mid biases."""
    src = (Path(kmc.__file__).parent / "csrc" / "mc_consensus.cu").read_text()
    warps = int(re.search(r"constexpr int WARPS = (\d+);", src).group(1))
    assert kmc._THREADS == 32 * warps
    assert kmc._smem_bytes(64, 16, 1) == 8 * 64 * 64 + 4 * (64 + 64 + 16 * 64)  # the flagship
    hidden = warps * 16 * 32 * 4
    assert kmc._smem_bytes(32, 5, 2) == 2 * 8 * 32 * 32 + hidden + 4 * (2 * 32 + 32 + 5 * 32)
    assert kmc._smem_bytes(64, 778, 1) <= kmc._MAX_SMEM < kmc._smem_bytes(64, 779, 1)

    last_n = int(re.search(r"constexpr int LAST_N = (\d+);", src).group(1))
    assert kmc._LAST_N == last_n
    assert "return (c / 8 + 3) / 4 * 4;" in src  # mcw::z_words: C / 8 pairs, whole uint4s
    bf16 = torch.bfloat16
    for c, s, n_mid in ((64, 16, 1), (48, 5, 2), (16, 1, 0), (32, 8, 3)):
        z_words = (c // 8 + 3) // 4 * 4
        assert kmc._smem_bytes(c, s, n_mid, bf16) == (
            2 * n_mid * c * c + 2 * last_n * last_n * c + 16 * z_words * s + 4 * n_mid * c)
    s_max = (kmc._MAX_SMEM - 2 * 64 * 64 - 2 * last_n * last_n * 64 - 4 * 64) // (16 * 8)
    assert kmc._smem_bytes(64, s_max, 1, bf16) <= kmc._MAX_SMEM < kmc._smem_bytes(
        64, s_max + 1, 1, bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_refuses_s_beyond_shared_memory(dtype):
    """One sample more than the kernel's shared memory holds (C = 64, n_mid
    1) raises ValueError in the launch's checks, before any CUDA call; on
    the CPU the wrapper runs the plain version."""
    c = 64
    s = next(s for s in range(1, 4000) if kmc._smem_bytes(c, s, 1, dtype) > kmc._MAX_SMEM)
    feat = torch.zeros(1, 2, 2, c, dtype=dtype)
    rest = (torch.zeros(s, 1, c), torch.zeros(1, c, c), torch.zeros(1, c), torch.zeros(c, 1),
            torch.zeros(1))
    with pytest.raises(ValueError, match="shared memory"):
        kmc._launch(feat, *rest, False)
    with torch.no_grad():
        mean, _ = mc_consensus(feat, *rest)
    assert mean.shape == (1, 2, 2, 1)
