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


def _kernel_source() -> str:
    return (Path(kmc.__file__).parent / "csrc" / "mc_consensus.cu").read_text()


def test_shared_memory_reckoning_follows_the_kernel_source():
    """The wrapper refuses an S that the kernel's shared memory cannot hold by
    the kernel's own block shape and layout (``csrc/mc_consensus.cu``): a
    block is one warpgroup (``mcw::THREADS``). The float32 body
    (``mcw::LayoutF32``): each mid layer's W split into a TF32 hi and a lo
    plane (8 bytes a weight), the mid biases, w_last and S latent rows, all
    float32. The bf16 body (``mcw::Layout``): each mid layer's W in bf16,
    the last layer's LAST_N B operands of C x LAST_N bf16, each latent row
    as bf16 pairs padded to a whole 16-byte load for each of four lane
    quads, the mid biases."""
    src = _kernel_source()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    assert kmc._THREADS == threads == 128  # a warpgroup: 64 pixels, 16 a warp
    for term in ("bias(8 * static_cast<size_t>(n_mid) * c * c)",
                 "last(bias + 4 * static_cast<size_t>(n_mid) * c)",
                 "z(last + 4 * static_cast<size_t>(c))",
                 "bytes(z + 4 * static_cast<size_t>(s) * c)"):
        assert term in src  # mcw::LayoutF32's members, in order
    assert kmc._smem_bytes(64, 16, 1) == 8 * 64 * 64 + 4 * (64 + 64 + 16 * 64)  # the flagship
    assert kmc._smem_bytes(32, 5, 2) == 2 * 8 * 32 * 32 + 4 * (2 * 32 + 32 + 5 * 32)
    assert kmc._smem_bytes(8, 3, 0) == 4 * (8 + 3 * 8)
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


@pytest.mark.parametrize("hw,b,resident", [
    (512 * 512, 4, 396),   # a tiled frame's four tiles on 132 SMs x 3 blocks
    (512 * 512, 2, 396),   # the MT teacher
    (528 * 704, 1, 396),   # a pseudo frame
    (512 * 512, 9, 264),   # a MitoEM prediction batch at two blocks an SM
    (2048 * 2048, 36, 396),
    (37 * 29, 2, 396),     # 1,073 pixels an image: 17 tiles, the last one ragged
    (1, 1, 396), (64, 1, 396), (65, 1, 396),
    (4 * 64, 3, 5),        # 12 tiles over 5 resident blocks: 3 a block, 2 blocks an image
])
def test_one_wave_grid_covers_every_tile_once(hw, b, resident):
    """The persistent grid (``one_wave``, mirrored by ``one_wave_grid``):
    blocks of T consecutive 64-pixel tiles cover each image's tiles once,
    the last block of an image holding at least one; T is the least that
    spreads the batch's tiles over the resident blocks, so the grid fills
    at most one wave and part of a second (fewer than B blocks past it)."""
    src = _kernel_source()
    assert "(static_cast<long long>(tiles) * B + resident - 1) / resident" in src
    assert "*blocks = (tiles + per_block - 1) / per_block;" in src
    assert "const int tiles = (HW + 63) / 64;" in src
    per_block, blocks = kmc.one_wave_grid(hw, b, resident)
    tiles = -(-hw // 64)
    assert (blocks - 1) * per_block < tiles <= blocks * per_block
    assert (per_block - 1) * resident < tiles * b <= per_block * resident
    assert blocks * b < resident + b
    covered = sorted(t for x in range(blocks) for t in range(x * per_block,
                                                              min((x + 1) * per_block, tiles)))
    assert covered == list(range(tiles))


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
