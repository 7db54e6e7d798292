"""Port blocks against pda: ConvBlock (kernel 1's plain path), UpBlock
(kernel 2's plain path), the pool/upsample helpers, the latent Gaussian,
and the kernel wrappers' dispatch and input checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.core import distributions as jdist
from pda.models import blocks as jblocks
from pda_torch.core import distributions as tdist
from pda_torch.kernels import conv_block as kconv
from pda_torch.kernels import mc_consensus as kmc
from pda_torch.models import blocks as tblocks
from torch_port_utils import assert_close_scaled, t


def _block_params(rng, cin, c):
    """pda ConvBlock params {"Conv_j": {kernel (3,3,ci,c), bias (c,)}}."""
    out = {}
    for j in range(3):
        ci = cin if j == 0 else c
        out[f"Conv_{j}"] = {
            "kernel": (rng.normal(size=(3, 3, ci, c)) * np.sqrt(2.0 / (9 * ci))).astype(np.float32),
            "bias": (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        }
    return out


def _load(block: tblocks.ConvBlock, params) -> None:
    with torch.no_grad():
        for j, conv in enumerate(block.convs()):
            conv.weight.copy_(t(np.asarray(params[f"Conv_{j}"]["kernel"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(t(params[f"Conv_{j}"]["bias"]))


@pytest.mark.parametrize(
    "cin,c,h,w,pool",
    [
        (1, 8, 9, 13, False),  # image entry block, odd H/W
        (2, 8, 7, 10, False),  # posterior entry: image + mask
        (5, 12, 11, 11, False),
        (6, 16, 12, 18, True),  # pooled block
    ],
)
def test_conv_block_matches_pda(cin, c, h, w, pool):
    rng = np.random.default_rng(cin * 100 + h)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    params = _block_params(rng, cin, c)
    ref = jblocks.ConvBlock(c, pool=pool).apply({"params": params}, jnp.asarray(x))
    block = tblocks.ConvBlock(cin, c, pool=pool)
    _load(block, params)
    with torch.no_grad():
        out = block(t(x))
    assert_close_scaled(out.numpy(), ref)


@pytest.mark.parametrize("cin,cb,c,h,w", [(16, 12, 12, 4, 6), (8, 4, 4, 5, 3)])
def test_up_block_matches_pda(cin, cb, c, h, w):
    rng = np.random.default_rng(7 + h)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    bridge = rng.normal(size=(2, 2 * h, 2 * w, cb)).astype(np.float32)
    params = {"ConvBlock_0": _block_params(rng, cin + cb, c)}
    ref = jblocks.UpBlock(c).apply({"params": params}, jnp.asarray(x), jnp.asarray(bridge))
    up = tblocks.UpBlock(cin, cb, c)
    _load(up.conv_block, params["ConvBlock_0"])
    with torch.no_grad():
        out = up(t(x), t(bridge))
    assert_close_scaled(out.numpy(), ref)


def test_dual_plain_equals_concat_plain():
    rng = np.random.default_rng(3)
    xa, xb = t(rng.normal(size=(1, 6, 5, 3))), t(rng.normal(size=(1, 6, 5, 2)))
    p = _block_params(rng, 5, 4)
    ws = [t(p[f"Conv_{j}"][k]) for j in range(3) for k in ("kernel", "bias")]
    dual = kconv.conv_block_fwd_dual(xa, xb, *ws)
    single = kconv.conv_block_fwd(torch.cat([xa, xb], -1), *ws)
    torch.testing.assert_close(dual, single, rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(4, 6), (5, 3), (1, 2)])
def test_upsample_and_pool_match_pda(h, w):
    x = np.random.default_rng(h).normal(size=(2, h, w, 3)).astype(np.float32)
    up = tblocks.upsample_2x_align_corners(t(x))
    assert up.is_contiguous()
    np.testing.assert_allclose(up.numpy(), jblocks.upsample_2x_align_corners(jnp.asarray(x)),
                               atol=1e-6)
    x2 = np.concatenate([x, x], axis=1)[:, : 2 * (h // 2) or 2, : 2 * (w // 2) or 2]
    np.testing.assert_allclose(tblocks.avg_pool_2x2(t(x2)).numpy(),
                               jblocks.avg_pool_2x2(jnp.asarray(x2)), atol=1e-6)


def test_avg_pool_rejects_odd_dims():
    with pytest.raises(ValueError):
        tblocks.avg_pool_2x2(torch.zeros(1, 3, 4, 1))


def test_diag_gaussian_matches_pda():
    rng = np.random.default_rng(0)
    mu, ls = rng.normal(size=(3, 6)), rng.normal(size=(3, 6)) * 0.3
    mu2, ls2 = rng.normal(size=(3, 6)), rng.normal(size=(3, 6)) * 0.3
    key = jax.random.PRNGKey(5)
    jq = jdist.DiagGaussian(jnp.asarray(mu, jnp.float32), jnp.asarray(ls, jnp.float32))
    jp = jdist.DiagGaussian(jnp.asarray(mu2, jnp.float32), jnp.asarray(ls2, jnp.float32))
    tq, tp = tdist.DiagGaussian(t(mu), t(ls)), tdist.DiagGaussian(t(mu2), t(ls2))
    # pda's sample_n(key, n) draws exactly this eps (axis_name None)
    eps = jax.random.normal(key, (4, 3, 6))
    np.testing.assert_allclose(tq.sample_n(4, eps=t(eps)).numpy(), jq.sample_n(key, 4), atol=1e-6)
    np.testing.assert_allclose(tq.sample(eps=t(eps[0])).numpy(),
                               jq.mu + jq.sigma * eps[0], atol=1e-6)
    z = jq.sample_n(key, 4)
    np.testing.assert_allclose(tq.log_prob(t(z)).numpy(), jq.log_prob(z), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tdist.kl_divergence(tq, tp).numpy(), jdist.kl_divergence(jq, jp),
                               rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert tq.sample_n(5, generator=g).shape == (5, 3, 6)
    with pytest.raises(ValueError):
        tq.sample_n(4, eps=t(eps[:2]))
    with pytest.raises(ValueError):
        tq.sample_n(4)


def _conv_args(cin=3, c=4, shape=(1, 5, 6)):
    x = torch.zeros(*shape, cin)
    ws = []
    for ci in (cin, c, c):
        ws += [torch.zeros(3, 3, ci, c), torch.zeros(c)]
    return x, ws


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "contiguity", "bias"],
)
def test_conv_kernel_wrapper_rejects_what_it_cannot_take(bad):
    """The CUDA path's checks run before any launch, so they run here too."""
    x, ws = _conv_args()
    xs = [x]
    if bad == "dtype":  # float32 and bf16 have kernels; float16 and float64 none
        xs = [x.half(), x.double()]
    elif bad == "shape":
        ws[2] = torch.zeros(3, 3, 5, 4)
    elif bad == "contiguity":
        xs = [torch.zeros(1, 6, 5, 3).transpose(1, 2)]
    else:
        ws[1] = torch.zeros(5)
    for x in xs:
        with pytest.raises((TypeError, ValueError)):
            kconv._launch(x, None, *ws)


def test_mc_kernel_wrapper_rejects_unsupported_width():
    """The kernel takes C up to 64 (any C, zero-padded to a multiple of 8);
    a wider tail is refused before any launch (``mc_pseudo`` sends it to the
    plain tail)."""
    feat, z = torch.zeros(1, 4, 4, 72), torch.zeros(2, 1, 72)
    with pytest.raises(ValueError, match="C <= 64"):
        kmc._launch(feat, z, torch.zeros(1, 72, 72), torch.zeros(1, 72),
                    torch.zeros(72, 1), torch.zeros(1), False)


def test_wrappers_refuse_other_devices_and_count_no_cpu_launch():
    x, ws = _conv_args()
    for fn in (kconv.conv_block_fwd, kmc.mc_consensus):
        fn.launches = 0
    kconv.conv_block_fwd(x, *ws)
    assert kconv.conv_block_fwd.launches == 0  # the plain version is not a launch
    with pytest.raises(ValueError, match="cpu or cuda"):
        kconv.conv_block_fwd(x.to("meta"), *[w.to("meta") for w in ws])
    feat = torch.zeros(1, 2, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kmc.mc_consensus(feat, feat.new_zeros(2, 1, 32), feat.new_zeros(1, 32, 32),
                         feat.new_zeros(1, 32), feat.new_zeros(32, 1), feat.new_zeros(1))


def test_forward_kernel_weights_are_an_hwoi_copy():
    """The forward kernel reads each HWIO kernel as a contiguous HWOI copy
    (its reduction index, Cin, contiguous)."""
    w = torch.arange(3 * 3 * 5 * 7, dtype=torch.float32).reshape(3, 3, 5, 7)
    out = kconv._hwoi(w)
    assert out.shape == (3, 3, 7, 5) and out.is_contiguous()
    assert torch.equal(out, w.permute(0, 1, 3, 2))
    assert out.data_ptr() != w.data_ptr()


@pytest.mark.parametrize("shape,gflop", [
    ((4, 256, 256, 64, 128), 193.3), ((4, 128, 128, 128, 256), 193.3),
    ((4, 64, 64, 256, 512), 193.3), ((4, 512, 512, 1, 64), 155.8),
    ((1, 528, 704, 1, 64), 55.2), ((4, 128, 128, 512 + 256, 256), 386.5),
])
def test_workload_flops_of_the_serving_blocks(shape, gflop):
    """18 * Cin * Cout FLOPs a pixel and layer, the count every bound and
    TFLOP/s figure of the measurement scripts rests on."""
    from pda_torch.tools import workload

    assert round(workload.block_flops(*shape) / 1e9, 1) == gflop
    b, h, w, cin, c = shape
    assert workload.dgrad_flops(b, h, w, cin, c, True) == workload.block_flops(b, h, w, cin, c)


def test_kernel_library_is_keyed_by_its_sources(tmp_path):
    """A copy of the kernel sources builds into the package's library until
    one of its files changes; then it has a library of its own, so a variant
    and the package's kernels load side by side."""
    import shutil

    from pda_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert _build._library_path(csrc) == _build._library_path()
    header = csrc / "conv3x3_tc.cuh"
    header.write_text(header.read_text().replace("IG_STAGES = 2", "IG_STAGES = 3"))
    assert _build._library_path(csrc) != _build._library_path()
    assert [p.name for p in _build._sources(csrc)] == [p.name for p in _build._sources()]
