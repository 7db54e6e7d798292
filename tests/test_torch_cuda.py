"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU. Run them on a machine with
one: ``python -m pytest tests/test_torch_cuda.py -q``. Shapes are small and
ragged on purpose (odd H/W, channel counts that do not fill a tile); the
serving and training paths' full widths are checked by ``chip_smoke.py``.
Both TF32 switches are off, so the plain versions compute in full float32.
"""

import copy

import numpy as np
import pytest
import torch

from pda_torch.kernels import conv_block as kconv
from pda_torch.kernels.conv_block import (conv_block_fwd, conv_block_fwd_dual,
                                          conv_block_fwd_dual_plain, conv_block_fwd_plain)
from pda_torch.kernels import mc_consensus as kmc
from pda_torch.kernels.mc_consensus import mc_consensus, mc_consensus_plain, mc_logits_plain
from pda_torch.tools.workload import mc_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(gen, cin, c, dev):
    out = []
    for ci in (cin, c, c):
        out.append((torch.randn(3, 3, ci, c, generator=gen) * (2.0 / (9 * ci)) ** 0.5).to(dev))
        out.append((torch.randn(c, generator=gen) * 0.1).to(dev))
    return out


def _assert_rel(out, ref, rel=1e-4):
    err = float((out - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), err


@pytest.mark.parametrize("b,h,w,cin,c", [
    (2, 9, 13, 1, 64), (1, 17, 33, 2, 40), (2, 8, 16, 70, 128), (1, 5, 3, 8, 8),
    # the edges of the tensor-core layer's tiling (16x16 pixels x 64 channels,
    # 16-channel stages) and of the FMA entry layer (Cin 1, 2)
    (1, 17, 33, 16, 40),    # H = 16 + 1, W = 2 * 16 + 1; C = 40: a ragged channel slice
    (1, 66, 88, 256, 512),  # the pseudo path's level-3 map
    (2, 7, 5, 3, 20),       # Cin 3 on the tensor cores' 4-byte copies, under one tile
    (8, 8, 8, 64, 96),      # the learning check's PUNet (16, 32, 64, 96): C = 64 + 32
])
def test_conv_block_kernel_matches_plain(dev, b, h, w, cin, c):
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    ws = _weights(gen, cin, c, dev)
    before = conv_block_fwd.launches
    with torch.no_grad():
        out = conv_block_fwd(x, *ws)
        again = conv_block_fwd(x, *ws)
    torch.cuda.synchronize()
    assert conv_block_fwd.launches == before + 2
    _assert_rel(out, conv_block_fwd_plain(x, *ws))
    assert torch.equal(out, again)  # deterministic: bit-equal repeats


@pytest.mark.parametrize("b,h,w,ca,cb,c", [
    (2, 10, 12, 13, 7, 24), (1, 16, 16, 64, 32, 64),
    (1, 9, 11, 20, 12, 40),  # the split at 20, inside a 16-channel stage, on 16-byte copies
    (8, 16, 16, 96, 64, 64),  # the learning check's PUNet: its first decoder block
])
def test_dual_conv_block_kernel_matches_plain(dev, b, h, w, ca, cb, c):
    gen = torch.Generator().manual_seed(ca)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
    ws = _weights(gen, ca + cb, c, dev)
    with torch.no_grad():
        out = conv_block_fwd_dual(xa, xb, *ws)
        again = conv_block_fwd_dual(xa, xb, *ws)
    torch.cuda.synchronize()
    _assert_rel(out, conv_block_fwd_dual_plain(xa, xb, *ws))
    assert torch.equal(out, again)


def _assert_bf16_layer(out, ref):
    """chip_smoke.py's bf16 layer rule: within one bf16 ulp of the plain
    layer, or 1e-5 of its largest value, and bit-equal on 99% of it."""
    a, r = out.double(), ref.double()
    diff = (a - r).abs()
    big = torch.maximum(a.abs(), r.abs()).clamp(min=2.0 ** -126)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    beyond = (diff > ulp) & (diff > 1e-5 * float(r.abs().max()))
    equal = float((out.view(torch.int16) == ref.view(torch.int16)).double().mean())
    assert bool(torch.isfinite(a).all())
    assert not beyond.any(), f"{int(beyond.sum())} elements beyond one ulp"
    assert equal >= 0.99, f"bit-equal on {equal:.4%}"


def _bf16_block_layers(xa, xb, ws):
    """h1, h2, h3 of the bf16 forward kernel, each held against the plain
    layer summed in float64 from the kernel's own input to it."""
    hs = kconv._launch(xa, xb, *ws)
    h_in = xa if xb is None else torch.cat([xa, xb], dim=-1)
    for k, h in enumerate(hs):
        with kconv.plain_sums(torch.float64):
            ref = kconv.conv_relu_layer(h_in.permute(0, 3, 1, 2), ws[2 * k], ws[2 * k + 1])
        _assert_bf16_layer(h, ref.permute(0, 2, 3, 1))
        h_in = h
    return hs


@pytest.mark.parametrize("b,h,w,ca,cb,c,wgmma", [
    # the edges of the bf16 wgmma body (64-channel chunks, 8 x 16 pixel tiles
    # at Cout > 64, 16 x 16 at Cout <= 64): odd H and W, batch 1, channel
    # counts off the chunk and off the 64/128-channel slice
    (1, 33, 45, 8, 0, 8, True), (1, 33, 45, 16, 0, 16, True), (1, 33, 45, 48, 0, 72, True),
    (2, 66, 88, 72, 0, 136, True), (1, 66, 88, 256, 0, 512, True),
    (1, 33, 45, 1, 0, 64, True),  # the FMA entry layer, then two wgmma layers
    # dual splits off the chunk boundary: one chunk reads xa's last channels, zero-filled
    (1, 33, 45, 40, 24, 64, True), (2, 21, 30, 200, 72, 128, True),
    # channel counts off 8: no tensor map; the first layer on the mma.sync body
    (1, 17, 19, 3, 0, 48, False), (1, 9, 11, 20, 12, 40, False),
])
def test_bf16_forward_layers_match_plain(dev, b, h, w, ca, cb, c, wgmma):
    """The bf16 forward (K1, K2) layer by layer against the plain layer in
    float64 sums, twice bit-equal, and through the wrapper; its launch
    counts in launches_wgmma_bf16 when every tensor-core layer took the
    wgmma body, which every shape with Ca and Cb multiples of 8 does."""
    gen = torch.Generator().manual_seed(ca * 100 + cb + c)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev).to(torch.bfloat16)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev).to(torch.bfloat16) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    wrapper = conv_block_fwd if xb is None else conv_block_fwd_dual
    before = (wrapper.launches_bf16, wrapper.launches_wgmma_bf16)
    with torch.no_grad():
        hs = _bf16_block_layers(xa, xb, ws)
        again = kconv._launch(xa, xb, *ws)
        out = wrapper(xa, *ws) if xb is None else wrapper(xa, xb, *ws)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(hs, again))
    assert torch.equal(out, hs[2])
    assert (wrapper.launches_bf16, wrapper.launches_wgmma_bf16) == (before[0] + 1,
                                                                     before[1] + int(wgmma))


def test_bf16_forward_on_an_unaligned_input_takes_the_mma_sync_body(dev):
    """A bf16 input 2 bytes off a 16-byte boundary cannot be a tensor map's:
    its first layer runs on the mma.sync body, counted off the wgmma route,
    and agrees with the plain layers as the aligned input's forward does."""
    gen = torch.Generator().manual_seed(5)
    b, h, w, cin, c = 1, 19, 23, 64, 72
    flat = torch.randn(b * h * w * cin + 1, generator=gen).to(dev).to(torch.bfloat16)
    x = flat[1:].view(b, h, w, cin)
    assert x.data_ptr() % 16 != 0
    ws = _weights(gen, cin, c, dev)
    before = (conv_block_fwd.launches_bf16, conv_block_fwd.launches_wgmma_bf16)
    with torch.no_grad():
        _bf16_block_layers(x, None, ws)
        conv_block_fwd(x, *ws)
    torch.cuda.synchronize()
    assert (conv_block_fwd.launches_bf16, conv_block_fwd.launches_wgmma_bf16) == (before[0] + 1,
                                                                                  before[1])


def test_conv_block_kernel_matches_float64(dev):
    """At 2x64x64, 64->128, the forward within 1e-5 of the largest value of
    the plain version computed in float64: float32 accuracy, which the
    3xTF32 split keeps (~1e-6) and one TF32 product (~1e-3) would not."""
    gen = torch.Generator().manual_seed(64)
    x = torch.randn(2, 64, 64, 64, generator=gen).to(dev)
    ws = _weights(gen, 64, 128, dev)
    with torch.no_grad():
        out = conv_block_fwd(x, *ws)
    ref64 = conv_block_fwd_plain(x.double(), *(w.double() for w in ws))
    torch.cuda.synchronize()
    assert float((out.double() - ref64).abs().max()) <= 1e-5 * float(ref64.abs().max())


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("n_mid", [0, 1, 2])
@pytest.mark.parametrize("masking", [False, True])
def test_mc_consensus_kernel_matches_plain(dev, c, n_mid, masking):
    gen = torch.Generator().manual_seed(c + n_mid)
    feat = (torch.randn(2, 33, 17, c, generator=gen) * 2).to(dev)
    z = torch.randn(5, 2, c, generator=gen).to(dev)
    mid_w = (torch.randn(n_mid, c, c, generator=gen) / c ** 0.5).to(dev)
    mid_b = (torch.randn(n_mid, c, generator=gen) * 0.1).to(dev)
    last_w = (torch.randn(c, 1, generator=gen) / c ** 0.5 * 3).to(dev)
    last_b = torch.randn(1, generator=gen).to(dev)
    args = (feat, z, mid_w, mid_b, last_w, last_b)
    with torch.no_grad():
        mean, cons = mc_consensus(*args, masking=masking)
    torch.cuda.synchronize()
    ref_mean, ref_cons = mc_consensus_plain(*args, masking)
    assert float((mean - ref_mean).abs().max()) <= 1e-5
    logits = mc_logits_plain(*args)
    near = ((logits.abs() - np.log(9.0)).abs() < 1e-4).any(dim=0)
    assert not ((cons != ref_cons) & ~near).any()


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("masking", [False, True])
def test_mc_consensus_kernel_s16_ragged_float64_repeats(dev, c, masking):
    """S = 16 at 2 x 37 x 29 pixels (1,073 an image: no multiple of the
    kernel's 128-pixel block): the mean within 1e-5 of the plain version and
    of the plain version in float64, the consensus only where a logit lies
    within 1e-4 of a threshold, and two launches bit-equal."""
    args = mc_inputs(torch.Generator().manual_seed(c), 2, 37, 29, c, s=16, n_mid=1, dev=dev)
    with torch.no_grad():
        mean, cons = mc_consensus(*args, masking=masking)
        mean2, cons2 = mc_consensus(*args, masking=masking)
    ref_mean, ref_cons = mc_consensus_plain(*args, masking)
    ref64 = mc_consensus_plain(*(a.double() for a in args), masking)[0]
    torch.cuda.synchronize()
    assert torch.equal(mean, mean2) and torch.equal(cons, cons2)
    assert float((mean - ref_mean).abs().max()) <= 1e-5
    assert float((mean.double() - ref64).abs().max()) <= 1e-5
    near = ((mc_logits_plain(*args).abs() - np.log(9.0)).abs() < 1e-4).any(dim=0)
    assert not ((cons != ref_cons) & ~near).any()


@pytest.mark.parametrize("c", [8, 16, 20, 44])
@pytest.mark.parametrize("masking", [False, True])
def test_mc_consensus_kernel_other_widths_match_plain(dev, c, masking):
    """S = 16 at widths other than 32 and 64: a multiple of 8 runs as it is,
    any other C zero-padded to the next one (20 -> 24, 44 -> 48). The mean
    within 1e-5 of the plain version and of float64, the consensus only
    within 1e-4 of a threshold, two launches bit-equal."""
    args = mc_inputs(torch.Generator().manual_seed(c), 2, 37, 29, c, s=16, n_mid=1, dev=dev)
    before = mc_consensus.launches
    with torch.no_grad():
        mean, cons = mc_consensus(*args, masking=masking)
        mean2, cons2 = mc_consensus(*args, masking=masking)
    ref_mean, ref_cons = mc_consensus_plain(*args, masking)
    ref64 = mc_consensus_plain(*(a.double() for a in args), masking)[0]
    torch.cuda.synchronize()
    assert mc_consensus.launches == before + 2
    assert torch.equal(mean, mean2) and torch.equal(cons, cons2)
    assert float((mean - ref_mean).abs().max()) <= 1e-5
    assert float((mean.double() - ref64).abs().max()) <= 1e-5
    near = ((mc_logits_plain(*args).abs() - np.log(9.0)).abs() < 1e-4).any(dim=0)
    assert not ((cons != ref_cons) & ~near).any()


@pytest.mark.parametrize("num_classes,launched", [(1, 2), (2, 0)])
def test_punet_mc_path_on_card_matches_cpu(dev, num_classes, launched):
    """A PUNet of first width 16 through mc_pseudo and the validation
    predictor: the card against the CPU. One class runs the MC kernel (once
    each); two classes take the plain tail and launch none."""
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.models.punet import mc_decode_logits, mc_predict_probs, mc_pseudo

    gen = torch.Generator().manual_seed(num_classes)
    model = ProbabilisticUnet(num_classes=num_classes, num_filters=(16, 24), no_convs_fcomb=3,
                              generator=gen)
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(16.0)
    x, eps = torch.randn(2, 24, 20, 1, generator=gen), torch.randn(16, 2, 6, generator=gen)
    on_card = copy.deepcopy(model).to(dev)
    before = mc_consensus.launches
    with torch.no_grad():
        y, z = mc_pseudo(on_card, x.to(dev), 16, eps=eps.to(dev), masking=True)
        mean = mc_predict_probs(on_card, x.to(dev), 16, eps=eps.to(dev))
        torch.cuda.synchronize()
        assert mc_consensus.launches == before + launched
        y_cpu, z_cpu = mc_pseudo(model, x, 16, eps=eps, masking=True)
        enc = model.encode(x)
        logits = mc_decode_logits(model, enc.features, enc.prior, 16, eps=eps)
    assert y.shape == mean.shape == (2, 24, 20, num_classes)
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-4
    assert float((mean.cpu() - y_cpu).abs().max()) <= 1e-4
    near = ((logits.abs() - np.log(9.0)).abs() < 1e-4).any(dim=0)
    assert not ((z.cpu() != z_cpu) & ~near).any()


def test_unet2d_forward_on_card_matches_cpu(dev):
    """UNet2d (depth 2, 8 features, sigmoid) on cuDNN against the CPU, and
    none of the port's kernels launched."""
    from pda_torch.models import UNet2d

    model = UNet2d(depth=2, initial_features=8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 36, 28, 1, generator=torch.Generator().manual_seed(1))
    before = (conv_block_fwd.launches, mc_consensus.launches)
    with torch.no_grad():
        out = copy.deepcopy(model).to(dev)(x.to(dev))
        torch.cuda.synchronize()
        ref = model(x)
    assert (conv_block_fwd.launches, mc_consensus.launches) == before
    assert out.shape == (2, 36, 28, 1)
    assert float((out.cpu() - ref).abs().max()) <= 1e-5


def test_mc_consensus_kernel_refuses_s_beyond_shared_memory(dev):
    """The largest S whose latent terms fit beside the split weights runs;
    one more raises ValueError before any launch."""
    c, n_mid = 64, 1
    s_max = max(s for s in range(1, 2000) if kmc._smem_bytes(c, s, n_mid) <= kmc._MAX_SMEM)
    gen = torch.Generator().manual_seed(0)
    args = mc_inputs(gen, 1, 5, 7, c, s=s_max, n_mid=n_mid, dev=dev)
    with torch.no_grad():
        mean, _ = mc_consensus(*args)
    torch.cuda.synchronize()
    assert float((mean - mc_consensus_plain(*args, False)[0]).abs().max()) <= 1e-5
    too_many = mc_inputs(gen, 1, 5, 7, c, s=s_max + 1, n_mid=n_mid, dev=dev)
    before = mc_consensus.launches
    with torch.no_grad(), pytest.raises(ValueError, match="shared memory"):
        mc_consensus(*too_many)
    assert mc_consensus.launches == before


def _f32_mc_matches_plain64(args, masking):
    """The float32 tail's two launches (mc_consensus_wgmma_tf32) against the
    plain version and the plain version in float64: the mean within 1e-5 of
    both (chip_smoke.py's K3_MEAN_TOL), the consensus differing only where a
    logit lies within 1e-4 of a threshold (K3_WINDOW), the two launches
    bit-equal, both counted on the wgmma body. Returns the mean. The
    unmasked consensus is a count over S: the plain version's mean on the
    card is the sum times 1 / S, which at an S off a power of 2 may round an
    ulp from the kernel's count / S, so it differs where it differs by more
    than 1e-6 (one sample moves it by 1 / S)."""
    before = (mc_consensus.launches, mc_consensus.launches_wgmma_f32)
    with torch.no_grad():
        mean, cons = mc_consensus(*args, masking=masking)
        mean2, cons2 = mc_consensus(*args, masking=masking)
    torch.cuda.synchronize()
    assert (mc_consensus.launches, mc_consensus.launches_wgmma_f32) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(mean, mean2) and torch.equal(cons, cons2)
    ref_mean, ref_cons = mc_consensus_plain(*args, masking)
    ref64 = mc_consensus_plain(*(a.double() for a in args), masking)[0]
    assert bool(torch.isfinite(mean).all())
    assert float((mean - ref_mean).abs().max()) <= 1e-5
    assert float((mean.double() - ref64).abs().max()) <= 1e-5
    near = ((mc_logits_plain(*args).abs() - np.log(9.0)).abs() < 1e-4).any(dim=0)
    assert not (((cons - ref_cons).abs() > 1e-6) & ~near).any()
    if masking:
        assert set(torch.unique(cons).tolist()) <= {0.0, 1.0}
    return mean


@pytest.mark.parametrize("c", [8, 24, 40, 64])
@pytest.mark.parametrize("n_mid", [0, 1, 2, 3])
@pytest.mark.parametrize("s", [1, 7, 8, 16, 17])
@pytest.mark.parametrize("masking", [False, True])
def test_f32_mc_consensus_wgmma_matches_plain_float64(dev, c, n_mid, s, masking):
    """The float32 tail (mc_consensus_wgmma_tf32) at widths from one k-step
    (C = 8) to eight, n_mid 0-2 (unrolled) and 3 (the runtime layer count),
    S = 1, 7, 8, 16, 17, masking on and off, at 2 x 37 x 29 pixels (1,073
    an image: no multiple of a warpgroup's 64)."""
    gen = torch.Generator().manual_seed(1000 * c + 10 * n_mid + s)
    _f32_mc_matches_plain64(mc_inputs(gen, 2, 37, 29, c, s=s, n_mid=n_mid, dev=dev), masking)


@pytest.mark.parametrize("c,b", [(20, 1), (20, 9), (44, 9), (64, 9)])
@pytest.mark.parametrize("masking", [False, True])
def test_f32_mc_consensus_wgmma_padded_widths_and_batches(dev, c, b, masking):
    """Widths the wrapper zero-pads (20 -> 24, 44 -> 48) and batches of 1
    and 9 (MitoEM's prediction batch) at 13 x 11 pixels (143 an image: two
    full tiles and a ragged third), S = 16."""
    gen = torch.Generator().manual_seed(c + b)
    _f32_mc_matches_plain64(mc_inputs(gen, b, 13, 11, c, s=16, n_mid=1, dev=dev), masking)


@pytest.mark.parametrize("shards", [2, 4])
def test_f32_mc_consensus_wgmma_row_shards_bit_equal(dev, shards):
    """Row shards of a 2 x 512^2 feature term (the (data, space) mesh's
    cut, chip_smoke.py's parallel phase): each shard's launch bit-equal to
    the whole image's rows, on the wgmma body (each pixel's sums run in the
    same order wherever its tile lies)."""
    args = mc_inputs(torch.Generator().manual_seed(shards), 2, 512, 512, 64, dev=dev)
    feat, rest = args[0], args[1:]
    whole = _f32_mc_matches_plain64(args, True)
    rows = 512 // shards
    with torch.no_grad():
        parts = [mc_consensus(feat[:, i * rows:(i + 1) * rows].contiguous(), *rest,
                              masking=True)[0] for i in range(shards)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_f32_mc_consensus_wgmma_refuses_autograd_and_misalignment(dev):
    """The float32 launch under autograd raises (forward-only), and a
    feature term off 8-byte alignment is refused before any launch."""
    args = mc_inputs(torch.Generator().manual_seed(3), 1, 4, 4, 32, s=2, dev=dev)
    before = mc_consensus.launches_wgmma_f32
    with pytest.raises(RuntimeError, match="forward-only"):
        mc_consensus(args[0].clone().requires_grad_(), *args[1:])
    odd = torch.zeros(1 * 4 * 4 * 32 + 1, device=dev)[1:].view(1, 4, 4, 32)
    with torch.no_grad(), pytest.raises(ValueError, match="aligned"):
        mc_consensus(odd, *args[1:])
    assert mc_consensus.launches_wgmma_f32 == before


BF16_MEAN_TOL, BF16_WINDOW = 2.0 ** -8, 2.0 ** -6  # chip_smoke.py's bf16 K3 bounds


def _bf16_mc_matches_plain64(args, masking):
    """The bf16 tail's two launches against the plain version summed in
    float64 at the bf16 rounding points: the mean within 2^-8, the consensus
    differing only where a logit lies within 2^-6 of a threshold, the two
    launches bit-equal, both on the wgmma body."""
    before = (mc_consensus.launches_bf16, mc_consensus.launches_wgmma_bf16)
    with torch.no_grad():
        mean, cons = mc_consensus(*args, masking=masking)
        mean2, cons2 = mc_consensus(*args, masking=masking)
    torch.cuda.synchronize()
    assert (mc_consensus.launches_bf16, mc_consensus.launches_wgmma_bf16) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(mean, mean2) and torch.equal(cons, cons2)
    with kconv.plain_sums(torch.float64):
        ref_mean, ref_cons = mc_consensus_plain(*args, masking)
        logits = mc_logits_plain(*args)
    assert bool(torch.isfinite(mean).all())
    assert float((mean.double() - ref_mean.double()).abs().max()) <= BF16_MEAN_TOL
    near = ((logits.abs() - np.log(9.0)).abs() < BF16_WINDOW).any(dim=0)
    assert not ((cons != ref_cons) & ~near).any()
    if masking:
        assert set(torch.unique(cons).tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("c", [16, 32, 48, 64])
@pytest.mark.parametrize("n_mid", [0, 1, 2])
@pytest.mark.parametrize("s", [1, 8, 16])
@pytest.mark.parametrize("masking", [False, True])
def test_bf16_mc_consensus_wgmma_matches_plain_float64(dev, c, n_mid, s, masking):
    """The bf16 tail (mc_consensus_wgmma) at every width it is built for,
    n_mid 0-2, S = 1, 8, 16, masking on and off, at 2 x 37 x 29 pixels
    (1,073 an image: no multiple of a warpgroup's 64)."""
    gen = torch.Generator().manual_seed(100 * c + 10 * n_mid + s)
    feat, *rest = mc_inputs(gen, 2, 37, 29, c, s=s, n_mid=n_mid, dev=dev)
    _bf16_mc_matches_plain64((feat.to(torch.bfloat16), *rest), masking)


@pytest.mark.parametrize("c,n_mid,s", [(64, 3, 16), (20, 1, 5), (44, 4, 9)])
def test_bf16_mc_consensus_wgmma_other_depths_and_widths(dev, c, n_mid, s):
    """Deeper tails (n_mid >= 3: the instance with a runtime layer count),
    widths padded to the next multiple of 16 (20 -> 32, 44 -> 48) and S off
    the 8-sample group."""
    gen = torch.Generator().manual_seed(c + n_mid)
    feat, *rest = mc_inputs(gen, 2, 37, 29, c, s=s, n_mid=n_mid, dev=dev)
    _bf16_mc_matches_plain64((feat.to(torch.bfloat16), *rest), True)


def test_bf16_mc_packed_entry_matches_float32_add_then_round(dev):
    """The tail's layer entry (one fma.rn.relu.bf16x2 of f * 1 + z) against
    the float32 sum rounded to bf16 and ReLU, on the card, over every finite
    bf16 f and seeded z (opposite signs, wide exponent gaps, subnormals):
    bit-equal (a zero's sign aside)."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    f = bits.view(torch.bfloat16)
    f = f[torch.isfinite(f.float())]
    gen = torch.Generator().manual_seed(7)
    z = torch.cat([torch.randn(32, generator=gen) * 10.0 ** torch.randint(-30, 30, (32,),
                                                                          generator=gen),
                   torch.tensor([0.0, -0.0, 1e-40, -1e-40, 3e38, -3e38])]).to(torch.bfloat16)
    ff = torch.cat([f.repeat(z.numel()), f, -f])
    zz = torch.cat([z.repeat_interleave(f.numel()), -f, f * 2.0 ** -30])
    ff, zz = ff[: ff.numel() // 2 * 2].to(dev), zz[: ff.numel() // 2 * 2].to(dev)
    out = kmc.packed_entry(ff, zz)
    ref = kmc.packed_entry_plain(ff, zz)
    torch.cuda.synchronize()
    canon = lambda t: torch.where(t == 0, torch.zeros_like(t), t).view(torch.int16)  # noqa: E731
    assert torch.equal(canon(out), canon(ref))


def test_bf16_mc_consensus_refuses_s_beyond_shared_memory(dev):
    """The largest S the bf16 body's shared memory holds runs (masked: at
    an S off a power of 2 the plain version's mean over the samples, a sum
    times 1 / S, may round the confident fraction an ulp from the kernel's
    count / S); one more raises ValueError before any launch."""
    c, n_mid, bf16 = 64, 1, torch.bfloat16
    s_max = max(s for s in range(1, 4000) if kmc._smem_bytes(c, s, n_mid, bf16) <= kmc._MAX_SMEM)
    gen = torch.Generator().manual_seed(0)
    feat, *rest = mc_inputs(gen, 1, 5, 7, c, s=s_max, n_mid=n_mid, dev=dev)
    _bf16_mc_matches_plain64((feat.to(bf16), *rest), True)
    feat, *rest = mc_inputs(gen, 1, 5, 7, c, s=s_max + 1, n_mid=n_mid, dev=dev)
    before = mc_consensus.launches_bf16
    with torch.no_grad(), pytest.raises(ValueError, match="shared memory"):
        mc_consensus(feat.to(bf16), *rest)
    assert mc_consensus.launches_bf16 == before


def test_wrappers_refuse_mixed_devices_and_autograd(dev):
    """Mixed devices are refused; under autograd the ConvBlock kernels no
    longer refuse but differentiate through the backward kernel, while the
    forward-only MC-consensus kernel still refuses."""
    x = torch.zeros(1, 4, 4, 2, device=dev)
    ws = _weights(torch.Generator().manual_seed(0), 2, 8, dev)
    with pytest.raises(ValueError):
        conv_block_fwd(x, ws[0].cpu(), *ws[1:])
    before = kconv.conv_block_bwd.launches
    conv_block_fwd(x, ws[0].requires_grad_(), *ws[1:]).sum().backward()
    torch.cuda.synchronize()
    assert kconv.conv_block_bwd.launches == before + 1 and ws[0].grad is not None
    feat = torch.zeros(1, 2, 2, 32, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        mc_consensus(feat, feat.new_zeros(2, 1, 32), feat.new_zeros(1, 32, 32),
                     feat.new_zeros(1, 32), feat.new_zeros(32, 1), feat.new_zeros(1))


def _saved(gen, b, h, w, cin, c, dev):
    """(g, x, h1, h2, h3, w1, w2, w3): a block's saved tensors from the
    plain forward, and a cotangent."""
    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    w1, b1, w2, b2, w3, b3 = _weights(gen, cin, c, dev)
    hs = [t.permute(0, 2, 3, 1).contiguous()
          for t in kconv._plain_layers(x, w1, b1, w2, b2, w3, b3)]
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    return (g, x, *hs, w1, w2, w3)


def _assert_all_rel(outs, refs, rel=1e-4):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        if ref is None:
            assert out is None
        else:
            assert out.shape == ref.shape
            _assert_rel(out, ref, rel)


@pytest.mark.parametrize("b,h,w,cin,c,need_dx", [
    (2, 9, 13, 1, 64, False), (1, 17, 33, 2, 40, False), (2, 8, 16, 3, 64, True),
    (1, 5, 3, 5, 8, True), (2, 12, 20, 70, 128, True),
    # where the tensor-core tiles are ragged
    (1, 17, 23, 16, 32, True),  # H = 16 + 1 (dgrad tile), W = 2 * 8 + 7 (wgrad tile)
    (2, 8, 16, 33, 48, True),   # Cin = 32 + 1: a wgrad block of one channel
    (1, 16, 16, 64, 72, True),  # C = 64 + 8: ragged wgrad co slice and dgrad stage
    (1, 9, 9, 6, 10, True),     # C % 4 != 0: the 4-byte cp.async path of both halves
    (2, 7, 5, 1, 16, False),    # entry layer smaller than one tile, no dx
    (8, 8, 8, 64, 96, True),    # the learning check's PUNet (16, 32, 64, 96): C = 64 + 32
])
def test_conv_block_bwd_kernel_matches_plain(dev, b, h, w, cin, c, need_dx):
    saved = _saved(torch.Generator().manual_seed(cin + h), b, h, w, cin, c, dev)
    before = kconv.conv_block_bwd.launches
    out = kconv.conv_block_bwd(*saved, need_dx=need_dx)
    again = kconv.conv_block_bwd(*saved, need_dx=need_dx)
    torch.cuda.synchronize()
    assert kconv.conv_block_bwd.launches == before + 2
    _assert_all_rel(out, kconv.conv_block_bwd_plain(*saved, need_dx=need_dx))
    for a, a2 in zip(out, again):  # deterministic: bit-equal repeats
        assert (a is None and a2 is None) or torch.equal(a, a2)


@pytest.mark.parametrize("b,h,w,ca,cb,c", [(2, 10, 12, 13, 7, 24), (1, 9, 17, 3, 5, 64),
                                           (1, 16, 16, 64, 32, 64),
                                           (1, 12, 18, 30, 34, 66),  # Ca % 4 != 0, dx split at 30
                                           (8, 16, 16, 96, 64, 64)])  # the learning check's
def test_conv_block_bwd_dual_kernel_matches_plain(dev, b, h, w, ca, cb, c):
    g, x, *rest = _saved(torch.Generator().manual_seed(ca), b, h, w, ca + cb, c, dev)
    xa, xb = x[..., :ca].contiguous(), x[..., ca:].contiguous()
    before = kconv.conv_block_bwd_dual.launches
    out = kconv.conv_block_bwd_dual(g, xa, xb, *rest)
    again = kconv.conv_block_bwd_dual(g, xa, xb, *rest)
    torch.cuda.synchronize()
    assert kconv.conv_block_bwd_dual.launches == before + 2
    _assert_all_rel(out, kconv.conv_block_bwd_dual_plain(g, xa, xb, *rest))
    assert all(torch.equal(a, a2) for a, a2 in zip(out, again))


def test_conv_block_bwd_kernel_matches_float64(dev):
    """At 2x64x64, 64->128, every output within 1e-5 of the largest of the
    plain version computed in float64: float32 accuracy, which the 3xTF32
    split keeps (~1e-6) and one TF32 product (~1e-3) would not."""
    saved = _saved(torch.Generator().manual_seed(64), 2, 64, 64, 64, 128, dev)
    out = kconv.conv_block_bwd(*saved)
    ref64 = kconv.conv_block_bwd_plain(*(t.double() for t in saved))
    torch.cuda.synchronize()
    for a, r in zip(out, ref64):
        assert float((a.double() - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,c,need_dx,mode", [
    (2, 10, 14, 1, 64, False, "with"), (1, 18, 34, 2, 40, False, "only"),
    (2, 8, 16, 70, 128, True, "with"), (1, 6, 10, 3, 8, True, "only"),
    (1, 34, 18, 16, 72, True, "with"),  # H = 2 x 16 + 2, C = 64 + 8: ragged tiles
])
def test_conv_block_bwd_pool_kernel_matches_plain(dev, b, h, w, cin, c, need_dx, mode, dtype):
    """The pooled cotangent: da_3 bit-equal to the plain version's (in bf16
    too: one rounding of a float32 sum of two bf16 values), the whole
    backward within 1e-4 in float32 and bit-equal repeats; its launches
    count under the wrapper and its pool mode."""
    gen = torch.Generator().manual_seed(cin + h + 5)
    g, x, h1, h2, h3, *ws = _saved(gen, b, h, w, cin, c, dev)
    gp = torch.randn(b, h // 2, w // 2, c, generator=gen).to(dev)
    g, x, h1, h2, h3, gp = (t.to(dtype) for t in (g, x, h1, h2, h3, gp))
    g = g if mode == "with" else None
    da3 = kconv.masked_cotangent_kernel(g, gp, h3)
    assert torch.equal(da3, kconv.masked_cotangent_plain(g, gp, h3))
    before = (kconv.conv_block_bwd.launches, kconv.conv_block_bwd.launches_pool)
    bf16 = dtype == torch.bfloat16
    if bf16:
        before = (kconv.conv_block_bwd.launches_bf16, kconv.conv_block_bwd.launches_pool_bf16)
    args = (g, x, h1, h2, h3, *ws)
    out = kconv.conv_block_bwd(*args, need_dx=need_dx, gp=gp)
    again = kconv.conv_block_bwd(*args, need_dx=need_dx, gp=gp)
    torch.cuda.synchronize()
    after = ((kconv.conv_block_bwd.launches_bf16, kconv.conv_block_bwd.launches_pool_bf16) if bf16
             else (kconv.conv_block_bwd.launches, kconv.conv_block_bwd.launches_pool))
    assert after == (before[0] + 2, before[1] + 2)
    for a, a2 in zip(out, again):
        assert (a is None and a2 is None) or torch.equal(a, a2)
    ref = kconv.conv_block_bwd_plain(*args, need_dx, gp=gp)
    if bf16:  # dW, db float32 sums of the same bf16 da_3 and h2 (layer 3)
        _assert_rel(out[5], ref[5])
        _assert_rel(out[6], ref[6])
    else:
        _assert_all_rel(out, ref)


@pytest.mark.parametrize("b,h,w,ca,cb,c", [
    (2, 9, 13, 1, 0, 64), (1, 17, 33, 2, 0, 40), (2, 12, 20, 70, 0, 128), (1, 9, 9, 6, 0, 10),
    (2, 10, 12, 13, 7, 24), (1, 16, 16, 64, 32, 64),
    # bf16: h1 and h2 rebuilt on the wgmma body, from channel counts off its chunk
    (2, 16, 20, 48, 0, 72), (1, 17, 21, 40, 24, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recompute_bwd_is_the_saved_h_bwd(dev, b, h, w, ca, cb, c, dtype):
    """The mixed mode's backward rebuilds h1 and h2 with the forward
    kernel's own layers, so from the forward kernel's h3 it gives the
    saved-h backward's outputs bit for bit, with or without the pooled
    cotangent; its launches count under the recompute mode."""
    gen = torch.Generator().manual_seed(ca + cb + h)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev).to(dtype)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev).to(dtype) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    h1, h2, h3 = kconv._launch(xa, xb, *ws)
    g = torch.randn(b, h, w, c, generator=gen).to(dev).to(dtype)
    kw = {"gp": torch.randn(b, h // 2, w // 2, c, generator=gen).to(dev).to(dtype)} \
        if h % 2 == 0 and w % 2 == 0 and not cb else {}
    wrapper = kconv.conv_block_bwd if xb is None else kconv.conv_block_bwd_dual
    name = "launches_recompute" + ("_bf16" if dtype == torch.bfloat16 else "")
    before = getattr(wrapper, name)
    if xb is None:
        saved = kconv.conv_block_bwd(g, xa, h1, h2, h3, *ws[::2], **kw)
        out = kconv.conv_block_bwd(g, xa, None, None, h3, *ws[::2], b1=ws[1], b2=ws[3], **kw)
    else:
        saved = kconv.conv_block_bwd_dual(g, xa, xb, h1, h2, h3, *ws[::2])
        out = kconv.conv_block_bwd_dual(g, xa, xb, None, None, h3, *ws[::2], b1=ws[1],
                                        b2=ws[3])
    torch.cuda.synchronize()
    assert getattr(wrapper, name) == before + 1
    for a, r in zip(out, saved):
        assert (a is None and r is None) or torch.equal(a, r)


def _plain_dgrad64(da, w, mask):
    """One bf16 dgrad layer as the kernel computes it, summed in float64: the
    kernel rounded to bf16 and flipped, masked by [mask > 0] (none for dx),
    rounded to bf16 once."""
    wk = kconv.bf16_operand(w, torch.float64).flip(0, 1).permute(2, 3, 0, 1)
    r = torch.nn.functional.conv2d(da.double().permute(0, 3, 1, 2), wk, padding=1)
    r = r.permute(0, 2, 3, 1)
    if mask is not None:
        r = torch.where(mask > 0, r, 0.0)
    return r.to(torch.bfloat16).contiguous()


def _bf16_bwd_layers(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, gp=None):
    """The bf16 backward kernel layer by layer, each layer from the kernel's
    own cotangent to it (its da workspaces): dW and db within 1e-4 of their
    largest value against float64 sums, da_2, da_1 and dx by the bf16 layer
    rule against the plain dgrad in float64 sums; twice bit-equal. Returns
    the outputs (dxa, dxb, dw1, db1, .., db3)."""
    workspaces = (torch.empty_like(h3), torch.empty_like(h3))
    out = kconv._launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, workspaces, gp=gp)
    again = kconv._launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, gp=gp)
    torch.cuda.synchronize()
    assert all((a is None and r is None) or torch.equal(a, r) for a, r in zip(out, again))
    dxa, dxb, dw1, db1, dw2, db2, dw3, db3 = out
    da1, da2 = workspaces
    da3 = kconv.masked_cotangent_plain(g, gp, h3)
    x = xa if xb is None else torch.cat([xa, xb], dim=-1)
    for (dw, db), h_in, da in (((dw3, db3), h2, da3), ((dw2, db2), h1, da2),
                               ((dw1, db1), x, da1)):
        _assert_rel(dw.double(), kconv._wgrad_plain(h_in.double(), da.double()))
        _assert_rel(db.double(), da.double().sum(dim=(0, 1, 2)))
    _assert_bf16_layer(da2, _plain_dgrad64(da3, w3, h2))
    _assert_bf16_layer(da1, _plain_dgrad64(da2, w2, h1))
    if dxa is not None:
        dx = dxa if xb is None else torch.cat([dxa, dxb], dim=-1)
        _assert_bf16_layer(dx, _plain_dgrad64(da1, w1, None))
    return out


def _bf16_saved(gen, b, h, w, ca, cb, c, dev):
    """(g, xa, xb or None, h1, h2, h3, w1, w2, w3) in bf16 (weights float32):
    h1..h3 from the bf16 forward kernel."""
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev).to(torch.bfloat16)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev).to(torch.bfloat16) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    hs = kconv._launch(xa, xb, *ws)
    g = torch.randn(b, h, w, c, generator=gen).to(dev).to(torch.bfloat16)
    return (g, xa, xb, *hs, *ws[::2])


@pytest.mark.parametrize("b,h,w,ca,cb,c,need_dx,wgmma", [
    # the edges of the bf16 backward's wgmma bodies (the dgrad on the
    # forward's: 64-channel chunks, 8 x 16 or 16 x 16 pixel tiles; the wgrad:
    # 64-channel input slices, 8 x 8-pixel tiles, 128 output channels a block
    # or 64 with the two consumers on alternate tiles): odd H and W, batch 1,
    # channel counts off the slice
    (1, 33, 45, 8, 0, 8, True, True), (1, 33, 45, 16, 0, 16, True, True),
    (1, 33, 45, 48, 0, 72, True, True), (2, 22, 30, 72, 0, 136, True, True),
    (1, 17, 19, 256, 0, 512, True, True), (2, 20, 24, 64, 0, 64, True, True),
    # the entry blocks: their first wgrad stays on the mma.sync body by shape
    (2, 33, 45, 1, 0, 64, False, True), (1, 33, 45, 2, 0, 16, False, True),
    # ... but a dx of 1 channel cannot be a tensor map's: off the route
    (1, 17, 23, 1, 0, 16, True, False),
    # dual splits off the slice boundary, dx split at Ca
    (1, 33, 45, 40, 24, 64, True, True), (2, 21, 30, 200, 72, 128, True, True),
    # channel counts off 8: the first layer's wgrad and dx on the mma.sync bodies
    (1, 17, 19, 3, 0, 48, True, False), (1, 9, 11, 20, 12, 40, True, False),
])
def test_bf16_backward_layers_match_plain(dev, b, h, w, ca, cb, c, need_dx, wgmma):
    """The bf16 backward (conv_block_bwd[_dual]) layer by layer against
    float64 sums (:func:`_bf16_bwd_layers`), then through the wrapper: its
    launch counts in launches_wgmma_bf16 when every dgrad and every wgrad
    but an entry layer's took the wgmma bodies."""
    gen = torch.Generator().manual_seed(ca * 100 + cb + c + 1)
    g, xa, xb, h1, h2, h3, *ws = _bf16_saved(gen, b, h, w, ca, cb, c, dev)
    out = _bf16_bwd_layers(g, xa, xb, h1, h2, h3, *ws, need_dx)
    wrapper = kconv.conv_block_bwd if xb is None else kconv.conv_block_bwd_dual
    before = (wrapper.launches_bf16, wrapper.launches_wgmma_bf16)
    if xb is None:
        again = wrapper(g, xa, h1, h2, h3, *ws, need_dx=need_dx)
        out = (out[0], *out[2:])
    else:
        again = wrapper(g, xa, xb, h1, h2, h3, *ws)
    torch.cuda.synchronize()
    assert all((a is None and r is None) or torch.equal(a, r) for a, r in zip(out, again))
    assert (wrapper.launches_bf16, wrapper.launches_wgmma_bf16) == (before[0] + 1,
                                                                     before[1] + int(wgmma))


@pytest.mark.parametrize("mode", ["with", "only", "recompute"])
def test_bf16_backward_modes_on_the_wgmma_bodies(dev, mode):
    """The pooled cotangent ("with": g and gp; "only": gp) layer by layer
    from its da_3, and the recompute bit-equal to the saved-h backward, on
    the wgmma bodies: each launch counts under its mode and the route."""
    b, h, w, cin, c = 2, 34, 46, 48, 72
    gen = torch.Generator().manual_seed(17)
    g, x, _, h1, h2, h3, *ws = _bf16_saved(gen, b, h, w, cin, 0, c, dev)
    gp = torch.randn(b, h // 2, w // 2, c, generator=gen).to(dev).to(torch.bfloat16)
    wrapper = kconv.conv_block_bwd
    names = ("launches_bf16", "launches_wgmma_bf16",
             "launches_pool_bf16" if mode != "recompute" else "launches_recompute_bf16")
    before = [getattr(wrapper, n) for n in names]
    if mode == "recompute":
        fw = _weights(gen, cin, c, dev)  # with the biases the recompute takes
        h1, h2, h3 = kconv._launch(x, None, *fw)
        saved = wrapper(g, x, h1, h2, h3, *fw[::2])
        out = wrapper(g, x, None, None, h3, *fw[::2], b1=fw[1], b2=fw[3])
        assert all(torch.equal(a, r) for a, r in zip(out, saved))
        count = 2
    else:
        g = g if mode == "with" else None
        _bf16_bwd_layers(g, x, None, h1, h2, h3, *ws, True, gp=gp)
        wrapper(g, x, h1, h2, h3, *ws, gp=gp)
        count = 1
    torch.cuda.synchronize()
    assert [getattr(wrapper, n) for n in names] == [v + count if n != names[2] else v + 1
                                                   for n, v in zip(names, before)]


def test_bf16_backward_on_an_unaligned_input_takes_the_mma_sync_wgrad(dev):
    """A bf16 input 2 bytes off a 16-byte boundary cannot be a tensor map's:
    its wgrad runs on the mma.sync body, the launch counted off the wgmma
    route, and every layer holds as on the aligned input."""
    gen = torch.Generator().manual_seed(6)
    b, h, w, cin, c = 1, 19, 23, 64, 72
    flat = torch.randn(b * h * w * cin + 1, generator=gen).to(dev).to(torch.bfloat16)
    x = flat[1:].view(b, h, w, cin)
    assert x.data_ptr() % 16 != 0
    ws = _weights(gen, cin, c, dev)
    h1, h2, h3 = kconv._launch(x, None, *ws)
    g = torch.randn(b, h, w, c, generator=gen).to(dev).to(torch.bfloat16)
    _bf16_bwd_layers(g, x, None, h1, h2, h3, *ws[::2], True)
    before = (kconv.conv_block_bwd.launches_bf16, kconv.conv_block_bwd.launches_wgmma_bf16)
    kconv.conv_block_bwd(g, x, h1, h2, h3, *ws[::2])
    torch.cuda.synchronize()
    assert (kconv.conv_block_bwd.launches_bf16,
            kconv.conv_block_bwd.launches_wgmma_bf16) == (before[0] + 1, before[1])


@pytest.mark.parametrize("hwoi", [True, False])
@pytest.mark.parametrize("ci,c", [(5, 7), (64, 128), (512, 256)])
def test_tf32_planes_kernel_matches_plain(dev, hwoi, ci, c):
    """The float32 kernels' weight copy (csrc/tf32_planes.cu): the kernel,
    its hi and its lo planes bit-equal to the plain version's, inf and NaN
    passed through, in the forward's HWOI order and the dgrad's HWIO."""
    gen = torch.Generator().manual_seed(ci + c)
    w = torch.randn(3, 3, ci, c, generator=gen) * torch.exp(8 * torch.randn(3, 3, ci, c,
                                                                         generator=gen))
    w.view(-1)[:3] = torch.tensor([float("inf"), float("-inf"), float("nan")])
    w = w.to(dev)
    out = kconv.tf32_planes(w, hwoi)
    torch.cuda.synchronize()
    ref = kconv.tf32_planes_plain(w.cpu(), hwoi)
    assert out.shape == ref.shape
    out = out.cpu()
    finite = torch.isfinite(ref)  # a NaN's payload is the device's own
    assert torch.equal(torch.isfinite(out), finite) and torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(torch.where(finite, out, 0.0).view(torch.int32),
                       torch.where(finite, ref, 0.0).view(torch.int32))
    assert torch.equal(out[:2].view(torch.int32), ref[:2].view(torch.int32))  # w and hi: all bits


def _f32_layer_checks(outs, refs, refs64):
    """Each float32 layer within 1e-4 of the plain layer's largest value and
    within 1e-5 of the float64 layer's (chip_smoke.py's K12 tolerances)."""
    for out, ref, ref64 in zip(outs, refs, refs64):
        assert bool(torch.isfinite(out).all())
        _assert_rel(out, ref, 1e-4)
        _assert_rel(out.double(), ref64, 1e-5)


def _f32_block_layers(xa, xb, ws):
    """h1, h2, h3 of the float32 forward kernel, each layer held against the
    plain layer in float32 and float64 from the kernel's own input to it;
    twice bit-equal."""
    hs = kconv._launch(xa, xb, *ws)
    again = kconv._launch(xa, xb, *ws)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(hs, again))
    h_in = xa if xb is None else torch.cat([xa, xb], dim=-1)
    for k, h in enumerate(hs):
        w, b = ws[2 * k], ws[2 * k + 1]
        ref = kconv.conv_relu_layer(h_in.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)
        ref64 = kconv.conv_relu_layer(h_in.double().permute(0, 3, 1, 2), w.double(),
                                      b.double()).permute(0, 2, 3, 1)
        _f32_layer_checks([h], [ref], [ref64])
        h_in = h
    return hs


@pytest.mark.parametrize("b,h,w,ca,cb,c,wgmma", [
    # the flagship's forward shapes, cut in size: every block but the entry
    # layer's first on the 3xTF32 wgmma body (32-channel chunks, 8 x 16 pixel
    # tiles at Cout > 64, 16 x 16 at Cout <= 64), odd H and W
    (2, 33, 45, 64, 0, 128, True), (1, 34, 30, 128, 0, 256, True),
    (1, 17, 19, 256, 0, 512, True), (1, 32, 32, 256, 0, 512, True),  # Lung's 1 x 32^2
    (1, 33, 45, 1, 0, 64, True), (2, 20, 24, 2, 0, 64, True),  # the entry layer, then two
    # ragged chunks: C = 16, 48 (one chunk half or a quarter past the channels)
    (1, 33, 45, 16, 0, 16, True), (1, 33, 45, 48, 0, 72, True), (1, 21, 23, 8, 0, 8, True),
    # dual inputs: [upsample | skip], split on and off a chunk boundary
    (1, 33, 45, 128, 64, 64, True), (2, 21, 30, 512, 256, 256, True),
    (1, 19, 17, 40, 24, 64, True),
    # channel counts off 8: the mma.sync body by its count
    (1, 17, 19, 3, 0, 48, False), (1, 9, 11, 20, 12, 40, False),
])
def test_f32_forward_layers_on_the_wgmma_body(dev, b, h, w, ca, cb, c, wgmma):
    """The float32 forward (K1, K2) layer by layer against the plain layer
    in float32 and float64, twice bit-equal, and through the wrapper: its
    launch counts in launches_wgmma_f32 when every layer but a 1- or
    2-channel entry layer took the 3xTF32 wgmma body."""
    gen = torch.Generator().manual_seed(ca * 100 + cb + c + 3)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    wrapper = conv_block_fwd if xb is None else conv_block_fwd_dual
    before = (wrapper.launches, wrapper.launches_wgmma_f32)
    with torch.no_grad():
        hs = _f32_block_layers(xa, xb, ws)
        out = wrapper(xa, *ws) if xb is None else wrapper(xa, xb, *ws)
    torch.cuda.synchronize()
    assert torch.equal(out, hs[2])
    assert (wrapper.launches, wrapper.launches_wgmma_f32) == (before[0] + 1,
                                                              before[1] + int(wgmma))


def test_f32_forward_on_an_unaligned_input_takes_the_mma_sync_body(dev):
    """A float32 input 4 bytes off a 16-byte boundary cannot be a tensor
    map's: its first layer runs on the mma.sync body, the launch counted off
    the wgmma route, and every layer holds as on an aligned input."""
    gen = torch.Generator().manual_seed(9)
    b, h, w, cin, c = 1, 19, 23, 64, 72
    flat = torch.randn(b * h * w * cin + 1, generator=gen).to(dev)
    x = flat[1:].view(b, h, w, cin)
    assert x.data_ptr() % 16 != 0
    ws = _weights(gen, cin, c, dev)
    before = (conv_block_fwd.launches, conv_block_fwd.launches_wgmma_f32)
    with torch.no_grad():
        _f32_block_layers(x, None, ws)
        conv_block_fwd(x, *ws)
    torch.cuda.synchronize()
    assert (conv_block_fwd.launches, conv_block_fwd.launches_wgmma_f32) == (before[0] + 1,
                                                                          before[1])


def _f32_dgrad64(da, w, mask):
    """One float32 dgrad layer summed in float64: the kernel flipped, masked
    by [mask > 0] (none for dx)."""
    wk = w.double().flip(0, 1).permute(2, 3, 0, 1)
    r = torch.nn.functional.conv2d(da.double().permute(0, 3, 1, 2), wk, padding=1)
    r = r.permute(0, 2, 3, 1)
    return r if mask is None else torch.where(mask > 0, r, 0.0)


@pytest.mark.parametrize("b,h,w,ca,cb,c,need_dx,wgmma", [
    # the flagship's backward shapes, cut in size: every dgrad on the wgmma body
    (2, 33, 45, 64, 0, 128, True, True), (1, 34, 30, 128, 0, 256, True, True),
    (1, 17, 19, 256, 0, 512, True, True), (2, 32, 32, 256, 0, 512, True, True),
    (2, 33, 45, 1, 0, 64, False, True), (1, 33, 45, 2, 0, 64, False, True),  # entry blocks
    # ragged chunks of da (C = 16, 48) and of dx's channels
    (1, 33, 45, 16, 0, 16, True, True), (1, 33, 45, 48, 0, 72, True, True),
    # the dual blocks: dx split into dxa | dxb
    (1, 33, 45, 128, 64, 64, True, True), (2, 21, 30, 512, 256, 256, True, True),
    (1, 19, 17, 40, 24, 64, True, True),
    # a dx of 1 channel, and counts off 8: dx on the mma.sync body
    (1, 17, 23, 1, 0, 16, True, False), (1, 9, 11, 20, 12, 40, True, False),
])
def test_f32_dgrad_layers_on_the_wgmma_body(dev, b, h, w, ca, cb, c, need_dx, wgmma):
    """The float32 backward's dgrads layer by layer, each from the kernel's
    own cotangent to it (its da workspaces): da_2 and da_1 (masked by h2,
    h1) and dx (split at Ca) within 1e-4 of the plain dgrad in float32 and
    1e-5 of it in float64; twice bit-equal; through the wrapper its launch
    counts in launches_wgmma_f32 when every dgrad took the wgmma body."""
    gen = torch.Generator().manual_seed(ca * 100 + cb + c + 4)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    h1, h2, h3 = kconv._launch(xa, xb, *ws)
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    w1, w2, w3 = ws[::2]
    workspaces = (torch.empty_like(h3), torch.empty_like(h3))
    out = kconv._launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx, workspaces)
    again = kconv._launch_bwd(g, xa, xb, h1, h2, h3, w1, w2, w3, need_dx)
    torch.cuda.synchronize()
    assert all((a is None and r is None) or torch.equal(a, r) for a, r in zip(out, again))
    da1, da2 = workspaces
    da3 = kconv.masked_cotangent_plain(g, None, h3)
    pairs = [(da2, da3, w3, h2), (da1, da2, w2, h1)]
    if out[0] is not None:
        dx = out[0] if xb is None else torch.cat([out[0], out[1]], dim=-1)
        pairs.append((dx, da1, w1, None))
    for got, da, wk, mask in pairs:
        ref = torch.nn.functional.conv2d(da.permute(0, 3, 1, 2),
                                         wk.flip(0, 1).permute(2, 3, 0, 1), padding=1)
        ref = ref.permute(0, 2, 3, 1)
        if mask is not None:
            ref = torch.where(mask > 0, ref, 0.0)
            assert bool(((got == 0) | (mask > 0)).all())  # masked to +0
        _f32_layer_checks([got], [ref], [_f32_dgrad64(da, wk, mask)])
    wrapper = kconv.conv_block_bwd if xb is None else kconv.conv_block_bwd_dual
    before = (wrapper.launches, wrapper.launches_wgmma_f32)
    if xb is None:
        again = wrapper(g, xa, h1, h2, h3, w1, w2, w3, need_dx=need_dx)
        out = (out[0], *out[2:])
    else:
        again = wrapper(g, xa, xb, h1, h2, h3, w1, w2, w3)
    torch.cuda.synchronize()
    assert all((a is None and r is None) or torch.equal(a, r) for a, r in zip(out, again))
    assert (wrapper.launches, wrapper.launches_wgmma_f32) == (before[0] + 1,
                                                              before[1] + int(wgmma))


def _f32_wgrad_inputs(gen, b, h, w, ca, cb, c, dev):
    """(xa, xb or None, da) of one wgrad layer: post-ReLU inputs and a
    cotangent masked to about half its pixels, as the backward's are."""
    xa = torch.relu(torch.randn(b, h, w, ca, generator=gen)).to(dev)
    xb = torch.relu(torch.randn(b, h, w, cb, generator=gen)).to(dev) if cb else None
    da = torch.randn(b, h, w, c, generator=gen) * (torch.rand(b, h, w, c, generator=gen) > 0.5)
    return xa, xb, da.to(dev)


def _f32_wgrad_checks(xa, xb, da, route):
    """One layer's float32 wgrad (``wgrad_kernel``) on ``route``: dW and db
    within 1e-4 of the plain version's largest value and within 1e-5 of the
    float64 one's, twice bit-equal."""
    assert kconv.wgrad_route(xa, da, xb) == route
    out, again = kconv.wgrad_kernel(xa, da, xb), kconv.wgrad_kernel(xa, da, xb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(out, again))
    refs = kconv.wgrad_plain(xa, da, xb)
    refs64 = kconv.wgrad_plain(xa.double(), da.double(), None if xb is None else xb.double())
    _f32_layer_checks(out, refs, refs64)


@pytest.mark.parametrize("b,h,w,ca,cb,c,route", [
    # the flagship's wgrad shapes, cut in size, at the 3xTF32 wgmma body's
    # edges (4 x 8-pixel tiles, 32-channel input slices, 128 output channels
    # a block or 64 with the two consumers on alternate tiles)
    (1, 17, 23, 16, 0, 32, "wgmma"),   # H = 4 x 4 + 1, W = 2 x 8 + 7: ragged tiles
    (1, 16, 16, 64, 0, 72, "wgmma"),   # C = 64 + 8: a block of 128 output channels, 72 real
    (2, 17, 23, 72, 0, 64, "wgmma"),   # Cin = 2 x 32 + 8: a ragged input slice
    (1, 33, 45, 48, 0, 136, "wgmma"), (2, 20, 24, 256, 0, 512, "wgmma"),
    (2, 8, 8, 512, 0, 512, "wgmma"),   # fewer tiles than chunks would fill
    # dual inputs: the slices split at Ca, on and off a 32-channel boundary
    (1, 17, 23, 40, 24, 64, "wgmma"), (2, 21, 30, 512, 256, 256, "wgmma"),
    (1, 19, 17, 128, 64, 64, "wgmma"),
    # the entry layers on the FMA pipes
    (2, 33, 45, 1, 0, 64, "entry"), (1, 33, 45, 2, 0, 64, "entry"),
    # channel counts off 8: the mma.sync body
    (2, 8, 16, 33, 0, 48, "tc"), (1, 9, 11, 20, 12, 40, "tc"), (1, 9, 9, 6, 0, 10, "tc"),
])
def test_f32_wgrad_layers_on_the_wgmma_body(dev, b, h, w, ca, cb, c, route):
    """One float32 wgrad layer on the body its shape routes it to
    (``wgrad_route``), held against the plain version in float32 and
    float64 (:func:`_f32_wgrad_checks`)."""
    gen = torch.Generator().manual_seed(ca * 100 + cb + c + 7)
    _f32_wgrad_checks(*_f32_wgrad_inputs(gen, b, h, w, ca, cb, c, dev), route)


def test_f32_wgrad_workspace_covers_every_mt_layer(dev):
    """The partials of the wgmma wgrad (its chunk count is the card's)
    fit the work buffer the backward allocates, at every wgrad layer of the
    MT step; the layer with the most chunks then runs, held as above (an
    undersized buffer would be written past its end without an error)."""
    import ctypes

    from pda_torch.kernels import _build
    from pda_torch.tools import workload as wl

    blocks = ([(*s[:3], s[3], 0, s[4]) for s, *_ in wl.BWD_SHAPES] + list(wl.BWD_DUAL_SHAPES))
    floats = _build.entry("pda_wgrad_wgmma_floats", (ctypes.c_int,) * 6, ctypes.c_longlong)
    work = _build.entry("pda_conv_block_bwd_work", (ctypes.c_int,) * 5, ctypes.c_longlong)
    most = (0, None)
    for b, h, w, ca, cb, c in blocks:
        for la, lb in ((ca, cb), (c, 0)):  # the first layer; layers 2 and 3
            if cb == 0 and la < 3:
                continue  # an entry layer: wgrad_entry
            need = floats(la, lb, c, b, h, w)
            assert need <= work(b, h, w, ca + cb, c), (b, h, w, la, lb, c)
            # ~ the partial dW it writes: chunks, twice that with the split consumers
            most = max(most, (need / (9 * (la + lb) * c), (b, h, w, la, lb, c)))
    b, h, w, la, lb, c = most[1]
    gen = torch.Generator().manual_seed(23)
    _f32_wgrad_checks(*_f32_wgrad_inputs(gen, b, h, w, la, lb, c, dev), "wgmma")


def test_f32_backward_on_an_unaligned_input_takes_the_mma_sync_wgrad(dev):
    """A float32 input 4 bytes off a 16-byte boundary cannot be a tensor
    map's: its wgrad runs on the mma.sync body (and its dx on the mma.sync
    dgrad), the launch counted off the wgmma route; every output holds as on
    an aligned input."""
    gen = torch.Generator().manual_seed(10)
    b, h, w, cin, c = 1, 19, 23, 64, 72
    flat = torch.randn(b * h * w * cin + 1, generator=gen).to(dev)
    x = flat[1:].view(b, h, w, cin)
    assert x.data_ptr() % 16 != 0
    ws = _weights(gen, cin, c, dev)
    h1, h2, h3 = kconv._launch(x, None, *ws)
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    da = kconv.masked_cotangent_plain(g, None, h3)
    _f32_wgrad_checks(x, None, da, "tc")
    before = (kconv.conv_block_bwd.launches, kconv.conv_block_bwd.launches_wgmma_f32)
    out = kconv.conv_block_bwd(g, x, h1, h2, h3, *ws[::2])
    torch.cuda.synchronize()
    assert (kconv.conv_block_bwd.launches,
            kconv.conv_block_bwd.launches_wgmma_f32) == (before[0] + 1, before[1])
    _assert_all_rel(out, kconv.conv_block_bwd_plain(g, x, h1, h2, h3, *ws[::2]))


@pytest.mark.parametrize("b,h,w,ca,cb,c", [(2, 32, 36, 64, 0, 128), (1, 34, 30, 16, 0, 72),
                                           (1, 33, 45, 128, 64, 64)])
def test_f32_recompute_on_the_wgmma_body(dev, b, h, w, ca, cb, c):
    """The mixed mode's float32 backward rebuilds h1 and h2 with the
    forward's own wgmma layers, so from the forward kernel's h3 it gives the
    saved-h backward's outputs bit for bit (a bit of h1 or h2 off would move
    dW2, dW3 and the masks); its launch counts under the recompute mode and
    the route."""
    gen = torch.Generator().manual_seed(ca + cb + c + 5)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    h1, h2, h3 = kconv._launch(xa, xb, *ws)
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    wrapper = kconv.conv_block_bwd if xb is None else kconv.conv_block_bwd_dual
    names = ("launches", "launches_recompute", "launches_wgmma_f32")
    before = [getattr(wrapper, n) for n in names]
    xs = (xa,) if xb is None else (xa, xb)
    saved = wrapper(g, *xs, h1, h2, h3, *ws[::2])
    out = wrapper(g, *xs, None, None, h3, *ws[::2], b1=ws[1], b2=ws[3])
    torch.cuda.synchronize()
    assert all((a is None and r is None) or torch.equal(a, r) for a, r in zip(out, saved))
    assert [getattr(wrapper, n) for n in names] == [before[0] + 2, before[1] + 1, before[2] + 2]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("ca,cb,c", [(64, 0, 128), (256, 0, 512), (128, 64, 64)])
def test_f32_row_shards_are_the_whole_image(dev, m, ca, cb, c):
    """m row shards, each extended by the halo's rows on its inner sides
    (sliced from the whole tensors, as the halo exchange delivers them): on
    the 3xTF32 wgmma body the forward's h3 and the backward's dx, da_2 and
    da_1 on the shard's own rows are the whole image's bit for bit (each
    pixel's sums run in one order wherever its tile lies)."""
    from pda_torch.models.blocks import HALO

    b, h, w = 2, 48, 40
    gen = torch.Generator().manual_seed(ca + cb + c + m)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev) if cb else None
    ws = _weights(gen, ca + cb, c, dev)
    g = torch.randn(b, h, w, c, generator=gen).to(dev)
    whole_h = kconv._launch(xa, xb, *ws)
    whole_ws = (torch.empty_like(g), torch.empty_like(g))
    whole = kconv._launch_bwd(g, xa, xb, *whole_h, *ws[::2], True, whole_ws)
    rows = h // m
    for s in range(m):
        top, bottom = (HALO if s > 0 else 0), (HALO if s < m - 1 else 0)
        lo, hi = s * rows - top, (s + 1) * rows + bottom
        own = slice(top, top + rows)

        def part(t):
            return None if t is None else t[:, lo:hi].contiguous()

        hs = kconv._launch(part(xa), part(xb), *ws)
        assert torch.equal(hs[2][:, own], whole_h[2][:, s * rows:(s + 1) * rows])
        wsp = (torch.empty_like(hs[2]), torch.empty_like(hs[2]))
        out = kconv._launch_bwd(part(g), part(xa), part(xb), *map(part, whole_h), *ws[::2],
                                True, wsp)
        for got, ref in ((out[0], whole[0]), (out[1], whole[1]), (wsp[0], whole_ws[0]),
                         (wsp[1], whole_ws[1])):
            if ref is not None:
                assert torch.equal(got[:, own], ref[:, s * rows:(s + 1) * rows])


def test_mixed_mean_teacher_step_on_card_matches_cpu(dev, monkeypatch):
    """The small MT step of the test below under PDA_PALLAS_CONV_MODE=mixed:
    the forwards on cuDNN (no forward kernel launch), every backward with
    recompute, pooled blocks with the pooled cotangent; card against CPU."""
    monkeypatch.setenv("PDA_PALLAS_CONV_MODE", "mixed")
    for fn in (kconv.conv_block_fwd, kconv.conv_block_bwd, kconv.conv_block_bwd_dual):
        fn.launches = 0
    kconv.conv_block_bwd.launches_recompute = kconv.conv_block_bwd.launches_pool = 0
    test_mean_teacher_step_on_card_matches_cpu(dev)
    assert kconv.conv_block_fwd.launches == 0
    assert kconv.conv_block_bwd.launches == kconv.conv_block_bwd.launches_recompute == 12
    assert kconv.conv_block_bwd.launches_pool == 9 and kconv.conv_block_bwd_dual.launches == 3


def test_mean_teacher_step_on_card_matches_cpu(dev):
    """One small MT step (masking on) on the card against the same port on
    the CPU: same weights, batch and noise. The CPU step takes the card
    teacher's pseudo-labels, so that a consensus pixel flipped within the
    MC kernel's threshold window does not count as a step difference."""
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step
    from pda_torch.train import steps

    gen = torch.Generator().manual_seed(0)
    model = ProbabilisticUnet(num_filters=(32, 32, 48, 64), latent_dim=6, no_convs_fcomb=3,
                              beta=1.0, rl_swap=True, consensus_masking=True, generator=gen)
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(16.0)
    x = torch.randn(2, 32, 32, 1, generator=gen)
    batch = (x, x + 0.1 * torch.randn(x.shape, generator=gen),
             x + 0.1 * torch.randn(x.shape, generator=gen), (x > 0.5).float())
    noise = {"eps_teacher": torch.randn(16, 2, 6, generator=gen),
             "eps_post": torch.randn(2, 6, generator=gen)}
    step = make_mean_teacher_step(do_consensus_masking=True)
    on_card = copy.deepcopy(model).to(dev)
    card = create_train_state(on_card, adam(on_card.parameters(), 1e-5), with_teacher=True)
    cpu = create_train_state(model, adam(model.parameters(), 1e-5), with_teacher=True)
    y, z = steps._mc_pseudo(card.teacher, batch[1].to(dev), 16, True, noise["eps_teacher"])
    _, aux = step(card, *(a.to(dev) for a in batch), **{k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    pseudo = steps._mc_pseudo
    steps._mc_pseudo = lambda *a, **k: (y.cpu(), z.cpu())
    try:
        _, aux_cpu = step(cpu, *batch, **noise)
    finally:
        steps._mc_pseudo = pseudo
    assert 0.0 < float(z.mean()) < 1.0
    for k, v in aux_cpu.items():
        assert abs(float(aux[k]) - float(v)) <= 1e-4 * max(1.0, abs(float(v))), k
    for (name, p), p_cpu in zip(card.model.named_parameters(), cpu.model.parameters()):
        g, g_cpu = p.grad.cpu(), p_cpu.grad
        assert float((g - g_cpu).abs().max()) <= 1e-3 * float(g_cpu.abs().max()), name
        noisy = g_cpu.abs() <= 1e-3 * g_cpu.abs().max()  # Adam's sign is noise there
        diff = (p.detach().cpu() - p_cpu.detach()).abs()
        assert float(torch.where(noisy, 0.0, diff).max()) <= 1e-6, name
    for p, p_cpu in zip(card.teacher.parameters(), cpu.teacher.parameters()):
        assert float((p.cpu() - p_cpu).abs().max()) <= 1e-6


@pytest.mark.parametrize("masking", [False, True])
def test_bce_mean_teacher_step_on_card_matches_cpu(dev, masking):
    """One small Mean-Teacher step of a PUNet with the Lung suite's BCE
    reconstruction (``rl_swap=False``: an unreduced sum over the pixels),
    consensus weighting or masking, on the card against the same port on the
    CPU, the CPU taking the card teacher's pseudo-labels; the tolerances of
    the dice-reconstruction test above, relative to each value's largest."""
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.train import adam, create_train_state, make_mean_teacher_step
    from pda_torch.train import steps

    gen = torch.Generator().manual_seed(3)
    model = ProbabilisticUnet(num_filters=(32, 32, 48, 64), latent_dim=6, no_convs_fcomb=3,
                              beta=1.0, rl_swap=False, consensus_masking=True, generator=gen)
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(16.0)
    x = torch.randn(2, 48, 40, 1, generator=gen)
    batch = (x, x + 0.1 * torch.randn(x.shape, generator=gen),
             x + 0.1 * torch.randn(x.shape, generator=gen), (x > 0.5).float())
    noise = {"eps_teacher": torch.randn(16, 2, 6, generator=gen),
             "eps_post": torch.randn(2, 6, generator=gen)}
    step = make_mean_teacher_step(do_consensus_masking=masking)
    on_card = copy.deepcopy(model).to(dev)
    card = create_train_state(on_card, adam(on_card.parameters(), 1e-5), with_teacher=True)
    cpu = create_train_state(model, adam(model.parameters(), 1e-5), with_teacher=True)
    y, z = steps._mc_pseudo(card.teacher, batch[1].to(dev), 16, masking,
                            noise["eps_teacher"].to(dev))
    _, aux = step(card, *(a.to(dev) for a in batch), **{k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    pseudo = steps._mc_pseudo
    steps._mc_pseudo = lambda *a, **k: (y.cpu(), z.cpu())
    try:
        _, aux_cpu = step(cpu, *batch, **noise)
    finally:
        steps._mc_pseudo = pseudo
    assert float(aux_cpu["recon_loss"]) > 100.0  # a sum over 2 x 48 x 40 pixels, not a mean
    for k, v in aux_cpu.items():
        assert abs(float(aux[k]) - float(v)) <= 1e-4 * max(1.0, abs(float(v))), k
    for (name, p), p_cpu in zip(card.model.named_parameters(), cpu.model.parameters()):
        g, g_cpu = p.grad.cpu(), p_cpu.grad
        assert float((g - g_cpu).abs().max()) <= 1e-3 * float(g_cpu.abs().max()), name
        noisy = g_cpu.abs() <= 1e-3 * g_cpu.abs().max()  # Adam's sign is noise there
        diff = (p.detach().cpu() - p_cpu.detach()).abs()
        assert float(torch.where(noisy, 0.0, diff).max()) <= 1e-6, name
    for p, p_cpu in zip(card.teacher.parameters(), cpu.teacher.parameters()):
        assert float((p.cpu() - p_cpu).abs().max()) <= 1e-6


def test_adamt_step_on_card_matches_cpu(dev):
    """One small AdaMT step (masking on, ramped EMA at step 0) on the card
    against the same port on the CPU, the CPU taking the card teacher's
    pseudo-labels; the kernel launches of a joint step."""
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.train import adam, create_train_state, make_adamt_step
    from pda_torch.train import steps

    gen = torch.Generator().manual_seed(0)
    model = ProbabilisticUnet(num_filters=(32, 32, 48, 64), latent_dim=6, no_convs_fcomb=3,
                              beta=1.0, rl_swap=True, consensus_masking=True, generator=gen)
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(16.0)
    xs, xt = torch.randn(2, 32, 32, 1, generator=gen), torch.randn(2, 32, 32, 1, generator=gen)
    batch = (xs, (xs > 0.3).float(), xt, xt + 0.1 * torch.randn(xt.shape, generator=gen),
             xt + 0.1 * torch.randn(xt.shape, generator=gen), (xt > 0.5).float())
    noise = {"eps_source": torch.randn(2, 6, generator=gen),
             "eps_teacher": torch.randn(16, 2, 6, generator=gen),
             "eps_post": torch.randn(2, 6, generator=gen)}
    step = make_adamt_step(do_consensus_masking=True)
    on_card = copy.deepcopy(model).to(dev)
    card = create_train_state(on_card, adam(on_card.parameters(), 1e-5), with_teacher=True)
    cpu = create_train_state(model, adam(model.parameters(), 1e-5), with_teacher=True)
    y, z = steps._mc_pseudo(card.teacher, batch[3].to(dev), 16, True, noise["eps_teacher"].to(dev))
    wrappers = (kconv.conv_block_fwd, kconv.conv_block_fwd_dual, mc_consensus,
                kconv.conv_block_bwd, kconv.conv_block_bwd_dual)
    before = [w.launches for w in wrappers]
    _, aux = step(card, *(a.to(dev) for a in batch), **{k: v.to(dev) for k, v in noise.items()})
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [32, 9, 1, 24, 6]
    pseudo = steps._mc_pseudo
    steps._mc_pseudo = lambda *a, **k: (y.cpu(), z.cpu())
    try:
        _, aux_cpu = step(cpu, *batch, **noise)
    finally:
        steps._mc_pseudo = pseudo
    assert 0.0 < float(z.mean()) < 1.0
    for k, v in aux_cpu.items():
        assert abs(float(aux[k]) - float(v)) <= 1e-4 * max(1.0, abs(float(v))), k
    for (name, p), p_cpu in zip(card.model.named_parameters(), cpu.model.parameters()):
        g, g_cpu = p.grad.cpu(), p_cpu.grad
        assert float((g - g_cpu).abs().max()) <= 1e-3 * float(g_cpu.abs().max()), name
        noisy = g_cpu.abs() <= 1e-3 * g_cpu.abs().max()  # Adam's sign is noise there
        diff = (p.detach().cpu() - p_cpu.detach()).abs()
        assert float(torch.where(noisy, 0.0, diff).max()) <= 1e-6, name
    for (name, p), p_cpu in zip(card.teacher.named_parameters(), cpu.teacher.parameters()):
        # at step 0 the ramp is 0: the teacher is the updated student
        assert torch.equal(p, dict(card.model.named_parameters())[name].detach()), name
        assert torch.equal(p_cpu, dict(cpu.model.named_parameters())[name].detach()), name


# -- the engine on the card ----------------------------------------------------------


def _mt_trainer(device, root, logger=False, name="mt"):
    """A small Mean-Teacher trainer (masking on) on seeded synthetic data:
    epochs of 2 steps of batch 2 at 32^2, one validation batch."""
    from pda_torch.data import DualImageCollectionDataset, Loader
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.models import ProbabilisticUnet
    from pda_torch.train import MeanTeacherTrainer, ReduceLROnPlateau

    model = ProbabilisticUnet(num_filters=(32, 32, 48, 64), latent_dim=6, no_convs_fcomb=3,
                              beta=1.0, rl_swap=True, consensus_masking=True,
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.fcomb.last_layer.weight.mul_(16.0)
    raws, labels = make_dataset_arrays(3, (48, 48), seed=1)

    def std(x, rng):
        return (x - x.mean()) / (x.std() + 1e-7) + 0.1 * rng.standard_normal(x.shape)

    def loader(n, seed):
        ds = DualImageCollectionDataset(raws, labels, patch_shape=(32, 32), augmentation1=std,
                                        augmentation2=std, n_samples=n, seed=seed)
        return Loader(ds, 2, seed=seed)

    return MeanTeacherTrainer(name, model, loader(4, 0), loader(2, 1), device=device,
                              save_root=str(root), logger=logger, log_image_interval=1,
                              lr_scheduler=ReduceLROnPlateau(), do_consensus_masking=True)


def test_mean_teacher_fit_on_card_matches_cpu(dev, tmp_path):
    """``fit(2)`` (one epoch, one validation) on the card against the CPU:
    the same seed gives the same noise. The CPU fit takes the card teacher's
    pseudo-labels (a consensus pixel may flip within the MC kernel's
    threshold window)."""
    from pda_torch.train import steps

    card, cpu = _mt_trainer("cuda", tmp_path / "card"), _mt_trainer("cpu", tmp_path / "cpu")
    pseudo, drawn, grads = steps._mc_pseudo, [], []

    def record(*a, **k):
        y, z = pseudo(*a, **k)
        drawn.append((y.cpu(), z.cpu()))
        return y, z

    card.initialize()
    train = card.train_step

    def train_step(state, *batch, **kw):
        out = train(state, *batch, **kw)
        grads.append({n: p.grad.cpu() for n, p in state.model.named_parameters()})
        return out

    card.train_step = train_step
    steps._mc_pseudo = record
    try:
        card.fit(2)
        replay = iter(drawn)

        def replayed(model, x, n_samples, masking, eps=None, generator=None, mesh=None):
            # the generator's draw of the card's call, then its pseudo-labels
            torch.randn((n_samples, x.shape[0], model.latent_dim), generator=generator)
            return next(replay)

        steps._mc_pseudo = replayed
        cpu.fit(2)
    finally:
        steps._mc_pseudo = pseudo
    assert len(drawn) == 3 and 0.0 < float(drawn[0][1].mean()) < 1.0
    for (i, a), (j, b) in zip(card.history + card.val_history, cpu.history + cpu.val_history):
        assert i == j and sorted(a) == sorted(b)
        for k, v in b.items():
            assert abs(a[k] - v) <= 1e-4 * max(1.0, abs(v)), (i, k)
    for (name, p), p_cpu in zip(card.state.model.named_parameters(),
                                cpu.state.model.parameters()):
        noisy = torch.zeros_like(p_cpu, dtype=torch.bool)
        for g in grads:  # Adam's sign is noise where a step's gradient is this small
            noisy |= g[name].abs() <= 1e-3 * g[name].abs().max()
        diff = (p.detach().cpu() - p_cpu.detach()).abs()
        assert float(torch.where(noisy, 0.0, diff).max()) <= 1e-6, name
        assert float(diff.max()) <= 4 * 1e-5 + 1e-6, name
    for p, p_cpu in zip(card.state.teacher.parameters(), cpu.state.teacher.parameters()):
        assert float((p.cpu() - p_cpu).abs().max()) <= 1e-6


def test_checkpoint_written_on_card_loads_on_cpu(dev, tmp_path):
    card = _mt_trainer("cuda", tmp_path)
    card.fit(2)
    cpu = _mt_trainer("cpu", tmp_path)
    blob = cpu.load_checkpoint("latest")
    assert cpu._iteration == 2 and all(v.device.type == "cpu" for v in blob["model_state"].values())
    for a, b in ((card.state.model, cpu.state.model), (card.state.teacher, cpu.state.teacher)):
        for (name, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert w.device.type == "cpu" and torch.equal(v.cpu(), w), name
    for k, s in card.state.optimizer.state_dict()["state"].items():
        s_cpu = cpu.state.optimizer.state_dict()["state"][k]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key].cpu(), s_cpu[key]), (k, key)
    assert torch.equal(card.generator.get_state(), cpu.generator.get_state())
    cpu.fit(3, overwrite_training=False)  # and trains on from there
    assert cpu._iteration == 3


def test_dcp_checkpoint_written_on_card_loads_on_cpu_and_card(dev, tmp_path):
    """``save_dcp`` of a card trainer's state (pda's ``save_orbax``), then
    ``load_dcp`` into a CPU and a card template: bit-equal to the card state
    and to the ``.pt`` path's restore, each tensor on its template's device
    (Adam's steps on the host, as a fresh optimizer keeps them)."""
    from pda_torch.train.dcp_io import load_dcp, save_dcp
    from torch_dp_worker import state_tensors

    def extra(t):
        return {"generator_state": t.generator.get_state(),
                "panel_generator_state": t.panel_generator.get_state(),
                "scheduler_state": t.lr_scheduler.state_dict()}

    card = _mt_trainer("cuda", tmp_path / "card")
    card.fit(2)
    save_dcp(str(tmp_path / "dcp"), card.state, extra=extra(card))
    by_pt = _mt_trainer("cpu", tmp_path / "card")
    by_pt.load_checkpoint("latest")
    want, pt = state_tensors(card.state, extra(card)), state_tensors(by_pt.state, extra(by_pt))
    assert want["step"] == 2
    for device in ("cpu", "cuda"):
        t = _mt_trainer(device, tmp_path / device)
        t.initialize()
        got_extra = {}
        load_dcp(str(tmp_path / "dcp"), t.state, extra=got_extra)
        got = state_tensors(t.state, got_extra)
        assert sorted(got) == sorted(want) == sorted(pt)
        for k, v in want.items():
            if not torch.is_tensor(v):
                assert got[k] == v == pt[k], k
                continue
            assert got[k].device == (v.device if device == "cuda" else torch.device("cpu")), k
            assert torch.equal(got[k].cpu(), v.cpu()) and torch.equal(got[k].cpu(), pt[k].cpu()), k


def test_plot_livecell_on_card_matches_plain_versions(dev, tmp_path):
    """``pda``'s development/plot_livecell.py on the card at full width
    (pda_torch/tools/plot_livecell.py): a 100 x 136 frame (padded to 112 x
    144), 8 conv_block_fwd and 3 conv_block_fwd_dual launches, the samples
    against every plain version on the card and against the CPU (1e-4; the
    consensus off only within 1e-4 of a threshold), then ``main`` on the
    card writes the panels."""
    from pda_torch.data import png
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.data.tiff import imwrite
    from pda_torch.models.punet import livecell_punet
    from pda_torch.tools import plot_livecell as pl

    img = make_dataset_arrays(1, (100, 136), seed=5)[0][0].astype(np.float32)
    imwrite(str(tmp_path / "frame.tif"), img)
    cpu = livecell_punet(generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        cpu.fcomb.last_layer.weight.mul_(8.0)
    torch.save({"model_state": cpu.state_dict()}, str(tmp_path / "best.pt"))
    model = pl.load_model(str(tmp_path), dev)
    norm = pl.standardize(pl.read_frame(str(tmp_path / "frame.tif")))
    eps = torch.randn(8, 1, 6, generator=torch.Generator().manual_seed(0))
    wrappers = (kconv.conv_block_fwd, kconv.conv_block_fwd_dual, mc_consensus)
    before = [w.launches for w in wrappers]
    out = pl.sample(model, norm, 8, eps=eps)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [8, 3, 0]
    with kconv.plain_versions():
        plain = pl.sample(model, norm, 8, eps=eps)
    on_cpu = pl.sample(cpu.eval(), norm, 8, eps=eps)
    assert 0.0 < float(plain.consensus.mean()) < 1.0
    for ref in (plain, on_cpu):
        assert np.abs(out.probs - ref.probs).max() <= 1e-4
        assert np.abs(out.pseudo - ref.pseudo).max() <= 1e-4
        near = (np.abs(np.abs(ref.logits) - np.log(9.0)) < 1e-4).any(axis=0)
        assert not ((out.consensus != ref.consensus) & ~near).any()
    assert pl.main(["--image", str(tmp_path / "frame.tif"), "--checkpoint",
                    str(tmp_path / "best.pt"), "--out", str(tmp_path / "p.png")]) == 0
    grid = png.imread(str(tmp_path / "p.png"))
    assert grid.shape == (2 * 100 + pl.GAP, 4 * 136 + 3 * pl.GAP, 3)


def test_engine_iteration_launches(dev, tmp_path):
    """One engine iteration with its validation and panels (logger on,
    panels every step): the MT step (20, 6, 1, 12, 3), the validation step
    (28, 9, 2, 0, 0) and two panel passes (16, 6, 2, 0, 0 each) of
    conv_block_fwd, _dual, mc_consensus, conv_block_bwd, _dual."""
    t = _mt_trainer("cuda", tmp_path, logger=True)
    t.initialize()
    wrappers = (kconv.conv_block_fwd, kconv.conv_block_fwd_dual, mc_consensus,
                kconv.conv_block_bwd, kconv.conv_block_bwd_dual)
    before = [w.launches for w in wrappers]
    t.fit(1)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [80, 27, 7, 12, 3]


def test_tiff_codec_and_punet_prediction_through_files_on_card(dev, tmp_path):
    """The port's TIFF codec round-trips each dtype bit for bit, and
    punet_prediction through files on the card equals tiled_punet_probs of
    the same model, frame and noise (seed 0's first draw), bit for bit."""
    from pda_torch.data import tiff
    from pda_torch.infer import punet_prediction, tiled_punet_probs
    from pda_torch.infer.tiling import grid_shape
    from pda_torch.models import ProbabilisticUnet

    rng = np.random.default_rng(0)
    for name in ("uint8", "uint16", "int32", "float32"):
        dt = np.dtype(name)
        a = rng.integers(0, 2**(8 * dt.itemsize), size=(19, 23), dtype=np.uint64)
        a = a.astype(f"u{dt.itemsize}").view(dt)
        tiff.imwrite(str(tmp_path / f"{name}.tif"), a)
        b = tiff.imread(str(tmp_path / f"{name}.tif"))
        assert b.dtype == dt and b.tobytes() == a.tobytes(), name

    model = ProbabilisticUnet(num_filters=(16, 32, 48, 64), latent_dim=6, no_convs_fcomb=3,
                              beta=1.0, rl_swap=True).to(dev)
    frame = (rng.random((200, 264)) * 255).astype(np.uint8)
    (tmp_path / "in").mkdir()
    tiff.imwrite(str(tmp_path / "in" / "A172_a.tif"), frame)
    punet_prediction(str(tmp_path / "in" / "A172*.tif"), str(tmp_path / "out"), model,
                     prior_samples=16, block_shape=(96, 96), halo=(16, 16), verbose=False)
    img = torch.from_numpy(frame.astype(np.float32)[..., None]).to(dev)
    gy, gx = grid_shape(img.shape[:2], (96, 96))
    eps = torch.randn((16, gy * gx, 6), generator=torch.Generator().manual_seed(0))
    ref = tiled_punet_probs(model, img, eps.to(dev), 16, (96, 96), (16, 16))[..., 0]
    out = tiff.imread(str(tmp_path / "out" / "A172_a.tif"))
    assert out.dtype == np.float32 and out.tobytes() == ref.cpu().numpy().tobytes()


def test_png_punet_prediction_and_h5_volume_on_card(dev, tmp_path):
    """The MitoEM path's files on the card machine (no h5py, imageio or
    cv2 there): punet_prediction of a PNG frame equals tiled_punet_probs of
    the decoded array, bit for bit; a volume written by the port's HDF5
    writer one slice at a time reads back bit for bit and feeds a
    SegmentationDataset whose samples equal those of the same array."""
    from pda_torch.data import SegmentationDataset, h5, png
    from pda_torch.infer import punet_prediction, tiled_punet_probs
    from pda_torch.infer.tiling import grid_shape
    from pda_torch.models import ProbabilisticUnet

    rng = np.random.default_rng(1)
    model = ProbabilisticUnet(num_filters=(16, 32, 48, 64), latent_dim=6, no_convs_fcomb=3,
                              beta=1.0, rl_swap=True).to(dev)
    frame = (rng.random((210, 250)) * 255).astype(np.uint8)
    (tmp_path / "in").mkdir()
    png.imwrite(str(tmp_path / "in" / "mask0000.png"), frame)
    assert png.imread(str(tmp_path / "in" / "mask0000.png")).tobytes() == frame.tobytes()
    punet_prediction(str(tmp_path / "in" / "*"), str(tmp_path / "out"), model,
                     block_shape=(96, 96), halo=(16, 16), verbose=False)
    img = torch.from_numpy(frame.astype(np.float32)[..., None]).to(dev)
    gy, gx = grid_shape(img.shape[:2], (96, 96))
    eps = torch.randn((8, gy * gx, 6), generator=torch.Generator().manual_seed(0))
    ref = tiled_punet_probs(model, img, eps.to(dev), 8, (96, 96), (16, 16))[..., 0]
    from pda_torch.data import tiff

    out = tiff.imread(str(tmp_path / "out" / "mask0000.tif"))
    assert out.dtype == np.float32 and out.tobytes() == ref.cpu().numpy().tobytes()

    vol = (rng.random((5, 70, 90)) * 255).astype(np.uint8)
    labels = (rng.random((5, 70, 90)) < 0.3).astype(np.uint16)
    path = str(tmp_path / "v.h5")
    with h5.Writer(path) as f:
        raw_ds = f.create_dataset("raw", shape=vol.shape, dtype=vol.dtype, chunks=(1, 70, 90))
        lab_ds = f.create_dataset("labels/mito", shape=labels.shape, dtype=labels.dtype,
                                  chunks=(1, 70, 90))
        for i in range(len(vol)):
            raw_ds[i], lab_ds[i] = vol[i], labels[i]
    with h5.File(path) as f:
        assert f["raw"][...].tobytes() == vol.tobytes()
        assert f["labels/mito"][1:4, ::2].tobytes() == labels[1:4, ::2].tobytes()
    for lazy in (False, True):
        ds = SegmentationDataset(path, path, label_key="labels/mito", patch_shape=(48, 48),
                                 n_samples=3, lazy=lazy)
        ref_ds = SegmentationDataset(vol, labels, patch_shape=(48, 48), n_samples=3)
        for i in range(3):
            for a, b in zip(ds[i], ref_ds[i]):
                assert a.tobytes() == b.tobytes()
