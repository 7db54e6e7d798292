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

        def replayed(model, x, n_samples, masking, eps=None, generator=None):
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
