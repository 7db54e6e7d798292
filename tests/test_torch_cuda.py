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
from pda_torch.kernels.mc_consensus import mc_consensus, mc_consensus_plain, mc_logits_plain

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
])
def test_conv_block_kernel_matches_plain(dev, b, h, w, cin, c):
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(b, h, w, cin, generator=gen).to(dev)
    ws = _weights(gen, cin, c, dev)
    before = conv_block_fwd.launches
    with torch.no_grad():
        out = conv_block_fwd(x, *ws)
    torch.cuda.synchronize()
    assert conv_block_fwd.launches == before + 1
    _assert_rel(out, conv_block_fwd_plain(x, *ws))


@pytest.mark.parametrize("b,h,w,ca,cb,c", [(2, 10, 12, 13, 7, 24), (1, 16, 16, 64, 32, 64)])
def test_dual_conv_block_kernel_matches_plain(dev, b, h, w, ca, cb, c):
    gen = torch.Generator().manual_seed(ca)
    xa = torch.randn(b, h, w, ca, generator=gen).to(dev)
    xb = torch.randn(b, h, w, cb, generator=gen).to(dev)
    ws = _weights(gen, ca + cb, c, dev)
    with torch.no_grad():
        out = conv_block_fwd_dual(xa, xb, *ws)
    torch.cuda.synchronize()
    _assert_rel(out, conv_block_fwd_dual_plain(xa, xb, *ws))


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
                                           (1, 16, 16, 64, 32, 64)])
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
