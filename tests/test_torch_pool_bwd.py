"""The pooled cotangent (``pda``'s ``gpf``): the port's block + 2x2 average
pool (``conv_block_fwd_pool``, "only" and "with") and its fused backward,
on the CPU, where the Function runs the plain forward and the plain
backward with the same plumbing as the CUDA kernel.

Against ``pda``'s ``conv_block_packed_bwd_flat(..., gpf=...)`` run in
interpret mode, as ``tests/test_kernels.py`` builds it ("pooled" and "both"
modes, seeded numpy inputs): float32 within 1e-5 of each output's largest;
bf16 as ``test_torch_bf16_kernels.py`` holds the bf16 backward (dx within
one bf16 ulp and bit-equal on 99% of the elements, dW and db within 1e-4
of their largest). Against autograd of the port's own unfused composition
(block, then ``avg_pool_2x2``, then the add of the two cotangents): bit for
bit in float32. And the models: every pooled 3-conv block of a PUNet pass
runs one backward call that reads the pooled cotangent, and the
``state_dict()`` names stay ``pda.models.convert``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.kernels.conv_block import canvas_wp, flat_m0
from pda.kernels.conv_block_packed import packed_wpp, uncanvas_packed
from pda.kernels.conv_block_packed_bwd import conv_block_packed_bwd_flat
from pda.kernels.conv_block_packed_bwd import flat_m0 as flat_m0p
from pda.models.blocks import _conv_same, packed_pool_out_eligible
from pda_torch.kernels import conv_block as kc
from pda_torch.models import ProbabilisticUnet, state_dict_from_pda
from test_torch_bf16_kernels import (assert_bf16_close, assert_grad_close, bf16_input, saved,
                                     to_jax, weights)
from torch_port_utils import FILTERS, LATENT, pda_punet

F32_TOL = 1e-5
NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")


def _inputs(rng, shape, c, dtype=torch.float32):
    """x (B, H, W, Cin), [w1, b1, .., b3] (numpy float32), g (B, H, W, C) and
    gp (B, H/2, W/2, C), seeded; x, g, gp in ``dtype``."""
    b, h, w, cin = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    ws = weights(rng, cin, c)
    g = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dtype)
    gp = torch.from_numpy(rng.normal(size=(b, h // 2, w // 2, c)).astype(np.float32)).to(dtype)
    return x, ws, g, gp


def _port_grads(x, ws, g, gp, mode):
    """(dx, dw1, db1, .., db3) of the port's fused block + pool."""
    x = x.clone().requires_grad_()
    wt = [torch.from_numpy(a).requires_grad_() for a in ws]
    out = kc.conv_block_fwd_pool(x, *wt, keep_full=mode == "both")
    outs, cots = ((out,), (gp,)) if mode == "pooled" else (out, (g, gp))
    return torch.autograd.grad(outs, (x, *wt), cots)


def _pda_grads(x, h1, h2, h3, ws, g, gp, mode, rt):
    """pda's packed backward with the pooled cotangent, interpreted."""
    b, h, w, cin = x.shape
    wpp = packed_wpp(w)
    assert packed_pool_out_eligible(h, w, cin, ws[0].shape[-1]) and canvas_wp(w // 2) == wpp
    fl = lambda t: flat_m0p(to_jax(t), wpp)  # noqa: E731
    out = conv_block_packed_bwd_flat(
        fl(x), fl(h3), fl(g) if mode == "both" else None, fl(h1), fl(h2), h, w,
        *(jnp.asarray(ws[i]) for i in (0, 2, 4)), row_tile=rt, interpret=True,
        gpf=flat_m0(to_jax(gp), canvas_wp(w // 2)))
    return (uncanvas_packed(out[0], h, w), *out[1:])


@pytest.mark.parametrize("shape,c,rt,mode", [
    ((2, 32, 32, 4), 8, 8, "pooled"),
    ((1, 64, 32, 2), 8, 16, "pooled"),
    ((2, 32, 32, 4), 8, 8, "both"),
    ((1, 64, 64, 1), 8, 8, "both"),
])
def test_pool_backward_matches_pda_packed_kernel(shape, c, rt, mode):
    rng = np.random.default_rng(37 + shape[1] + shape[-1])
    x, ws, g, gp = _inputs(rng, shape, c)
    out = _port_grads(x, ws, g, gp, mode)
    xj = jnp.asarray(x.numpy())
    h1 = jnp.maximum(_conv_same(xj, ws[0]) + ws[1], 0.0)
    h2 = jnp.maximum(_conv_same(h1, ws[2]) + ws[3], 0.0)
    h3 = jnp.maximum(_conv_same(h2, ws[4]) + ws[5], 0.0)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    ref = _pda_grads(x, t(h1), t(h2), t(h3), ws, g, gp, mode, rt)
    for name, a, r in zip(NAMES, out, ref):
        r = np.asarray(r, dtype=np.float64)
        err = float(np.abs(a.double().numpy() - r).max())
        assert err <= F32_TOL * float(np.abs(r).max()), (name, err)


@pytest.mark.parametrize("shape,c,rt,mode", [
    ((2, 32, 32, 4), 8, 8, "pooled"),
    ((2, 32, 32, 4), 8, 8, "both"),
    ((1, 32, 32, 1), 8, 16, "both"),
])
def test_bf16_pool_backward_matches_pda_packed_kernel(shape, c, rt, mode):
    """Both sides from the same bf16 saved tensors (the port's plain bf16
    forward) and cotangents."""
    rng = np.random.default_rng(53 + shape[-1])
    x = bf16_input(rng, shape)
    ws = weights(rng, shape[-1], c)
    b, h, w, _ = shape
    g, gp = bf16_input(rng, (b, h, w, c)), bf16_input(rng, (b, h // 2, w // 2, c))
    h1, h2, h3 = saved(x, ws)
    ref = _pda_grads(x, h1, h2, h3, ws, g, gp, mode, rt)
    out = kc.conv_block_bwd(g if mode == "both" else None, x, h1, h2, h3,
                            *(torch.from_numpy(ws[i]) for i in (0, 2, 4)), gp=gp)
    assert_bf16_close(out[0], ref[0])
    for a, r in zip(out[1:], ref[1:]):
        assert_grad_close(a, r)
    # the Function hands the same cotangents to the same call
    fused = _port_grads(x, ws, g, gp, mode)
    assert fused[0].dtype == torch.bfloat16
    for a, r in zip(fused, out):
        assert torch.equal(a, r)


@pytest.mark.parametrize("mode", ["pooled", "both"])
@pytest.mark.parametrize("shape,c", [((2, 12, 16, 3), 8), ((1, 8, 10, 1), 5)])
def test_fused_pool_is_bit_equal_to_the_unfused_composition(shape, c, mode):
    rng = np.random.default_rng(61 + c)
    x, ws, g, gp = _inputs(rng, shape, c)
    fused = _port_grads(x, ws, g, gp, mode)
    xr = x.clone().requires_grad_()
    wt = [torch.from_numpy(a).requires_grad_() for a in ws]
    h3 = kc.conv_block_fwd(xr, *wt)
    pooled = kc.avg_pool_2x2(h3)
    outs, cots = ((pooled,), (gp,)) if mode == "pooled" else ((h3, pooled), (g, gp))
    ref = torch.autograd.grad(outs, (xr, *wt), cots)
    for name, a, r in zip(NAMES, fused, ref):
        assert torch.equal(a, r), name
    # and the forward outputs are the unfused ones
    out = kc.conv_block_fwd_pool(x, *map(torch.from_numpy, ws), keep_full=True)
    assert torch.equal(out[0], h3) and torch.equal(out[1], pooled)


def test_unused_output_takes_no_cotangent():
    """A "with" block whose pooled map (or output) feeds nothing passes None
    for it, not zeros: the backward sees the other cotangent alone."""
    rng = np.random.default_rng(7)
    x, ws, g, gp = _inputs(rng, (1, 8, 8, 2), 4)
    wt = [torch.from_numpy(a).requires_grad_() for a in ws]
    seen = []
    plain = kc.conv_block_bwd_plain

    def spy(g, *args, **kwargs):
        seen.append((g is None, kwargs.get("gp") is None))
        return plain(g, *args, **kwargs)

    kc.conv_block_bwd_plain = spy
    try:
        h3, pooled = kc.conv_block_fwd_pool(x, *wt, keep_full=True)
        (h3 * g).sum().backward()
        h3, pooled = kc.conv_block_fwd_pool(x, *wt, keep_full=True)
        (pooled * gp).sum().backward()
    finally:
        kc.conv_block_bwd_plain = plain
    assert seen == [(False, True), (True, False)]


def test_punet_pooled_blocks_take_one_backward_call_each(monkeypatch):
    """A student pass (backbone, prior, posterior) of a 4-level PUNet: 12
    single-input block backwards and 3 decoder ones, of which the 9 blocks
    whose output feeds a pool (levels 0-2 of each pyramid) read the pooled
    cotangent, the backbone's 3 with the skip's cotangent beside it."""
    calls, plain = [], kc.conv_block_bwd_plain

    def spy(g, *args, **kwargs):
        calls.append((g is not None, kwargs.get("gp") is not None))
        return plain(g, *args, **kwargs)

    monkeypatch.setattr(kc, "conv_block_bwd_plain", spy)
    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT)
    x, segm = torch.randn(2, 16, 16, 1), torch.rand(2, 16, 16, 1)
    enc = model(x, segm)
    loss = enc.features.square().mean() + enc.prior.mu.sum() + enc.posterior.log_sigma.sum()
    loss.backward()
    assert sorted(calls) == sorted([(True, True)] * 3 + [(False, True)] * 6 + [(True, False)] * 6)
    for net in (model.unet, model.prior, model.posterior):
        assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in net.parameters())


def test_state_dict_names_are_unchanged():
    """The modules keep their ``layers`` indices: the port's names are
    exactly those ``state_dict_from_pda`` gives a pda tree, and a strict
    load of them works."""
    _, params = pda_punet()
    names = state_dict_from_pda(params)
    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3)
    assert set(model.state_dict()) == set(names)
    model.load_state_dict(names)
    assert "unet.contracting_path.1.layers.1.weight" in names  # after the pool at 0
    assert "prior.encoder.layers.7.weight" in names  # conv 0 of level 1 (pool at 6)
