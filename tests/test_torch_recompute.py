"""The mixed mode (``pda``'s ``PDA_PALLAS_CONV_MODE=mixed``): the port's
``conv_block_fwd_mixed`` / ``conv_block_fwd_dual_mixed`` (and the pooled
block under the mode) run the forward as ``pda``'s XLA forward, keep only
the input and h3, and recompute h1 and h2 in the backward; on the CPU the
Functions run the plain versions with the same plumbing as the CUDA entry.

Held against ``pda`` on seeded numpy inputs: ``jax.vjp`` of
``conv3_relu_mixed`` (XLA forward, the Pallas backward with recompute)
under ``pltpu.force_tpu_interpret_mode()``, and
``conv_block_packed_bwd_flat(recompute=True, interpret=True)`` as
``tests/test_kernels.py`` runs it (also with the pooled cotangent). float32
within 1e-5 of each output's largest; bf16 as ``test_torch_bf16_kernels.py``
holds the bf16 backward, both sides from the same bf16 input and h3 (dx
within one bf16 ulp and bit-equal on 99% of the elements, dW and db within
1e-4 of their largest). Then what the mode keeps between the forward and the
backward (``saved_tensors_hooks``: no (B, H, W, C) h1 or h2), the variable
read at each call with an unknown value meaning the default, and a PUNet's
gradients under the mode bit-equal to the default path's on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from pda.kernels.conv_block import canvas_wp, flat_m0
from pda.kernels.conv_block_bwd import conv_block_bwd as pda_conv_block_bwd
from pda.kernels.conv_block_packed import packed_wpp
from pda.kernels.conv_block_packed_bwd import conv_block_packed_bwd_flat
from pda.kernels.conv_block_packed_bwd import flat_m0 as flat_m0p
from pda.models.blocks import conv3_relu_mixed
from pda_torch.kernels import conv_block as kc
from pda_torch.models import ProbabilisticUnet
from pda_torch.models.blocks import ConvBlock, UpBlock
from test_torch_bf16_kernels import GRAD_TOL, assert_bf16_close, bf16_input, to_jax, weights
from torch_port_utils import FILTERS, LATENT

F32_TOL = 1e-5
NAMES = ("dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")


def _assert_f32_close(out, ref, names=NAMES):
    for name, a, r in zip(names, out, ref):
        r = np.asarray(r, dtype=np.float64)
        err = float(np.abs(a.detach().double().numpy() - r).max())
        assert err <= F32_TOL * float(np.abs(r).max()), (name, err)


def assert_recomputed_grads_close(out, ref, x, h3, g, wt):
    """bf16 (dw1, db1, .., db3) of a recompute backward against ``pda``'s,
    by the layer rule: each side rebuilds h1 and h2 with its own float32
    sums, so an element may round one bf16 ulp the other way (as two bf16
    forwards may; ``test_torch_bf16_kernels.py`` holds each layer to one
    ulp). dW1 and the biases (of x and the masked cotangents alone) within
    1e-4 of their largest; dW2, dW3 within that plus what one ulp of every
    element of their input h1, h2 can move them: the wgrad of those ulps and
    |da| (the port's da_2, da_3)."""
    w1, b1, w2, b2, w3 = wt[:5]
    h1, h2 = kc._nhwc(kc._plain_layers(x, w1, b1, w2, b2))
    da3 = torch.where(h3 > 0, g, 0.0)
    wk = kc.bf16_operand(w3, torch.float64).flip(0, 1).permute(2, 3, 0, 1)
    r2 = F.conv2d(da3.double().permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    da2 = torch.where(h2 > 0, r2, 0.0).to(torch.bfloat16)
    slack = {2: kc._wgrad_plain(_ulp(h1), da2.double().abs()),
             4: kc._wgrad_plain(_ulp(h2), da3.double().abs())}
    for k, (a, r) in enumerate(zip(out, ref)):
        assert a.dtype == torch.float32
        r = torch.from_numpy(np.asarray(r, dtype=np.float64))
        tol = GRAD_TOL * float(r.abs().max()) + slack.get(k, 0.0)
        assert bool(((a.double() - r).abs() <= tol).all()), k


def _ulp(t):
    """One bf16 ulp of each element of a bf16 tensor, float64."""
    _, e = torch.frexp(t.double().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64), e - 8)


def _grads(fn, inputs, ws, g):
    """Autograd of ``fn(*inputs, *weights)`` against the cotangent ``g``."""
    xs = [x.clone().requires_grad_() for x in inputs]
    wt = [torch.from_numpy(a).requires_grad_() for a in ws]
    return torch.autograd.grad(fn(*xs, *wt), (*xs, *wt), g)


@pytest.mark.parametrize("shape,c", [((2, 16, 16, 1), 8), ((1, 32, 16, 5), 12),
                                     ((2, 16, 16, 8), 16)])
def test_mixed_block_matches_pda_conv3_relu_mixed(shape, c):
    rng = np.random.default_rng(shape[-1] * 10 + c)
    x = rng.normal(size=shape).astype(np.float32)
    ws = weights(rng, shape[-1], c)
    g = rng.normal(size=(*shape[:3], c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(conv3_relu_mixed, jnp.asarray(x), *map(jnp.asarray, ws))
        ref = vjp(jnp.asarray(g))
    out = _grads(kc.conv_block_fwd_mixed, [torch.from_numpy(x)], ws, torch.from_numpy(g))
    _assert_f32_close(out, ref)


@pytest.mark.parametrize("shape,ca,cb,c", [((2, 16, 16), 8, 4, 8), ((1, 32, 16), 12, 8, 12)])
def test_mixed_dual_block_matches_pda_on_the_concat(shape, ca, cb, c):
    """``pda``'s image-path UpBlock concatenates, then ``conv3_relu_mixed``."""
    rng = np.random.default_rng(ca + cb)
    xa = rng.normal(size=(*shape, ca)).astype(np.float32)
    xb = rng.normal(size=(*shape, cb)).astype(np.float32)
    ws = weights(rng, ca + cb, c)
    g = rng.normal(size=(*shape, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(conv3_relu_mixed, jnp.concatenate([xa, xb], axis=-1),
                         *map(jnp.asarray, ws))
        dx, *ref = vjp(jnp.asarray(g))
    out = _grads(kc.conv_block_fwd_dual_mixed, [torch.from_numpy(xa), torch.from_numpy(xb)],
                 ws, torch.from_numpy(g))
    _assert_f32_close(out, (dx[..., :ca], dx[..., ca:], *ref),
                      ("dxa", "dxb") + NAMES[1:])


@pytest.mark.parametrize("shape,c", [((2, 16, 16, 1), 8), ((1, 32, 24, 5), 12),
                                     ((2, 32, 32, 8), 16)])
def test_bf16_recompute_matches_pda_kernel(shape, c):
    """The backward alone, from the same bf16 x and h3 (the port's mixed
    forward): ``pda``'s ``conv_block_bwd`` (recompute) interpreted."""
    rng = np.random.default_rng(shape[-1] * 100 + c + 5)
    x, ws = bf16_input(rng, shape), weights(rng, shape[-1], c)
    wt = [torch.from_numpy(a) for a in ws]
    h3 = kc.autodiff_layers(x, *wt)
    g = bf16_input(rng, (*shape[:3], c))
    with pltpu.force_tpu_interpret_mode():
        ref = pda_conv_block_bwd(to_jax(x), to_jax(h3), to_jax(g), *map(jnp.asarray, ws[:5]),
                                 row_tile=16)
    out = kc.conv_block_bwd(g, x, None, None, h3, *wt[::2], b1=wt[1], b2=wt[3])
    assert_bf16_close(out[0], ref[0])
    assert_recomputed_grads_close(out[1:], ref[1:], x, h3, g, wt)
    # the Function hands the same tensors to the same call
    fused = _grads(kc.conv_block_fwd_mixed, [x], ws, g)
    for a, r in zip(fused, out):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,c,rt,pooled", [((2, 32, 32, 1), 8, 16, False),
                                               ((1, 16, 48, 2), 8, 8, False),
                                               ((2, 32, 32, 4), 8, 8, True)])
def test_recompute_matches_pda_packed_kernel(shape, c, rt, pooled, dtype):
    """``conv_block_packed_bwd_flat(recompute=True)`` without dx, as pda's
    input blocks run it; with ``pooled``, from the pooled cotangent alone
    (a prior/posterior block in the mixed mode)."""
    rng = np.random.default_rng(31 + shape[-1] + rt)
    b, h, w, cin = shape
    if dtype == "float32":
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        ws = weights(rng, cin, c)
        g = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
        gp = torch.from_numpy(rng.normal(size=(b, h // 2, w // 2, c)).astype(np.float32))
    else:
        x, ws = bf16_input(rng, shape), weights(rng, cin, c)
        g, gp = bf16_input(rng, (b, h, w, c)), bf16_input(rng, (b, h // 2, w // 2, c))
    wt = [torch.from_numpy(a) for a in ws]
    h3 = kc.autodiff_layers(x, *wt)
    wpp = packed_wpp(w)
    fl = lambda t: flat_m0p(to_jax(t), wpp)  # noqa: E731
    ref = conv_block_packed_bwd_flat(
        fl(x), fl(h3), None if pooled else fl(g), None, None, h, w,
        *(jnp.asarray(ws[i]) for i in (0, 2, 4)), b1=jnp.asarray(ws[1]), b2=jnp.asarray(ws[3]),
        row_tile=rt, interpret=True, need_dx=False, recompute=True,
        gpf=flat_m0(to_jax(gp), canvas_wp(w // 2)) if pooled else None)
    assert ref[0] is None
    out = kc.conv_block_bwd(None if pooled else g, x, None, None, h3, *wt[::2], need_dx=False,
                            gp=gp if pooled else None, b1=wt[1], b2=wt[3])
    assert out[0] is None
    if dtype == "float32":
        _assert_f32_close(out[1:], ref[1:], NAMES[1:])
    else:
        assert_recomputed_grads_close(out[1:], ref[1:], x, h3, g if not pooled else
                                      kc.masked_cotangent_plain(None, gp, h3), wt)


@pytest.mark.parametrize("keep_full", [False, True])
def test_pooled_mixed_block_matches_pda_pooled_recompute(keep_full):
    """The pooled block in the mixed mode, through its Function, against
    ``pda``'s packed kernel with recompute and the pooled cotangent."""
    rng = np.random.default_rng(71 + keep_full)
    b, h, w, cin, c = 2, 32, 32, 4, 8
    x = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(np.float32))
    ws = weights(rng, cin, c)
    g = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    gp = torch.from_numpy(rng.normal(size=(b, h // 2, w // 2, c)).astype(np.float32))
    xr = x.clone().requires_grad_()
    wt = [torch.from_numpy(a).requires_grad_() for a in ws]
    out = kc.conv_block_fwd_pool(xr, *wt, keep_full=keep_full, mixed=True)
    outs, cots = (out, (g, gp)) if keep_full else ((out,), (gp,))
    grads = torch.autograd.grad(outs, (xr, *wt), cots)
    h3 = kc.autodiff_layers(x, *map(torch.from_numpy, ws))
    wpp = packed_wpp(w)
    fl = lambda t: flat_m0p(to_jax(t), wpp)  # noqa: E731
    ref = conv_block_packed_bwd_flat(
        fl(x), fl(h3), fl(g) if keep_full else None, None, None, h, w,
        *(jnp.asarray(ws[i]) for i in (0, 2, 4)), b1=jnp.asarray(ws[1]), b2=jnp.asarray(ws[3]),
        row_tile=8, interpret=True, recompute=True,
        gpf=flat_m0(to_jax(gp), canvas_wp(w // 2)))
    from pda.kernels.conv_block_packed import uncanvas_packed
    _assert_f32_close(grads, (uncanvas_packed(ref[0], h, w), *ref[1:]))


def _saved_shapes(run):
    """The shapes of the tensors autograd saves while ``run()`` builds its graph."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run()
    return shapes, out


@pytest.mark.parametrize("kind", ["single", "dual", "pooled"])
def test_mixed_block_saves_no_h1_h2(kind, monkeypatch):
    """Under the mode a block keeps its input and h3, no (B, H, W, C) h1 or
    h2; under the default it keeps all three."""
    b, h, w, cin, c = 2, 8, 8, 3, 8
    torch.manual_seed(0)
    x = torch.randn(b, h, w, cin, requires_grad=True)
    if kind == "dual":
        block = UpBlock(5, cin, c)
        low = torch.randn(b, h // 2, w // 2, 5, requires_grad=True)
        run = lambda: block(low, x)  # noqa: E731
    else:
        block = ConvBlock(cin, c)
        run = lambda: block(x, pool_out="only" if kind == "pooled" else None)  # noqa: E731
    for mode, full_maps in (("mixed", 1), ("full", 3), (None, 3)):
        if mode is None:
            monkeypatch.delenv("PDA_PALLAS_CONV_MODE", raising=False)
        else:
            monkeypatch.setenv("PDA_PALLAS_CONV_MODE", mode)
        shapes, out = _saved_shapes(run)
        assert shapes.count((b, h, w, c)) == full_maps, (mode, shapes)
        out.sum().backward()


def test_mode_is_read_at_call_time_and_unknown_means_default(monkeypatch):
    """One block object, the variable changed between calls: "mixed" runs
    the mixed Function (no launch of the forward kernel's Function, the
    mixed one instead), any other value the default, as ``pda`` reads it."""
    import pda_torch.models.blocks as tb

    seen = []
    for name in ("conv_block_fwd", "conv_block_fwd_mixed"):
        fn = getattr(tb, name)
        monkeypatch.setattr(tb, name, lambda *a, _f=fn, _n=name: seen.append(_n) or _f(*a))
    block = ConvBlock(2, 4)
    x = torch.randn(1, 8, 8, 2)
    for mode in ("mixed", "full", "Mixed", "mixed", ""):
        monkeypatch.setenv("PDA_PALLAS_CONV_MODE", mode)
        block(x)
    assert seen == ["conv_block_fwd_mixed", "conv_block_fwd", "conv_block_fwd",
                    "conv_block_fwd_mixed", "conv_block_fwd"]


def test_punet_gradients_under_the_mode_equal_the_default(monkeypatch):
    """A PUNet pass (backbone, prior, posterior; single, dual and pooled
    blocks) on the CPU: the mixed mode's forward is the plain layers and its
    recompute the plain forward's, so its gradients are the default path's
    bit for bit in float32."""
    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3)
    x, segm = torch.randn(2, 16, 16, 1), torch.rand(2, 16, 16, 1)

    def grads():
        model.zero_grad()
        enc = model(x, segm)
        loss = (enc.features.float().square().mean() + enc.prior.mu.sum()
                + enc.posterior.log_sigma.sum())
        loss.backward()
        return [p.grad.clone() for net in (model.unet, model.prior, model.posterior)
                for p in net.parameters()]

    ref = grads()
    monkeypatch.setenv("PDA_PALLAS_CONV_MODE", "mixed")
    for a, r in zip(grads(), ref):
        assert torch.equal(a, r)


def test_recompute_refusals():
    """The CUDA entry's argument checks run before any launch, so here too."""
    x, h3 = torch.zeros(1, 4, 6, 2), torch.zeros(1, 4, 6, 3)
    ws = [torch.zeros(3, 3, ci, 3) for ci in (2, 3, 3)]
    with pytest.raises(ValueError, match="biases"):
        kc._launch_bwd(h3, x, None, None, None, h3, *ws, True)
    with pytest.raises(ValueError, match="cotangent"):
        kc._launch_bwd(None, x, None, h3, h3, h3, *ws, True)
    with pytest.raises(ValueError, match="even"):
        kc._launch_bwd(None, torch.zeros(1, 5, 6, 2), None, *[torch.zeros(1, 5, 6, 3)] * 3,
                       *ws, True, gp=torch.zeros(1, 2, 3, 3))
    with pytest.raises(ValueError, match="gp"):
        kc._launch_bwd(None, x, None, h3, h3, h3, *ws, True, gp=torch.zeros(1, 2, 2, 3))
