"""The four bf16 kernel bodies' plain versions (what the wrappers run on a
CPU tensor) against ``pda``'s Pallas kernels in bf16, run in interpret mode
on the CPU: the fused ConvBlock forward (``conv_block_fused``, the entry
layers of 1 and 2 channels among them) and its dual-input form
(``conv_block_fused_flat_dual``), the backward with and without dx
(``conv_block_bwd_flat``) and its dual form (``conv_block_bwd_flat_dual``),
the backward also layer by layer at the card bodies' edge shapes (identity
kernels in the other layers, so each side's backward is one layer's), and the
MC tail (``mc_consensus_decode`` under
``pltpu.force_tpu_interpret_mode()``), on the same seeded numpy inputs.

``pda``'s kernels take bf16 activations and float32 weights (cast to bf16
inside), sum in float32, add the float32 bias and round each layer's output
to bf16 once; the port's plain versions do the same with float64 sums.
Tolerances: a bf16 output within one bf16 ulp of ``pda``'s element by
element (or, where the value is so small that its ulp is finer than a
float32 sum's error, within 1e-5 of the output's largest) and bit-equal on
at least 99% of the elements; dW and db (float32) within 1e-4 of their
largest; the MC mean within one bf16 ulp at 0.5-1 (2^-8) and the consensus
equal except where one of the port's logits lies within one bf16 ulp of a
threshold (2^-6 at |logit| = log 9)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pda.kernels.conv_block import (canvas_wp, conv_block_fused, conv_block_fused_flat,
                                    conv_block_fused_flat_dual,
                                    flat_m0, uncanvas)
from pda.kernels.conv_block_bwd import conv_block_bwd_flat, conv_block_bwd_flat_dual
from pda.kernels.mc_consensus import mc_consensus_decode
from pda_torch.kernels import conv_block as kc
from pda_torch.kernels import mc_consensus as km

BF16_ABS_TOL, BIT_EQUAL, GRAD_TOL = 1e-5, 0.99, 1e-4
MEAN_TOL, WINDOW = 2.0 ** -8, 2.0 ** -6


def to_torch(a) -> torch.Tensor:
    """A numpy or jax array (float32 or bf16) as a CPU tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.contiguous().view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def bf16_input(rng, shape) -> torch.Tensor:
    """Seeded normals rounded to bf16."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def weights(rng, cin, c):
    """[w1, b1, w2, b2, w3, b3], float32, HWIO kernels, He-scaled."""
    out = []
    for ci in (cin, c, c):
        out.append((rng.normal(size=(3, 3, ci, c)) * np.sqrt(2.0 / (9 * ci))).astype(np.float32))
        out.append((rng.normal(size=(c,)) * 0.1).astype(np.float32))
    return out


def assert_bf16_close(out: torch.Tensor, ref) -> None:
    """bf16 ``out`` against bf16 ``ref``: within one bf16 ulp (or BF16_ABS_TOL
    of the largest) everywhere, bit-equal on BIT_EQUAL of the elements."""
    assert out.dtype == torch.bfloat16
    ref = to_torch(ref)
    assert out.shape == ref.shape
    a, r = out.double(), ref.double()
    diff = (a - r).abs()
    big = torch.maximum(a.abs(), r.abs()).clamp(min=2.0 ** -126)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    beyond = (diff > ulp) & (diff > BF16_ABS_TOL * float(r.abs().max()))
    equal = float((out.view(torch.int16) == ref.view(torch.int16)).double().mean())
    assert not beyond.any(), f"{int(beyond.sum())} elements beyond one ulp"
    assert equal >= BIT_EQUAL, f"bit-equal on {equal:.4%}"


def assert_grad_close(out: torch.Tensor, ref) -> None:
    assert out.dtype == torch.float32
    ref = np.asarray(ref, dtype=np.float64)
    err = float(np.abs(out.double().numpy() - ref).max())
    assert err <= GRAD_TOL * float(np.abs(ref).max()), err


def saved(x: torch.Tensor, ws):
    """h1, h2, h3 of the port's plain bf16 forward (both sides' saved tensors)."""
    return kc._nhwc(kc._plain_layers(x, *map(torch.from_numpy, ws)))


@pytest.mark.parametrize("b,h,w,cin,c", [
    (2, 16, 16, 1, 8),  # the image entry layer
    (2, 16, 16, 2, 8),  # the posterior's entry (image + mask)
    (1, 32, 24, 5, 12),
    (2, 32, 32, 8, 16),
])
def test_forward_matches_pda_kernel(b, h, w, cin, c):
    rng = np.random.default_rng(cin * 100 + c)
    x, ws = bf16_input(rng, (b, h, w, cin)), weights(rng, cin, c)
    ref = conv_block_fused(to_jax(x), *map(jnp.asarray, ws), interpret=True)
    out = kc.conv_block_fwd(x, *map(torch.from_numpy, ws))
    assert_bf16_close(out, ref)


@pytest.mark.parametrize("b,h,w,ca,cb,c", [(2, 16, 16, 8, 4, 8), (1, 32, 16, 12, 8, 12)])
def test_dual_forward_matches_pda_kernel(b, h, w, ca, cb, c):
    rng = np.random.default_rng(ca * 10 + cb)
    xa, xb = bf16_input(rng, (b, h, w, ca)), bf16_input(rng, (b, h, w, cb))
    ws = weights(rng, ca + cb, c)
    wp = canvas_wp(w)
    ref = conv_block_fused_flat_dual(flat_m0(to_jax(xa), wp), flat_m0(to_jax(xb), wp), h, w,
                                     *map(jnp.asarray, ws), interpret=True)
    out = kc.conv_block_fwd_dual(xa, xb, *map(torch.from_numpy, ws))
    assert_bf16_close(out, uncanvas(ref, h, w))


# The edges of the card's wgmma layer body (csrc/conv3x3_wgmma.cuh: 64-channel
# chunks, 8 x 16 or 16 x 16 pixel tiles, 64 or 128 output channels a block),
# which tests/test_torch_cuda.py holds against these plain versions: channel
# counts off the chunk (8, 16, 48, 72, 136), dual splits off it (40 + 24,
# 200 + 72), odd widths, batch 1, and a Cin-3 block (the mma.sync body's).
# pda's kernels take H a multiple of their 8- or 16-row band, so H is 8 or 16
# here; odd heights are checked on the card against the plain version.
RAGGED_FWD = [(1, 16, 45, 8, 0, 8), (1, 16, 45, 16, 0, 16), (1, 16, 45, 48, 0, 72),
              (2, 16, 33, 72, 0, 136), (1, 8, 21, 3, 0, 48), (1, 16, 45, 40, 24, 64),
              (1, 16, 21, 200, 72, 128)]


@pytest.mark.parametrize("b,h,w,ca,cb,c", RAGGED_FWD)
def test_forward_layers_match_pda_kernel_at_ragged_shapes(b, h, w, ca, cb, c):
    """Layer by layer: each of the port's plain bf16 layers, from pda's own
    input to it, against pda's h1, h2 and output (``save_intermediates``):
    a rounding that falls the other way in one layer moves the layers after
    it, so the block's output alone is held only at a few channels."""
    rng = np.random.default_rng(ca * 1000 + cb * 10 + c)
    xa = bf16_input(rng, (b, h, w, ca))
    xb = bf16_input(rng, (b, h, w, cb)) if cb else None
    ws = weights(rng, ca + cb, c)
    wp = canvas_wp(w)
    jw = list(map(jnp.asarray, ws))
    if cb:
        out, h1, h2 = conv_block_fused_flat_dual(flat_m0(to_jax(xa), wp), flat_m0(to_jax(xb), wp),
                                                 h, w, *jw, interpret=True,
                                                 save_intermediates=True)
    else:
        out, h1, h2 = conv_block_fused_flat(flat_m0(to_jax(xa), wp), h, w, *jw, interpret=True,
                                            save_intermediates=True)
    hs = [uncanvas(t, h, w) for t in (h1, h2, out)]
    h_in = xa if xb is None else torch.cat([xa, xb], dim=-1)
    for k, ref in enumerate(hs):
        layer = kc.conv_relu_layer(h_in.permute(0, 3, 1, 2), torch.from_numpy(ws[2 * k]),
                                   torch.from_numpy(ws[2 * k + 1])).permute(0, 2, 3, 1)
        assert_bf16_close(layer.contiguous(), ref)
        h_in = to_torch(ref)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("b,h,w,cin,c", [(2, 16, 16, 1, 8), (1, 32, 24, 5, 12),
                                         (2, 32, 32, 8, 16)])
def test_backward_matches_pda_kernel(b, h, w, cin, c, need_dx):
    rng = np.random.default_rng(cin * 100 + c + 7)
    x, ws = bf16_input(rng, (b, h, w, cin)), weights(rng, cin, c)
    h1, h2, h3 = saved(x, ws)
    g = bf16_input(rng, (b, h, w, c))
    wp = canvas_wp(w)
    fl = lambda t: flat_m0(to_jax(t), wp)  # noqa: E731
    ref = conv_block_bwd_flat(fl(x), fl(h3), fl(g), fl(h1), fl(h2), h, w,
                              *map(jnp.asarray, ws[:5]), interpret=True)
    out = kc.conv_block_bwd(g, x, h1, h2, h3, *(torch.from_numpy(ws[i]) for i in (0, 2, 4)),
                            need_dx=need_dx)
    if need_dx:
        assert_bf16_close(out[0], uncanvas(ref[0], h, w))
    else:
        assert out[0] is None
    for a, r in zip(out[1:], ref[1:]):
        assert_grad_close(a, r)


@pytest.mark.parametrize("b,h,w,ca,cb,c", [(2, 16, 16, 8, 4, 8), (1, 32, 16, 12, 8, 12)])
def test_dual_backward_matches_pda_kernel(b, h, w, ca, cb, c):
    rng = np.random.default_rng(ca * 10 + cb + 7)
    xa, xb = bf16_input(rng, (b, h, w, ca)), bf16_input(rng, (b, h, w, cb))
    ws = weights(rng, ca + cb, c)
    h1, h2, h3 = saved(torch.cat([xa, xb], dim=-1), ws)
    g = bf16_input(rng, (b, h, w, c))
    wp = canvas_wp(w)
    fl = lambda t: flat_m0(to_jax(t), wp)  # noqa: E731
    ref = conv_block_bwd_flat_dual(fl(xa), fl(xb), fl(h3), fl(g), fl(h1), fl(h2), h, w,
                                   *map(jnp.asarray, ws[:5]), interpret=True)
    out = kc.conv_block_bwd_dual(g, xa, xb, h1, h2, h3,
                                 *(torch.from_numpy(ws[i]) for i in (0, 2, 4)))
    assert_bf16_close(out[0], uncanvas(ref[0], h, w))
    assert_bf16_close(out[1], uncanvas(ref[1], h, w))
    for a, r in zip(out[2:], ref[2:]):
        assert_grad_close(a, r)


# The edges of the card's bf16 backward bodies (csrc/conv3x3_wgmma.cuh's
# dgrad, csrc/wgrad_wgmma.cuh: 64-channel slices, 8 x 8-pixel tiles, 64 or
# 128 output channels a block), which tests/test_torch_cuda.py holds against
# these plain versions: channel counts off the slice (8, 16, 48, 72, 136),
# dual splits 40 + 24 and 200 + 72, odd widths, batch 1, and the entry
# blocks (Cin 1 and 2, whose wgrad stays on the mma.sync body). H is 8 or 16
# (pda's row band), as in RAGGED_FWD.
RAGGED_BWD = [(1, 16, 45, 8, 0, 8), (1, 16, 45, 16, 0, 16), (1, 16, 21, 48, 0, 72),
              (1, 8, 33, 136, 0, 136), (1, 16, 45, 40, 24, 64), (1, 8, 21, 200, 72, 128),
              (2, 16, 33, 1, 0, 16), (1, 16, 45, 2, 0, 64)]


def identity_kernel(c: int) -> np.ndarray:
    """A (3, 3, c, c) HWIO kernel whose dgrad copies its input: the centre
    tap the identity, the others 0 (a bf16 value times 1, summed alone, is
    exact in both sums and rounds to itself)."""
    w = np.zeros((3, 3, c, c), np.float32)
    w[1, 1] = np.eye(c, dtype=np.float32)
    return w


def positive(rng, shape) -> torch.Tensor:
    """bf16 saved activations above 0 everywhere (a ReLU mask of all ones)."""
    return (bf16_input(rng, shape).float().abs() + 0.25).to(torch.bfloat16)


def bwd_both(g, xs, h1, h2, h3, ws, h, w):
    """pda's interpreted bf16 backward kernel (flat, single or dual) and the
    port's plain backward on the same saved tensors: (pda's outputs with dx
    uncanvassed, the port's), each (dx parts..., dw1, db1, dw2, db2, dw3, db3)."""
    wp = canvas_wp(w)
    fl = lambda t: flat_m0(to_jax(t), wp)  # noqa: E731
    kern = [torch.from_numpy(ws[i]) for i in (0, 2, 4)]
    jw = list(map(jnp.asarray, ws[:5]))
    if len(xs) == 1:
        ref = conv_block_bwd_flat(fl(xs[0]), fl(h3), fl(g), fl(h1), fl(h2), h, w, *jw,
                                  interpret=True)
        ref = (uncanvas(ref[0], h, w), *ref[1:])
        out = kc.conv_block_bwd(g, xs[0], h1, h2, h3, *kern, need_dx=True)
    else:
        ref = conv_block_bwd_flat_dual(fl(xs[0]), fl(xs[1]), fl(h3), fl(g), fl(h1), fl(h2), h,
                                       w, *jw, interpret=True)
        ref = (uncanvas(ref[0], h, w), uncanvas(ref[1], h, w), *ref[2:])
        out = kc.conv_block_bwd_dual(g, *xs, h1, h2, h3, *kern)
    return ref, out


@pytest.mark.parametrize("b,h,w,ca,cb,c", RAGGED_BWD)
def test_backward_layers_match_pda_kernel_at_ragged_shapes(b, h, w, ca, cb, c):
    """The backward layer by layer, each layer's rounding alone: with layers
    2 and 3 identity kernels and every saved activation above 0, the whole
    backward of both sides is layer 1's: dx the dgrad of g through w1
    (unmasked, split at Ca for the dual block), rounded to bf16 once, and
    dW1, dW2, dW3 (and the three db) the wgrads of x, h1, h2 against g. The
    port's plain backward against pda's interpreted kernel on the same saved
    tensors; the masked dgrad alone is the next test's."""
    rng = np.random.default_rng(ca * 1000 + cb * 10 + c + 3)
    xs = [bf16_input(rng, (b, h, w, ca))] + ([bf16_input(rng, (b, h, w, cb))] if cb else [])
    w1, b1 = weights(rng, ca + cb, c)[:2]
    ws = [w1, b1, identity_kernel(c), np.zeros(c, np.float32), identity_kernel(c),
          np.zeros(c, np.float32)]
    h1, h2, h3 = (positive(rng, (b, h, w, c)) for _ in range(3))
    g = bf16_input(rng, (b, h, w, c))
    ref, out = bwd_both(g, xs, h1, h2, h3, ws, h, w)
    n_dx = len(xs)
    for a, r in zip(out[:n_dx], ref[:n_dx]):
        assert_bf16_close(a, r)
    for a, r in zip(out[n_dx:], ref[n_dx:]):
        assert_grad_close(a, r)


@pytest.mark.parametrize("b,h,w,c", [(1, 16, 45, 8), (1, 16, 45, 16), (1, 16, 21, 72),
                                     (1, 8, 33, 136)])
def test_backward_masked_layer_matches_pda_kernel(b, h, w, c):
    """A masked dgrad alone: with layers 1 and 2 identity kernels and h1
    above 0, the backward's dx is layer 3's dgrad of [h3 > 0] g, rounded to
    bf16 once and masked by [h2 > 0] (h2, h3 of either sign); dW3, db3 its
    wgrad. The port's plain backward against pda's interpreted kernel."""
    rng = np.random.default_rng(c + 11)
    x = bf16_input(rng, (b, h, w, c))
    w3, b3 = weights(rng, c, c)[:2]
    ws = [identity_kernel(c), np.zeros(c, np.float32), identity_kernel(c),
          np.zeros(c, np.float32), w3, b3]
    h1 = positive(rng, (b, h, w, c))
    h2, h3, g = (bf16_input(rng, (b, h, w, c)) for _ in range(3))
    ref, out = bwd_both(g, [x], h1, h2, h3, ws, h, w)
    assert_bf16_close(out[0], ref[0])
    assert (out[0][h2 <= 0] == 0).all()
    for a, r in zip(out[1:], ref[1:]):
        assert_grad_close(a, r)


def test_autograd_carries_bf16_and_float32_gradients():
    """Through the autograd Function: the bf16 block's input gradient is
    bf16, its weight and bias gradients float32 (the parameters' dtype)."""
    rng = np.random.default_rng(3)
    x = bf16_input(rng, (1, 16, 16, 4)).requires_grad_()
    ws = [torch.from_numpy(a).requires_grad_() for a in weights(rng, 4, 8)]
    out = kc.conv_block_fwd(x, *ws)
    out.float().sum().backward()
    assert out.dtype == x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 for p in ws)


@pytest.mark.parametrize("masking", [False, True])
@pytest.mark.parametrize("c,n_mid", [(16, 1), (20, 2)])
def test_mc_tail_matches_pda_kernel(c, n_mid, masking):
    rng = np.random.default_rng(c + n_mid)
    b, h, w, s = 2, 16, 16, 8
    feat = bf16_input(rng, (b, h, w, c)) * 2
    z = (rng.normal(size=(s, b, c))).astype(np.float32)
    mid_w = (rng.normal(size=(n_mid, c, c)) / np.sqrt(c)).astype(np.float32)
    mid_b = (rng.normal(size=(n_mid, c)) * 0.1).astype(np.float32)
    last_w = (rng.normal(size=(c, 1)) * 3 / np.sqrt(c)).astype(np.float32)
    last_b = rng.normal(size=(1,)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_mean, ref_cons = mc_consensus_decode(
            to_jax(feat), *map(jnp.asarray, (z, mid_w, mid_b, last_w, last_b)), n_samples=s,
            masking=masking, row_tile=256)
    args = (feat, *map(torch.from_numpy, (z, mid_w, mid_b, last_w, last_b)))
    mean, cons = km.mc_consensus(*args, masking=masking)
    assert mean.dtype == cons.dtype == torch.float32
    assert float((mean - to_torch(ref_mean)).abs().max()) <= MEAN_TOL
    logits = km.mc_logits_plain(*args)
    near = ((logits.abs() - math.log(9.0)).abs() < WINDOW).any(dim=0)
    assert not ((cons != to_torch(ref_cons)) & ~near).any()


def test_bf16_widths_and_refusals():
    """The bf16 MC tail pads to its k-step of 16; the bf16 wrappers refuse
    float16 and float64 (their checks run before any launch)."""
    assert [km.padded_width(c, torch.bfloat16) for c in (8, 16, 20, 64)] == [16, 16, 32, 64]
    assert [km.padded_width(c) for c in (8, 20)] == [8, 24]
    x = torch.zeros(1, 4, 4, 3)
    ws = [torch.zeros(3, 3, 3, 4), torch.zeros(4)] + [torch.zeros(3, 3, 4, 4), torch.zeros(4)] * 2
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            kc._launch(x.to(dtype), None, *ws)
    with pytest.raises(TypeError):  # bf16 activations with bf16 weights: weights stay float32
        kc._launch(x.to(torch.bfloat16), None, *(w.to(torch.bfloat16) for w in ws))
    feat = torch.zeros(1, 4, 4, 16, dtype=torch.float16)
    rest = (torch.zeros(2, 1, 16), torch.zeros(1, 16, 16), torch.zeros(1, 16),
            torch.zeros(16, 1), torch.zeros(1))
    with pytest.raises(TypeError):
        km._launch(feat, *rest, False)


def test_plain_sums_and_plain_versions_switches():
    """``plain_sums`` sets the dtype the bf16 plain versions sum in and
    restores the default after (float64 on the CPU); ``plain_versions``
    sets the wrappers' switch and restores it, nested too; a device other
    than cpu and cuda is refused."""
    rng = np.random.default_rng(5)
    x = bf16_input(rng, (1, 8, 8, 4))
    ws = list(map(torch.from_numpy, weights(rng, 4, 8)))
    with kc.plain_sums(torch.float32):
        assert kc.plain_acc(x) == torch.float32
        out = kc.conv_block_fwd(x, *ws)
    assert kc.plain_acc(x) == torch.float64
    h = x.permute(0, 3, 1, 2).float()
    for w, b in zip(ws[::2], ws[1::2]):
        w = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
        h = torch.relu(torch.nn.functional.conv2d(h, w, b, padding=1)).to(torch.bfloat16).float()
    assert torch.equal(out, h.to(torch.bfloat16).permute(0, 2, 3, 1))
    with kc.plain_versions():
        with kc.plain_versions():
            assert kc._PLAIN_VERSIONS
        assert kc._PLAIN_VERSIONS
    assert not kc._PLAIN_VERSIONS
    with pytest.raises(ValueError):
        kc.runs_plain(torch.empty(1, device="meta"), "conv_block_fwd")
