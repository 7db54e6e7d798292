"""The ConvBlock's autograd Functions (single and dual input) against
``jax.vjp`` of ``pda``'s ``conv3_relu`` (``pda/models/blocks.py``: XLA convs
with ``pda``'s hand VJP, its plain reference), on the CPU, where the
Functions run the plain forward and the plain backward with the same
saved-tensor, need-dx and dual-split plumbing as the CUDA kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.models import blocks as jblocks
from pda_torch.kernels import conv_block as kconv
from pda_torch.models.blocks import avg_pool_2x2
from torch_port_utils import assert_close_scaled, t


def _weights(rng, cin, c):
    """[w1, b1, w2, b2, w3, b3] as numpy, HWIO kernels."""
    out = []
    for ci in (cin, c, c):
        out.append((rng.normal(size=(3, 3, ci, c)) * np.sqrt(2.0 / (9 * ci))).astype(np.float32))
        out.append((rng.normal(size=(c,)) * 0.1).astype(np.float32))
    return out


@pytest.fixture
def need_dx_calls(monkeypatch):
    """The ``need_dx`` of every plain backward call."""
    calls, plain = [], kconv.conv_block_bwd_plain

    def spy(*args, **kwargs):
        calls.append(args[8] if len(args) > 8 else kwargs.get("need_dx", True))
        return plain(*args, **kwargs)

    monkeypatch.setattr(kconv, "conv_block_bwd_plain", spy)
    return calls


@pytest.mark.parametrize(
    "cin,c,h,w,pool,need_dx",
    [
        (1, 8, 9, 13, False, False),  # image entry block, odd H/W: no dx
        (2, 8, 7, 10, False, False),  # posterior entry (image + mask): no dx
        (5, 12, 11, 11, False, True),
        (6, 16, 12, 18, True, True),  # pooled block: dx through the pool
    ],
)
def test_conv_block_grads_match_pda_vjp(cin, c, h, w, pool, need_dx, need_dx_calls):
    rng = np.random.default_rng(cin * 10 + h)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    ws = _weights(rng, cin, c)
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    g = rng.normal(size=(2, ho, wo, c)).astype(np.float32)

    def ref_fn(x, *ws):
        return jblocks.conv3_relu(jblocks.avg_pool_2x2(x) if pool else x, *ws)

    ref_out, vjp = jax.vjp(ref_fn, jnp.asarray(x), *map(jnp.asarray, ws))
    ref_grads = vjp(jnp.asarray(g))

    xt = t(x).requires_grad_(need_dx)
    wt = [t(a).requires_grad_() for a in ws]
    out = kconv.conv_block_fwd(avg_pool_2x2(xt) if pool else xt, *wt)
    out.backward(t(g))
    assert_close_scaled(out.detach().numpy(), ref_out)
    assert need_dx_calls == [need_dx]
    if need_dx:
        assert_close_scaled(xt.grad.numpy(), ref_grads[0])
    else:
        assert xt.grad is None
    for p, r in zip(wt, ref_grads[1:]):
        assert_close_scaled(p.grad.numpy(), r)


@pytest.mark.parametrize("ca,cb,c,h,w", [(7, 5, 8, 6, 9), (16, 12, 12, 8, 8), (3, 1, 4, 5, 3)])
def test_dual_conv_block_grads_match_pda_vjp(ca, cb, c, h, w):
    rng = np.random.default_rng(ca + cb)
    xa = rng.normal(size=(2, h, w, ca)).astype(np.float32)
    xb = rng.normal(size=(2, h, w, cb)).astype(np.float32)
    ws = _weights(rng, ca + cb, c)
    g = rng.normal(size=(2, h, w, c)).astype(np.float32)

    def ref_fn(xa, xb, *ws):
        return jblocks.conv3_relu(jnp.concatenate([xa, xb], axis=-1), *ws)

    ref_out, vjp = jax.vjp(ref_fn, jnp.asarray(xa), jnp.asarray(xb), *map(jnp.asarray, ws))
    ref_grads = vjp(jnp.asarray(g))

    xat, xbt = t(xa).requires_grad_(), t(xb).requires_grad_()
    wt = [t(a).requires_grad_() for a in ws]
    out = kconv.conv_block_fwd_dual(xat, xbt, *wt)
    out.backward(t(g))
    assert_close_scaled(out.detach().numpy(), ref_out)
    for p, r in zip((xat, xbt, *wt), ref_grads):
        assert p.grad.shape == r.shape
        assert_close_scaled(p.grad.numpy(), r)


def test_plain_backward_is_the_hand_vjp():
    """The explicit plain backward, called directly, against pda's hand VJP
    (``_conv3_bwd``) from the same saved tensors; dx only when asked."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 6, 7, 3)).astype(np.float32)
    ws = _weights(rng, 3, 5)
    g = rng.normal(size=(1, 6, 7, 5)).astype(np.float32)
    h3, res = jblocks._conv3_fwd(*map(jnp.asarray, (x, *ws)))
    ref = jblocks._conv3_bwd(res, jnp.asarray(g))
    _, w1, w2, w3, h1, h2, _ = res
    saved = [t(a) for a in (g, x, h1, h2, h3, w1, w2, w3)]
    out = kconv.conv_block_bwd(*saved)
    for a, r in zip(out, ref):
        assert_close_scaled(a.numpy(), r)
    assert kconv.conv_block_bwd(*saved, need_dx=False)[0] is None
    dxa, dxb, *rest = kconv.conv_block_bwd_dual(saved[0], saved[1][..., :2].contiguous(),
                                                saved[1][..., 2:].contiguous(), *saved[2:])
    torch.testing.assert_close(torch.cat([dxa, dxb], -1), out[0], rtol=0, atol=0)
    for a, b in zip(rest, out[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _bwd_args(cin=3, c=4, shape=(1, 5, 6)):
    x, g = torch.zeros(*shape, cin), torch.zeros(*shape, c)
    hs = [torch.zeros(*shape, c) for _ in range(3)]
    ws = [torch.zeros(3, 3, ci, c) for ci in (cin, c, c)]
    return [g, x, *hs, *ws]


@pytest.mark.parametrize("bad", ["g_shape", "h_dtype", "w_shape", "contiguity"])
def test_bwd_kernel_wrapper_rejects_what_it_cannot_take(bad):
    """The CUDA path's checks run before any launch, so they run here too."""
    args = _bwd_args()
    if bad == "g_shape":
        args[0] = torch.zeros(1, 5, 6, 5)
    elif bad == "h_dtype":
        args[3] = args[3].double()
    elif bad == "w_shape":
        args[5] = torch.zeros(3, 3, 2, 4)
    else:
        args[2] = torch.zeros(1, 6, 5, 4).transpose(1, 2)
    g, x, *rest = args
    with pytest.raises((TypeError, ValueError)):
        kconv._launch_bwd(g, x, None, *rest, need_dx=True)


def test_bwd_wrappers_refuse_other_devices_and_count_no_cpu_launch():
    args = _bwd_args()
    for fn in (kconv.conv_block_bwd, kconv.conv_block_bwd_dual):
        fn.launches = 0
    kconv.conv_block_bwd(*args)
    g, x, *rest = args
    kconv.conv_block_bwd_dual(g, x[..., :1].contiguous(), x[..., 1:].contiguous(), *rest)
    assert kconv.conv_block_bwd.launches == kconv.conv_block_bwd_dual.launches == 0
    with pytest.raises(ValueError, match="cpu or cuda"):
        kconv.conv_block_bwd(*[a.to("meta") for a in args])
