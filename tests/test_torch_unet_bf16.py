"""The port's bf16 ``UNet2d`` against ``pda``'s ``UNet2d(dtype=bfloat16)`` on
the CPU, depth 2, 32^2, batch 2, ``initial_features`` 4 and 8, with the norm
and without; weights are seeded numpy carried across by
``unet_state_dict_from_pda``.

  * layer by layer: each of ``pda``'s layers (flax's ``GroupNorm`` and
    ``Conv`` in bf16, the max pool, the float32 upsample cast to bf16, the
    head) run op by op on the port's own bf16 input to that layer, against
    the port's layer: at least ``BIT_EQUAL`` of the elements bit-equal and
    none beyond one bf16 ulp (for a conv, the ulp of its first rounding, the
    sum's before the bias add, where that is coarser: a bias that cancels
    the sum shows a one-ulp difference of the sum as several of the
    result's). A conv whose bias is fused into one rounding
    (``F.conv2d(x, w, b)`` in bf16) fails that check: the control.
  * the whole forward, float32 probabilities, within ``FWD_TOL``.
  * one supervised UNet step against ``pda``'s with the model cloned to
    bf16, op by op and jitted: the loss within ``LOSS_TOL`` relative, the
    gradients' global cosine within ``COS_TOL`` of 1 (against the jitted
    step, or ``SPREAD`` times ``pda``'s own jitted-vs-op-by-op distance),
    parameters and gradients float32.
  * a float32 ``UNet2d`` bit-equal to its torch modules run as before.
  * ``lung_punet(dtype=bfloat16)``.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pda.models.unet import UNet2d as JUNet2d
from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch import train as ttrain
from pda_torch.experiments.common import lung_punet
from pda_torch.models import UNet2d, unet_state_dict_from_pda
from pda_torch.models import unet as tunet
from pda_torch.train import adam, create_train_state
from torch_port_utils import seeded_params, t

DEPTH, HW, BATCH, LR = 2, 32, 2, 1e-4
FEATS = (4, 8)
NORMS = {"instance_norm": "InstanceNorm", "no_norm": None}
BF16 = torch.bfloat16
#: each layer: this share of its elements bit-equal to pda's, none beyond one ulp
BIT_EQUAL = 0.99
#: the whole bf16 forward's sigmoid output: max |port - pda| (a rounding that
#: falls the other way in one layer moves every later one)
FWD_TOL = 2e-2
#: one step against pda's bf16 step run op by op: the loss's relative
#: difference and 1 - the gradients' global cosine
LOSS_TOL, COS_TOL = 1e-3, 1e-3
#: against pda's jitted step, the larger of those and SPREAD x pda's own
#: jitted-vs-op-by-op distance (XLA's CPU compiler may skip a bf16 rounding
#: under jit; after an InstanceNorm at 4 channels that moves the gradients'
#: cosine by 1e-2)
SPREAD = 4


@functools.lru_cache(maxsize=None)
def _pda(feats: int, norm_case: str):
    model = JUNet2d(depth=DEPTH, initial_features=feats, final_activation="Sigmoid",
                    norm=NORMS[norm_case], dtype=jnp.bfloat16)
    return model, seeded_params(model, jnp.zeros((1, 16, 16, 1)), seed=3)


def _port(feats: int, norm_case: str, dtype=BF16) -> UNet2d:
    _, params = _pda(feats, norm_case)
    model = UNet2d(depth=DEPTH, initial_features=feats, final_activation="Sigmoid",
                   norm=NORMS[norm_case], dtype=dtype)
    model.load_state_dict(unet_state_dict_from_pda(params, norm=NORMS[norm_case]))
    return model


def _x(seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(BATCH, HW, HW, 1)).astype(np.float32)


def _nhwc(a: torch.Tensor) -> jnp.ndarray:
    """A port NCHW tensor as pda's NHWC array, dtype kept."""
    return jnp.asarray(a.permute(0, 2, 3, 1).float().numpy()).astype(
        jnp.bfloat16 if a.dtype == BF16 else jnp.float32)


def _pda_norm(x):
    return fnn.GroupNorm(num_groups=None, group_size=1, use_bias=False, use_scale=False,
                         epsilon=1e-5, dtype=jnp.bfloat16).apply({}, x)


def _pda_conv(tree, k):
    conv = fnn.Conv(tree["kernel"].shape[-1], (k, k), padding="SAME", dtype=jnp.bfloat16)
    return lambda x: conv.apply({"params": tree}, x)


def _pda_upsample(x):
    n, h, w, c = x.shape
    return jax.image.resize(x.astype(jnp.float32), (n, 2 * h, 2 * w, c),
                            method="linear").astype(jnp.bfloat16)


def _layers(feats, norm_case, conv=tunet._conv_bf16):
    """(name, pda's layer, the port's input to it (NCHW), the port's output,
    the conv's bf16 bias or None) for every layer of the bf16 forward, each
    port layer fed the port's own output of the layer before; ``conv`` is
    the port's conv layer."""
    model = _port(feats, norm_case)
    _, params = _pda(feats, norm_case)
    out = []

    def run(name, fn, ref, h, bias=None):
        y = fn(h)
        out.append((name, ref, h, y, bias))
        return y

    def bias(m):
        return m.bias.to(BF16).double().view(1, 1, 1, -1).numpy()

    def block(prefix, mod, tree, h):
        j = 0
        for m in mod.block:
            if isinstance(m, torch.nn.InstanceNorm2d):
                h = run(f"{prefix} norm {j}", tunet._norm_bf16, _pda_norm, h)
            elif isinstance(m, torch.nn.Conv2d):
                h = run(f"{prefix} conv {j}", functools.partial(conv, conv=m),
                        _pda_conv(tree[f"Conv_{j}"], 3), h, bias(m))
                j += 1
            else:
                h = F.relu(h)
        return h

    h = torch.from_numpy(_x()).permute(0, 3, 1, 2)
    if NORMS[norm_case] is None:
        h = h.to(BF16)  # flax's Conv(dtype=bf16) casts its input
    skips = []
    with torch.no_grad():
        for i, mod in enumerate(model.encoder.blocks):
            h = block(f"encoder {i}", mod, params[f"_DoubleConv_{i}"], h)
            skips.append(h)
            h = run(f"pool {i}", lambda v: F.max_pool2d(v, 2),
                    lambda v: fnn.max_pool(v, (2, 2), strides=(2, 2)), h)
        h = block("base", model.base, params[f"_DoubleConv_{DEPTH}"], h)
        for i, (sampler, mod, skip) in enumerate(zip(model.decoder.samplers,
                                                     model.decoder.blocks, reversed(skips))):
            h = run(f"upsample {i}", tunet._upsample_bf16, _pda_upsample, h)
            h = run(f"sampler {i}", functools.partial(conv, conv=sampler.conv),
                    _pda_conv(params[f"Conv_{i}"], 1), h, bias(sampler.conv))
            h = block(f"decoder {i}", mod, params[f"_DoubleConv_{DEPTH + 1 + i}"],
                      torch.cat([h, skip], dim=1))
        run("head", functools.partial(conv, conv=model.out_conv),
            _pda_conv(params[f"Conv_{DEPTH}"], 1), h, bias(model.out_conv))
    return out


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element of a float64 array."""
    _, e = np.frexp(np.maximum(np.abs(a), 2.0 ** -126))
    return np.ldexp(1.0, e - 8)


def _agree(out: torch.Tensor, ref, bias=None) -> tuple:
    """(bit-equal share, elements beyond one bf16 ulp) of a port layer's bf16
    output against pda's; given a conv's ``bias``, the ulp is the larger of
    the output's and its sum's before the bias add."""
    a = out.permute(0, 2, 3, 1).double().numpy()
    r = np.asarray(ref, np.float64)
    assert a.shape == r.shape, (a.shape, r.shape)
    mag = np.maximum(np.abs(a), np.abs(r))
    if bias is not None:
        mag = np.maximum(mag, np.maximum(np.abs(a - bias), np.abs(r - bias)))
    beyond = np.abs(a - r) > _ulp(mag)
    return float((a == r).mean()), int(beyond.sum())


def _worst(layers):
    """The layer with the least bit-equal share, and the most elements
    beyond one ulp over all layers."""
    res = [(name, *_agree(y, ref(_nhwc(h)), b)) for name, ref, h, y, b in layers]
    return min(res, key=lambda r: r[1]), max(r[2] for r in res)


CASES = [(f, n) for f in FEATS for n in NORMS]


@pytest.mark.parametrize("feats,norm_case", CASES)
def test_unet_bf16_layers_match_pda(feats, norm_case):
    layers = _layers(feats, norm_case)
    assert all(y.dtype == BF16 for _, _, _, y, _ in layers)
    (name, equal, _), beyond = _worst(layers)
    assert beyond == 0
    assert equal >= BIT_EQUAL, (name, equal)


def _fused_bias_conv(x, conv):
    """A bf16 conv whose bias rides in ``F.conv2d``: one rounding of sum + bias."""
    return F.conv2d(x.to(BF16), conv.weight.to(BF16), conv.bias.to(BF16), padding=conv.padding)


@pytest.mark.parametrize("feats,norm_case", CASES[:2])
def test_unet_bf16_layer_check_catches_a_fused_bias(feats, norm_case):
    (name, equal, _), beyond = _worst(_layers(feats, norm_case, conv=_fused_bias_conv))
    assert equal < BIT_EQUAL or beyond > 0, (name, equal, beyond)


@pytest.mark.parametrize("feats,norm_case", CASES)
def test_unet_bf16_forward_matches_pda(feats, norm_case):
    model, params = _pda(feats, norm_case)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(_x())))
    port = _port(feats, norm_case)
    with torch.no_grad():
        out = port(t(_x()))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert tuple(out.shape) == ref.shape
    assert float(np.abs(out.numpy() - ref).max()) <= FWD_TOL


def _parent_forward(model: UNet2d, x: torch.Tensor) -> torch.Tensor:
    """The float32 forward as UNet2d ran it before it had a dtype: its torch
    modules, max pool, bilinear x2 and sigmoid."""
    h, skips = x.permute(0, 3, 1, 2), []
    for block in model.encoder.blocks:
        h = block.block(h)
        skips.append(h)
        h = F.max_pool2d(h, 2)
    h = model.base.block(h)
    for sampler, block, skip in zip(model.decoder.samplers, model.decoder.blocks,
                                    reversed(skips)):
        up = sampler.conv(F.interpolate(h, scale_factor=2, mode="bilinear",
                                        align_corners=False))
        h = block.block(torch.cat([up, skip], dim=1))
    return torch.sigmoid(model.out_conv(h)).permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("norm_case", NORMS)
def test_unet_float32_forward_is_unchanged(norm_case):
    """A float32 UNet2d, also one set to bf16 and back, computes what its
    torch modules compute, bit for bit."""
    a, b = _port(4, norm_case, torch.float32), _port(4, norm_case)
    assert a.dtype == torch.float32 and b.dtype == BF16
    b.dtype = torch.float32
    x = t(_x())
    with torch.no_grad():
        ref = _parent_forward(a, x)
        assert torch.equal(a(x), ref) and torch.equal(b(x), ref)


def _batch():
    x = _x(6)
    return x, (x > 0.3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pda_step(feats: int, norm_case: str):
    """pda's supervised step with the model cloned to bf16, jitted, and its
    loss and gradients op by op: {"jit": (loss, grads), "ops": (loss, grads)}."""
    _, params = _pda(feats, norm_case)
    model = JUNet2d(depth=DEPTH, initial_features=feats, final_activation="Sigmoid",
                    norm=NORMS[norm_case]).clone(dtype=jnp.bfloat16)
    tx = jadam(LR)
    state = jcreate_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx,
                                jax.random.PRNGKey(0))
    batch = tuple(map(jnp.asarray, _batch()))
    _, aux = jax.jit(jsteps.make_supervised_unet_step(model, tx))(state, *batch)

    def loss(p):
        return jsteps.dice_loss(model.apply({"params": p}, batch[0]), batch[1])

    out = {"jit": (float(aux["loss"]), jax.jit(jax.grad(loss))(state.params))}
    with jax.disable_jit():
        out["ops"] = (float(loss(state.params)), jax.grad(loss)(state.params))
    return {k: (v, unet_state_dict_from_pda(jax.tree_util.tree_map(np.asarray, g),
                                            norm=NORMS[norm_case]))
            for k, (v, g) in out.items()}


def _cos_distance(a: dict, b: dict) -> float:
    """1 - the global cosine of two gradient dicts."""
    u = torch.cat([a[k].double().flatten() for k in b])
    v = torch.cat([b[k].double().flatten() for k in b])
    return 1.0 - float(u @ v / (u.norm() * v.norm()))


@pytest.mark.parametrize("feats,norm_case", CASES)
def test_unet_bf16_step_matches_pda(feats, norm_case):
    ref = _pda_step(feats, norm_case)
    model = _port(feats, norm_case)
    state = create_train_state(model, adam(model.parameters(), LR))
    _, aux = ttrain.make_supervised_unet_step()(state, *map(t, _batch()))
    assert state.step == 1
    params = dict(model.named_parameters())
    assert {p.dtype for p in params.values()} == {torch.float32}
    assert {p.grad.dtype for p in params.values()} == {torch.float32}
    grads = {k: p.grad for k, p in params.items()}
    loss = float(aux["loss"])
    (loss_ops, g_ops), (loss_jit, g_jit) = ref["ops"], ref["jit"]
    # op by op, pda rounds where the port does
    assert abs(loss - loss_ops) <= LOSS_TOL * abs(loss_ops)
    assert _cos_distance(grads, g_ops) <= COS_TOL
    # its jitted step: within pda's own jit-vs-op-by-op spread, times SPREAD
    spread_loss = abs(loss_jit - loss_ops) / abs(loss_ops)
    assert abs(loss - loss_jit) <= max(LOSS_TOL, SPREAD * spread_loss) * abs(loss_jit)
    spread_cos = _cos_distance(g_jit, g_ops)
    assert _cos_distance(grads, g_jit) <= max(COS_TOL, SPREAD * spread_cos)


def test_lung_punet_takes_a_dtype():
    bf16 = lung_punet(dtype=BF16, device="cpu", generator=torch.Generator().manual_seed(2))
    f32 = lung_punet(device="cpu", generator=torch.Generator().manual_seed(2))
    assert bf16.dtype == BF16 and f32.dtype == torch.float32
    assert bf16.unet.contracting_path[0].dtype == BF16
    sa, sb = bf16.state_dict(), f32.state_dict()
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        assert v.dtype == sb[k].dtype and torch.equal(v, sb[k]), k
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}
