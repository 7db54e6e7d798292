"""The port's bf16 configuration against ``pda``'s, end to end on the CPU:
a bf16 PUNet's forward, the Mean-Teacher step's loss, aux and gradients,
and the teacher's MC pseudo-labels. ``pda`` runs its bf16 model
(``ProbabilisticUnet(dtype=bfloat16)``) with its Pallas kernels
(``PDA_PALLAS_CONV=1 PDA_PALLAS_MC=1``, interpreted under
``pltpu.force_tpu_interpret_mode()``): at 64^2 and num_filters (4, 8, 12,
16) every ConvBlock takes its kernels and the flat pipeline, as at the bench
geometry (at 32^2 the deepest block would fall back to XLA's convolutions,
which round elsewhere). ``pda``'s step runs op by op, as its flax modules
are written (under ``jax.jit``, XLA's CPU compiler fuses a bf16 Dense's
product with its bias and drops the rounding between them, which moves the
latent statistics by a bf16 ulp). Both sides carry the same float32 weights
(bridged with ``state_dict_from_pda``) and the same noise (the normals of
the keys ``pda``'s step splits off ``state.rng``).

Bounds, those of ``pda``'s own bf16 A/B of its kernels
(``development/ab_step_check.py``): the loss's relative difference <= 1e-3,
the gradients' global cosine >= 1 - 1e-5, the worst leaf's relative L2 <=
1e-2 (floored at 1e-4 of the global norm), consensus pixels equal except
where one of the port's teacher logits lies within one bf16 ulp (2^-6) of a
threshold; the forward's bf16 features within one bf16 ulp (bit-equal on
99%) and the latent statistics within one bf16 ulp. The port's student
loss takes ``pda``'s pseudo-labels (as ``chip_smoke.py``'s card-vs-CPU step
takes the card's): the MC means' float32 sums differ in their last bits,
and the posterior rounds its input to bf16, where such a difference can fall
either way; the pseudo-labels are compared on their own."""

import copy
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pda.train import steps as jsteps
from pda.train.optim import adam as jadam
from pda.train.state import create_train_state as jcreate_train_state
from pda_torch.models import state_dict_from_pda
from pda_torch.models.punet import mc_decode_logits
from pda_torch.train import steps
from test_torch_bf16_kernels import assert_bf16_close, to_torch
from torch_port_utils import LATENT, pda_punet, port_punet, t

B, P, N_MC, SEED = 2, 64, 16, 5
LAST_SCALE, Z_SCALE = 32.0, 0.02  # the consensus share lies inside (0, 1)
LOSS_TOL, COS_TOL, LEAF_TOL, WINDOW = 1e-3, 1e-5, 1e-2, 2.0 ** -6
KERNEL_FLAGS = {"PDA_PALLAS_CONV": "1", "PDA_PALLAS_MC": "1"}


@functools.lru_cache(maxsize=None)
def _params():
    _, params = pda_punet(consensus_masking=True)
    fc = dict(params["fcomb"])
    fc["last_layer"] = {k: v * LAST_SCALE for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * Z_SCALE}
    return {**params, "fcomb": fc}


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(B, P, P, 1)).astype(np.float32)
    x1 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    x2 = x + 0.1 * rng.normal(size=x.shape).astype(np.float32)
    return x, x1, x2, (x > 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """pda's bf16 model on its kernels, interpreted, op by op: the encoding
    of x with its posterior, the teacher's MC pseudo-labels on x1, the
    student's loss on x2 and its gradients, and the noise its step drew."""
    model, _ = pda_punet(consensus_masking=True)
    model = model.clone(dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    state = jcreate_train_state(params, jadam(1e-5), jax.random.PRNGKey(SEED),
                                with_teacher=True)
    x, x1, x2, gt = map(jnp.asarray, _batch())
    _, k_t, k_post = jax.random.split(state.rng, 3)

    def compute(params, teacher):
        enc = model.apply({"params": params}, x, gt, method="encode")
        y, z = jsteps._mc_pseudo(model, teacher, x1, k_t, N_MC, True)
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jsteps._punet_loss(model, p, x2, y, k_post, consm=z), has_aux=True)(params)
        stats = {"prior_mu": enc.prior.mu, "prior_log_sigma": enc.prior.log_sigma,
                 "posterior_mu": enc.posterior.mu}
        return {"features": enc.features, "stats": stats, "y": y, "z": z, "aux": aux,
                "grads": grads, "eps_teacher": jax.random.normal(k_t, (N_MC, B, LATENT)),
                "eps_post": jax.random.normal(k_post, (B, LATENT))}

    old = {k: os.environ.get(k) for k in KERNEL_FLAGS}
    os.environ.update(KERNEL_FLAGS)  # read while the step traces
    try:
        with pltpu.force_tpu_interpret_mode():
            out = compute(state.params, state.teacher_params)
            out = jax.tree_util.tree_map(np.asarray, out)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _port() -> dict:
    ref = _reference()
    model = port_punet(_params(), consensus_masking=True)
    model.dtype = torch.bfloat16
    teacher = copy.deepcopy(model)
    x, x1, x2, gt = map(t, _batch())
    eps_teacher, eps_post = t(ref["eps_teacher"]), t(ref["eps_post"])
    with torch.no_grad():
        enc = model.encode(x, gt)
        y, z = steps._mc_pseudo(teacher, x1, N_MC, True, eps_teacher)
        tenc = teacher.encode(x1)
        logits = mc_decode_logits(teacher, tenc.features, tenc.prior, N_MC, eps=eps_teacher)
    # the student's loss on pda's pseudo-labels, so that the MC tail's float32
    # rounding (held apart below) does not reach the student's bf16 input
    loss, aux = steps._punet_loss(model, x2, t(ref["y"]), eps_post, consm=t(ref["z"]))
    loss.backward()
    return {"features": enc.features, "y": y, "z": z, "logits": logits,
            "stats": {"prior_mu": enc.prior.mu, "prior_log_sigma": enc.prior.log_sigma,
                      "posterior_mu": enc.posterior.mu},
            "aux": {k: float(v.detach()) for k, v in aux.items()},
            "grads": {k: p.grad.double() for k, p in model.named_parameters()},
            "dtypes": {p.grad.dtype for p in model.parameters()}}


def test_bf16_forward_matches_pda():
    ref, port = _reference(), _port()
    assert port["features"].dtype == torch.bfloat16
    assert_bf16_close(port["features"], ref["features"])
    for name, v in ref["stats"].items():
        out = port["stats"][name]
        assert out.dtype == torch.float32, name  # latent statistics leave in float32
        ulp = 2.0 ** (math.floor(math.log2(float(np.abs(v).max()))) - 7)
        assert float((out - t(v)).abs().max()) <= ulp, name


def test_bf16_mt_step_loss_and_gradients_match_pda():
    ref, port = _reference(), _port()
    assert set(port["aux"]) == set(ref["aux"]) == {"loss", "recon_loss", "kl"}
    for name, v in ref["aux"].items():
        assert abs(port["aux"][name] - float(v)) <= LOSS_TOL * max(abs(float(v)), 1e-12), name
    assert port["dtypes"] == {torch.float32}  # float32 parameters take float32 gradients
    grads = {k: torch.from_numpy(np.asarray(v, dtype=np.float64))
             for k, v in state_dict_from_pda(ref["grads"]).items()}
    assert set(grads) == set(port["grads"])
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    dot = sum(float((port["grads"][k] * g).sum()) for k, g in grads.items())
    norm = math.sqrt(sum(float((g * g).sum()) for g in port["grads"].values()))
    assert 1.0 - dot / (norm * gnorm) <= COS_TOL
    for k, g in grads.items():
        rel = float((port["grads"][k] - g).norm()) / max(float(g.norm()), 1e-4 * gnorm)
        assert rel <= LEAF_TOL, (k, rel)


def test_bf16_mc_pseudo_matches_pda():
    ref, port = _reference(), _port()
    assert port["y"].dtype == port["z"].dtype == torch.float32
    assert 0.0 < float(port["z"].mean()) < 1.0
    assert float((port["y"] - to_torch(ref["y"])).abs().max()) <= 2.0 ** -8
    near = ((port["logits"].abs() - math.log(9.0)).abs() < WINDOW).any(dim=0)
    assert not ((port["z"] != to_torch(ref["z"])) & ~near).any()


@pytest.mark.parametrize("case", ["bf16", "float32"])
def test_model_dtype_switches_every_part(case):
    """Setting ``model.dtype`` reaches every block, encoder and the Fcomb,
    and leaves the parameters float32; float16 is refused."""
    model = port_punet(_params())
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    model.dtype = dtype
    dtypes = {m.dtype for m in model.modules() if hasattr(type(m), "dtype")}
    assert dtypes == {dtype}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError):
        model.dtype = torch.float16
