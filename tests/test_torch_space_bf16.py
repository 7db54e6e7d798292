"""The port's bf16 configuration on the (1, 2) mesh: the row-sharded
supervised PUNet step against the port's own step in one process and
against ``pda``'s bf16 ``shard_map`` step, its Pallas kernels interpreted
(``PDA_PALLAS_CONV=1 PDA_PALLAS_MC=1`` under
``pltpu.force_tpu_interpret_mode()``, the composition of
``tests/test_parallel.py``'s ``TestPallasShardMapComposition``), on 2
images of 144 x 16: at num_filters (4, 8, 12, 16) the deepest level keeps
``pda``'s minimum of 9 rows a shard (``pda``'s interpreted kernels take
about a minute a step at ``TestSpatialShardMap``'s 160 x 64).

Bounds. ``pda``'s A/B bounds (``development/ab_step_check.py``): the loss
within 1e-3 relative, 1 - the gradients' cosine at most 1e-5. The port's
sharded step is held to them against its own step in one process (the
sharding's rounding: the encoders' mean completed in bf16, ``pda``'s
rounding point, moves the latent statistics by a bf16 ulp, so the loss
bound is the larger of 1e-3 and twice ``pda``'s own sharded-vs-unsharded
loss spread on the same step). Against ``pda``'s sharded step the bound of
each measure is the larger of ``pda``'s and twice the same measure between
the port and ``pda`` without a mesh on the same step: ``pda`` runs its step
under ``jax.jit`` (a ``shard_map`` step cannot run op by op), where XLA's
CPU compiler fuses a bf16 Dense's product with its bias and drops a
rounding, which alone puts the unsharded steps ~2e-4 apart in cosine
(``tests/test_torch_bf16_slice.py`` holds them at 1e-5 op by op). The
gradients of ``pda``'s step are its SGD update at a rate of 1.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_space_worker as SW
from test_torch_parallel import _pda_params
from test_torch_space import punet_spec
from torch_port_utils import LATENT, pda_punet

H, W, B, SEED = 144, 16, 2, 3
LOSS_TOL, COS_TOL, SPREAD_FACTOR = 1e-3, 1e-5, 2.0
KERNEL_FLAGS = {"PDA_PALLAS_CONV": "1", "PDA_PALLAS_MC": "1"}


def _noise() -> dict:
    _, k_post = jax.random.split(jax.random.PRNGKey(SEED))
    return {"eps_post": torch.from_numpy(np.array(jax.random.normal(k_post, (B, LATENT))))}


def _spec() -> dict:
    spec = punet_spec(H, W, ["supervised"], noise=_noise())
    spec["bf16"] = True
    x, y = spec["batches"]["xy"]
    spec["batches"] = {"xy": (x[:B], y[:B])}
    return spec


@functools.lru_cache(maxsize=None)
def _pda(shape) -> tuple:
    """``pda``'s bf16 supervised step, interpreted, SGD at rate 1: on the
    (N, M) mesh in ``shard_map`` under its row sharding, or jitted alone
    (``shape`` None): (loss, its gradients by the port's names)."""
    import optax
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import PartitionSpec as Ps

    from pda.models.blocks import space_sharding
    from pda.parallel import get_mesh_2d, replicated
    from pda.train.state import create_train_state
    from pda.train.steps import make_supervised_punet_step
    from pda_torch.models import state_dict_from_pda

    model, _ = pda_punet(consensus_masking=True)
    model = model.clone(dtype=jnp.bfloat16)
    tx = optax.sgd(1.0)
    params = jax.tree_util.tree_map(jnp.asarray, _pda_params())
    state = create_train_state(params, tx, jax.random.PRNGKey(SEED))
    batch = [jnp.asarray(b.numpy()) for b in _spec()["batches"]["xy"]]
    old = {k: os.environ.get(k) for k in KERNEL_FLAGS}
    os.environ.update(KERNEL_FLAGS)
    try:
        with pltpu.force_tpu_interpret_mode():
            if shape is None:
                after, metrics = jax.jit(make_supervised_punet_step(model, tx))(state, *batch)
            else:
                mesh = get_mesh_2d(*shape)
                step = jax.jit(jax.shard_map(
                    make_supervised_punet_step(model, tx, axis_name="data"), mesh=mesh,
                    in_specs=(Ps(), Ps("data", "space"), Ps("data", "space")),
                    out_specs=(Ps(), Ps()), check_vma=False))
                with space_sharding("space"):
                    after, metrics = step(jax.device_put(state, replicated(mesh)), *batch)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    before = state_dict_from_pda(_pda_params())
    after = state_dict_from_pda(jax.tree_util.tree_map(np.asarray, after.params))
    grads = {k: torch.as_tensor(before[k]).double() - torch.as_tensor(after[k]).double()
             for k in before}
    return float(metrics["loss"]), grads


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """(sharded rank 0's, one process's) supervised bf16 step: loss, gradients."""
    spec = _spec()
    sharded = SW.spawn((1, 2), spec, str(tmp_path_factory.mktemp("bf16")))[0]["supervised"]
    single = SW.run_cases(spec, None)["supervised"]
    return tuple((r["aux"]["loss"], {k: v.double() for k, v in r["grads"].items()})
                 for r in (sharded, single))


def _spread(a: tuple, b: tuple) -> tuple:
    """(the losses' relative difference, 1 - the gradients' cosine)."""
    (la, ga), (lb, gb) = a, b
    dot = sum(float((ga[k] * gb[k]).sum()) for k in gb)
    norms = (sum(float(ga[k].square().sum()) for k in gb)
             * sum(float(v.square().sum()) for v in gb.values())) ** 0.5
    return abs(la - lb) / abs(lb), 1.0 - dot / norms


def test_bf16_row_sharded_step_matches_the_one_process_step(port):
    sharded, single = port
    loss, cos = _spread(sharded, single)
    pda_loss, _ = _spread(_pda((1, 2)), _pda(None))
    assert cos <= COS_TOL, cos
    assert loss <= max(LOSS_TOL, SPREAD_FACTOR * pda_loss), (loss, pda_loss)


def test_bf16_row_sharded_step_matches_pda_shard_map(port):
    sharded, single = port
    loss, cos = _spread(sharded, _pda((1, 2)))
    base_loss, base_cos = _spread(single, _pda(None))
    assert loss <= max(LOSS_TOL, SPREAD_FACTOR * base_loss), (loss, base_loss)
    assert cos <= max(COS_TOL, SPREAD_FACTOR * base_cos), (cos, base_cos)
