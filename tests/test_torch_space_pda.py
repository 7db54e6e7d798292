"""The port's row-sharded steps on a (data, space) mesh against ``pda``'s
``shard_map`` step on the same mesh of the CPU's 8 XLA devices
(``conftest.py``), with ``pda``'s row sharding (``space_sharding``): the
supervised PUNet step and the Mean-Teacher step (consensus masking on), SGD
as ``pda``'s ``TestSpatialShardMap``, at its geometry (4 images of 160 x
64), from the same weights and the same global noise (the normals of the
keys ``pda``'s step splits off its state's key), the port in a spawned gloo
world (``tests/torch_space_worker.py``). This file holds the (1, 2) mesh
and the tiled serving on it; ``tests/test_torch_space_pda_2x2.py`` the (2,
2) mesh.

Bounds: the data mesh's against ``pda`` (``tests/test_torch_parallel.py``):
the loss and aux 1e-5 relative; the parameters after the step and the
teacher 1e-4 of max(1, |ref|); the tiled probabilities 1e-5. The (1, 4)
mesh is held against one process only (``tests/test_torch_space.py``),
which keeps ``pda``'s compile time out of the suite.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as TP
import torch_space_worker as SW
from test_torch_parallel import _close, _pda_params
from test_torch_space import B, MC, WIDTH, punet_spec
from torch_port_utils import LATENT, pda_punet

H, SEED, SGD_LR = 160, 3, 1e-2
#: case -> (pda's step factory, its keywords, the noise it splits off its key, teacher)
STEPS = {"supervised": ("make_supervised_punet_step", {}, ("eps_post",), False),
         "mt": ("make_mean_teacher_step", {"momentum": 0.999, "do_consensus_masking": True},
                ("eps_teacher", "eps_post"), True)}
AUX_TOL, PARAM_TOL, TILE_TOL = 1e-5, 1e-4, 1e-5


def noise(case: str) -> dict:
    """The global noise ``pda``'s step draws from ``PRNGKey(SEED)``."""
    names = STEPS[case][2]
    keys = jax.random.split(jax.random.PRNGKey(SEED), len(names) + 1)[1:]
    shapes = {"eps_post": (B, LATENT), "eps_teacher": (MC, B, LATENT)}
    return {n: torch.from_numpy(np.array(jax.random.normal(k, shapes[n])))
            for n, k in zip(names, keys)}


@functools.lru_cache(maxsize=None)
def pda_step(shape: tuple, case: str):
    """``pda``'s step of ``case`` in ``shard_map`` on the (N, M) mesh, under
    its row sharding: (the state after it, its metrics)."""
    import optax
    from jax.sharding import PartitionSpec as Ps

    from pda.models.blocks import space_sharding
    from pda.parallel import get_mesh_2d, replicated
    from pda.train import steps as jsteps
    from pda.train.state import create_train_state

    factory, kw, _, teacher = STEPS[case]
    model, _ = pda_punet(consensus_masking=True)
    tx = optax.sgd(SGD_LR)
    params = jax.tree_util.tree_map(jnp.asarray, _pda_params())
    state = create_train_state(params, tx, jax.random.PRNGKey(SEED), with_teacher=teacher)
    batch = punet_spec(H, WIDTH, [])["batches"]["dual" if teacher else "xy"]
    mesh = get_mesh_2d(*shape)
    step = jax.jit(jax.shard_map(
        getattr(jsteps, factory)(model, tx, axis_name="data", **kw), mesh=mesh,
        in_specs=(Ps(), *([Ps("data", "space")] * len(batch))), out_specs=(Ps(), Ps()),
        check_vma=False))
    with space_sharding("space"):
        return step(jax.device_put(state, replicated(mesh)),
                    *[jnp.asarray(b.numpy()) for b in batch])


def port_ranks(shape: tuple, tmp) -> dict:
    """case -> each rank's results of the port's step on the (N, M) mesh."""
    out = {}
    for case in STEPS:
        spec = punet_spec(H, WIDTH, [case], noise=noise(case))
        out[case] = [r[case] for r in SW.spawn(shape, spec, str(tmp / case))]
    return out


def check_against_pda(got: list, shape: tuple, case: str) -> None:
    from pda_torch.models import state_dict_from_pda

    state, metrics = pda_step(shape, case)
    for k in ("loss", "recon_loss", "kl"):
        _close(got[0]["aux"][k], float(metrics[k]), AUX_TOL, k)
    parts = [("params", state.params)] + ([("teacher", state.teacher_params)]
                                          if STEPS[case][3] else [])
    for part, tree in parts:
        ref = state_dict_from_pda(jax.tree_util.tree_map(np.asarray, tree))
        for k, v in ref.items():
            _close(got[0][part][k], v, PARAM_TOL, f"{part} {k}")
    for r, res in enumerate(got[1:], 1):
        for k, v in res["params"].items():
            assert torch.equal(v, got[0]["params"][k]), f"rank {r} {k}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return port_ranks((1, 2), tmp_path_factory.mktemp("pda1x2"))


@pytest.mark.parametrize("case", list(STEPS))
def test_row_sharded_step_matches_pda_shard_map(ranks, case):
    check_against_pda(ranks[case], (1, 2), case)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    spec = SW.W.copy_spec(TP._spec(2), ["tiles"])
    return SW.spawn((1, 2), spec, str(tmp_path_factory.mktemp("tiles")))


@pytest.mark.parametrize("frame", list(TP.TILE_FRAMES))
def test_tiled_serving_on_one_by_two_matches_pda(tiles, frame):
    """Tiled MC serving on the (1, 2) mesh shards the tiles over both ranks
    (no tile's rows are split): every rank's map is ``pda``'s
    ``_tiled_punet_probs(mesh=get_mesh_2d(1, 2))`` on the same frame, weights
    and noise (a tile count the world divides, and one it pads)."""
    from pda.infer.predict import _tiled_punet_probs
    from pda.parallel import get_mesh_2d

    model, _ = pda_punet(consensus_masking=True)
    image = TP._spec(2)["tiles"][frame][0]
    key = jax.random.PRNGKey(10 + list(TP.TILE_FRAMES).index(frame))
    ref = np.asarray(_tiled_punet_probs(model, _pda_params(), jnp.asarray(image.numpy()), key,
                                        TP.TILE_N, TP.TILE_BLOCK, TP.TILE_HALO,
                                        mesh=get_mesh_2d(1, 2)))
    for res in tiles:
        out = res["tiles"][frame]
        assert out.shape == (*TP.TILE_FRAMES[frame], 1)
        _close(out.numpy(), ref, TILE_TOL, frame)
