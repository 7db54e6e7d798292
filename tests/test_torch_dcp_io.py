"""The port's DCP checkpoints (pda_torch/train/dcp_io.py, the counterpart of
``pda/train/orbax_io.py``) on the CPU:

  * a round trip in one process restores what ``load_checkpoint`` of the
    ``.pt`` file of the same state restores, bit for bit: student, teacher,
    Adam's moments and steps and its param groups, the iteration, extra
    (the generators' and the plateau controller's states);
  * resume: a small Mean Teacher trainer's ``fit(2)``, ``save_dcp``, a
    fresh trainer's ``load_dcp`` and ``fit(4)`` equal an unbroken
    ``fit(4)`` bit for bit (losses, weights, teacher, Adam, generators);
  * a save replaces an older checkpoint in its directory (one of a larger
    world's files included), and saving leaves a fresh optimizer as it was;
    a state of other parameters is refused;
  * a gloo world of 2 (``tests/torch_dp_worker.py``) restores what one
    process wrote, and one process restores what the world wrote, whose
    files hold one copy of the state, not one a rank;
  * the module imports nothing of ``jax``, ``orbax`` or ``pda``.
"""

import os
import subprocess
import sys

import pytest
import torch

import torch_dp_worker as W
from pda_torch import train as ttrain
from pda_torch.data import DualImageCollectionDataset, Loader
from pda_torch.data.synthetic import make_dataset_arrays
from pda_torch.models import ProbabilisticUnet
from pda_torch.train import ReduceLROnPlateau
from pda_torch.train.checkpoint import restore_state
from pda_torch.train.dcp_io import load_dcp, save_dcp
from torch_port_utils import FILTERS, LATENT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3, beta=1.0, rl_swap=True)


def _spec():
    model = ProbabilisticUnet(**CFG, generator=torch.Generator().manual_seed(0))
    return {"punet_cfg": CFG, "punet_state": model.state_dict()}


def assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if torch.is_tensor(v):
            w = got[k]
            assert torch.is_tensor(w) and w.dtype == v.dtype and w.device == v.device, k
            assert torch.equal(w, v), k
        else:
            assert got[k] == v, k


# -- one process ---------------------------------------------------------------------


def test_round_trip_equals_the_pt_path(tmp_path):
    state, extra = W.dcp_state(_spec())
    ttrain.save_checkpoint(str(tmp_path / "pt"), state, extra=extra)
    save_dcp(str(tmp_path / "dcp"), state, extra=extra)

    by_pt, _ = W.dcp_state(_spec(), fresh=True)
    blob = ttrain.load_checkpoint(str(tmp_path / "pt"), which="latest")
    restore_state(by_pt, blob)
    by_dcp, _ = W.dcp_state(_spec(), fresh=True)
    got_extra = {}
    assert load_dcp(str(tmp_path / "dcp"), by_dcp, extra=got_extra) is by_dcp

    want = W.state_tensors(by_pt, {k: blob[k] for k in extra})
    assert_same(W.state_tensors(by_dcp, got_extra), want)
    assert_same(want, W.state_tensors(state, extra))
    assert isinstance(got_extra["scheduler_state"]["num_bad_epochs"], int)


def test_save_replaces_an_older_checkpoint(tmp_path):
    spec, path = _spec(), str(tmp_path / "ckpt")
    old, _ = W.dcp_state(spec, fresh=True)
    save_dcp(path, old, extra={"note": "old", "stale": 1})
    with open(os.path.join(path, "__1_0.distcp"), "wb") as f:  # a larger world's file
        f.write(b"stale")
    state, extra = W.dcp_state(spec)
    assert save_dcp(path, state, extra=extra) == os.path.abspath(path)
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    assert not os.path.exists(path + ".tmp")
    got, got_extra = W.dcp_state(spec, fresh=True)
    load_dcp(path, got, extra=got_extra)
    assert_same(W.state_tensors(got, got_extra), W.state_tensors(state, extra))


def test_saving_leaves_a_fresh_optimizer_as_it_was(tmp_path):
    """No step is taken to make Adam's state (as ``torch.distributed.
    checkpoint.state_dict`` does for an optimizer without one)."""
    spec = _spec()
    state, _ = W.dcp_state(spec, fresh=True)
    before = W.state_tensors(state, {})
    save_dcp(str(tmp_path / "c"), state)
    assert not state.optimizer.state and all(p.grad is None for p in state.model.parameters())
    assert_same(W.state_tensors(state, {}), before)
    loaded, _ = W.dcp_state(_spec())  # a state with Adam's moments takes the empty state
    load_dcp(str(tmp_path / "c"), loaded)
    assert not loaded.optimizer.state and loaded.step == 0


def test_a_state_of_other_parameters_is_refused(tmp_path):
    state, extra = W.dcp_state(_spec())
    save_dcp(str(tmp_path / "c"), state, extra=extra)
    other = ProbabilisticUnet(**{**CFG, "num_filters": (4, 8, 12)})
    target = ttrain.create_train_state(other, ttrain.adam(other.parameters(), 1e-3),
                                       with_teacher=True)
    with pytest.raises(KeyError, match="holds another model"):
        load_dcp(str(tmp_path / "c"), target)


# -- resume -------------------------------------------------------------------------


def _loaders():
    raws, labels = make_dataset_arrays(3, (48, 48), seed=2)
    std = lambda x, rng: (x - x.mean()) / (x.std() + 1e-7)  # noqa: E731

    def make(k, s):
        return DualImageCollectionDataset(raws, labels, patch_shape=(32, 32), augmentation1=std,
                                          augmentation2=std, n_samples=k, seed=s)

    return Loader(make(4, 0), 2, seed=0), Loader(make(2, 1), 2, seed=1)


def _mt(root, loaders=None):
    model = ProbabilisticUnet(**CFG, consensus_masking=True,
                              generator=torch.Generator().manual_seed(0))
    return ttrain.MeanTeacherTrainer("mt", model, *(loaders or _loaders()), save_root=str(root),
                                     device="cpu", logger=False, do_consensus_masking=True,
                                     lr_scheduler=ReduceLROnPlateau(patience=0))


def _extra(t) -> dict:
    """What a trainer's checkpoint holds beside its state (``Trainer.
    save_checkpoint``'s extra and its metrics)."""
    return {"generator_state": t.generator.get_state(),
            "panel_generator_state": t.panel_generator.get_state(),
            "scheduler_state": t.lr_scheduler.state_dict(),
            "best_metric": t._best_metric, "train_time": t._train_time}


def _restore(t, extra):
    """``Trainer.load_checkpoint``'s restore from a DCP checkpoint's extra."""
    t._iteration = t.state.step
    t._best_metric, t._train_time = extra["best_metric"], extra["train_time"]
    t.lr_scheduler.load_state_dict(extra["scheduler_state"])
    t.generator.set_state(extra["generator_state"])
    t.panel_generator.set_state(extra["panel_generator_state"])


def test_resume_through_dcp_equals_an_unbroken_fit(tmp_path):
    unbroken = _mt(tmp_path / "a")
    unbroken.fit(4)

    first = _mt(tmp_path / "b")
    first.fit(2)
    save_dcp(str(tmp_path / "dcp"), first.state, extra=_extra(first))
    # the loaders' position, which no checkpoint holds (nor pda's), as the
    # unbroken run's after its first epoch: the trainer's set-up draws one
    # batch of the train loader's next epoch, as pda draws one to initialize
    train, val = _loaders()
    train._epoch, val._epoch = 1, 1
    resumed = _mt(tmp_path / "c", (train, val))
    resumed.initialize()
    extra = {}
    load_dcp(str(tmp_path / "dcp"), resumed.state, extra=extra)
    _restore(resumed, extra)
    assert resumed._iteration == 2
    resumed.fit(4)

    assert [i for i, _ in resumed.history] == [2, 3]
    assert [h for _, h in resumed.history] == [h for _, h in unbroken.history[2:]]
    assert resumed.val_history == unbroken.val_history[1:]
    got, want = (W.state_tensors(t.state, _extra(t)) for t in (resumed, unbroken))
    assert got.pop("extra.train_time") > 0 and want.pop("extra.train_time") > 0  # wall clock
    assert_same(got, want)


# -- a gloo world of 2 ----------------------------------------------------------------


def _bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if f.endswith(".distcp"))


def test_a_world_of_two_and_one_process_read_each_others(tmp_path):
    spec = _spec()
    state, extra = W.dcp_state(spec)
    want = W.state_tensors(state, extra)
    one = save_dcp(str(tmp_path / "dcp_one"), state, extra=extra)
    ranks = W.spawn(2, W.copy_spec(spec, ["dcp"]), str(tmp_path))
    for r in ranks:  # each rank restored what one process wrote
        assert_same(r["dcp"]["loaded"], want)
    world = str(tmp_path / "dcp_world")
    assert sorted(os.listdir(world)) == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    # one copy of the replicated state, its items shared out between the ranks
    assert all(os.path.getsize(os.path.join(world, f)) > 0 for f in os.listdir(world))
    assert _bytes(world) <= 1.05 * _bytes(one)
    got, got_extra = W.dcp_state(spec, fresh=True)
    load_dcp(world, got, extra=got_extra)
    assert_same(W.state_tensors(got, got_extra), want)


def test_dcp_io_imports_no_jax_orbax_or_pda(tmp_path):
    code = ("import sys, torch\n"
            "from pda_torch.train.dcp_io import load_dcp, save_dcp\n"
            "from pda_torch.train import adam, create_train_state\n"
            "m = torch.nn.Linear(3, 2)\n"
            "s = create_train_state(m, adam(m.parameters(), 1e-3))\n"
            f"save_dcp({str(tmp_path / 'c')!r}, s)\n"
            f"load_dcp({str(tmp_path / 'c')!r}, s)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'orbax', 'pda'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
