"""The port's checkpoints, plateau controller, train state and the engine's
own rules, on the CPU: ``ReduceLROnPlateau`` against ``pda``'s; the ``.pt``
round trip (bit-exact) and the files ``pda.models.convert`` reads; atomic
writes; ``latest`` recording the current best; resuming; warm starts into
the student and the teacher; and what the engine refuses."""

import os

import numpy as np
import pytest
import torch

from pda.models.convert import (convert_punet_state_dict, convert_unet_state_dict,
                                load_torch_checkpoint, load_torch_unet_checkpoint)
from pda.train.optim import ReduceLROnPlateau as JPlateau
from pda_torch import train as ttrain
from pda_torch.data import DualImageCollectionDataset, ImageCollectionDataset, Loader
from pda_torch.data.synthetic import make_dataset_arrays
from pda_torch.models import ProbabilisticUnet, UNet2d
from pda_torch.train import ReduceLROnPlateau, adam, create_train_state
from torch_port_utils import FILTERS, LATENT

# -- the plateau controller --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("patience", [0, 2, 10])
def test_plateau_matches_pda(seed, patience):
    rng = np.random.default_rng(seed)
    metrics = np.abs(1.0 + np.cumsum(rng.normal(scale=0.05, size=60))).tolist()
    metrics[20:35] = [metrics[19] * (1 - 5e-5)] * 15  # improvements below the threshold
    port, ref = ReduceLROnPlateau(patience=patience), JPlateau(patience=patience)
    lr_port = lr_ref = 1e-3
    for m in metrics:
        lr_port, lr_ref = port.step(m, lr_port), ref.step(m, lr_ref)
        assert lr_port == lr_ref
        assert port.state_dict() == ref.state_dict()
    assert lr_port < 1e-3  # it reduced


def test_plateau_reduces_below_torchs_eps():
    """Below about 1e-7 a 0.9 reduction is smaller than 1e-8, which torch's
    own scheduler skips (its ``eps``); pda's controller, and the port's,
    keep reducing."""
    port, ref = ReduceLROnPlateau(patience=0, min_lr=1e-12), JPlateau(patience=0, min_lr=1e-12)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=5e-8)
    torch_sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, factor=0.9, patience=0)
    lr_port = lr_ref = 5e-8
    for _ in range(5):
        lr_port, lr_ref = port.step(1.0, lr_port), ref.step(1.0, lr_ref)
        torch_sched.step(1.0)
    assert lr_port == lr_ref == pytest.approx(5e-8 * 0.9 ** 4, rel=1e-12)
    assert opt.param_groups[0]["lr"] == 5e-8  # torch's scheduler parts from pda here


def test_plateau_state_round_trip():
    a = ReduceLROnPlateau(patience=3)
    for m in (1.0, 1.0, 0.5, 0.6):
        a.step(m, 1e-3)
    b = ReduceLROnPlateau(patience=3)
    b.load_state_dict(a.state_dict())
    assert b.state_dict() == a.state_dict() == {"best": 0.5, "num_bad_epochs": 1}


def test_train_state_learning_rate_reads_and_sets_every_group():
    m = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam([{"params": [m.weight]}, {"params": [m.bias]}], lr=1e-4)
    state = create_train_state(m, opt)
    assert state.learning_rate == 1e-4
    assert state.replace_lr(3e-5) is state
    assert [g["lr"] for g in opt.param_groups] == [3e-5, 3e-5]


def test_create_train_state_takes_the_teacher():
    student, other = _punet(), _punet(seed=5)
    opt = adam(student.parameters(), 1e-5)
    copied = create_train_state(student, opt, with_teacher=True)
    given = create_train_state(student, opt, with_teacher=True, teacher=other.state_dict())
    for name, v in student.state_dict().items():
        assert torch.equal(copied.teacher.state_dict()[name], v)
        assert torch.equal(given.teacher.state_dict()[name], other.state_dict()[name])
    assert not any(p.requires_grad for p in given.teacher.parameters())
    assert create_train_state(student, opt, teacher=other.state_dict()).teacher is None


# -- small trainers ----------------------------------------------------------------


def _punet(seed=0):
    return ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3,
                             beta=1.0, rl_swap=True, consensus_masking=True,
                             generator=torch.Generator().manual_seed(seed))


def _loaders(dual: bool, n: int = 4):
    raws, labels = make_dataset_arrays(3, (48, 48), seed=2)
    if dual:
        std = lambda x, rng: (x - x.mean()) / (x.std() + 1e-7)  # noqa: E731
        make = lambda k, s: DualImageCollectionDataset(  # noqa: E731
            raws, labels, patch_shape=(32, 32), augmentation1=std, augmentation2=std,
            n_samples=k, seed=s)
    else:
        make = lambda k, s: ImageCollectionDataset(raws, labels, patch_shape=(32, 32),  # noqa: E731
                                                   n_samples=k, seed=s)
    return Loader(make(n, 0), 2, seed=0), Loader(make(2, 1), 2, seed=1)


def _mt(root, name="mt", **kw):
    return ttrain.MeanTeacherTrainer(name, _punet(), *_loaders(True), save_root=str(root),
                                     device="cpu", logger=False, do_consensus_masking=True,
                                     lr_scheduler=ReduceLROnPlateau(patience=0), **kw)


def _adam_state(opt):
    return {k: v for k, v in opt.state_dict()["state"].items()}


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    t = _mt(tmp_path)
    t.fit(4)
    t2 = _mt(tmp_path)
    blob = t2.load_checkpoint("latest")
    assert t2._iteration == t._iteration == blob["iteration"] == 4
    assert t2._best_metric == t._best_metric and t2._train_time == t._train_time
    for a, b in ((t.state.model, t2.state.model), (t.state.teacher, t2.state.teacher)):
        for (name, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), name
    s1, s2 = _adam_state(t.state.optimizer), _adam_state(t2.state.optimizer)
    assert sorted(s1) == sorted(s2) and s1
    for k in s1:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[k][key], s2[k][key]), (k, key)
    assert t2.lr_scheduler.state_dict() == t.lr_scheduler.state_dict()
    assert t2.state.learning_rate == t.state.learning_rate
    assert torch.equal(t2.generator.get_state(), t.generator.get_state())
    assert torch.equal(t2.panel_generator.get_state(), t.panel_generator.get_state())
    assert sorted(blob) == sorted([
        "model_state", "optimizer_state", "iteration", "best_metric", "current_metric",
        "train_time", "teacher_state", "scheduler_state", "generator_state",
        "panel_generator_state"])


def test_pda_reads_port_punet_checkpoints(tmp_path):
    """``load_torch_checkpoint`` reads a port ``best.pt``, student and
    teacher, to the tree the port's weights convert to."""
    t = _mt(tmp_path)
    t.fit(2)
    path = os.path.join(t.ckpt_dir, "best.pt")
    for key, module in (("model_state", t.state.model), ("teacher_state", t.state.teacher)):
        got = load_torch_checkpoint(path, key=key, num_filters=FILTERS)
        want = convert_punet_state_dict(module.state_dict(), num_filters=FILTERS,
                                        no_convs_fcomb=3)
        _assert_same_tree(got, want)


def test_pda_reads_port_unet_checkpoints(tmp_path):
    model = UNet2d(depth=2, initial_features=4, generator=torch.Generator().manual_seed(1))
    t = ttrain.UNetTrainer("unet", model, *_loaders(False), save_root=str(tmp_path),
                           device="cpu", logger=False)
    t.fit(2)
    got = load_torch_unet_checkpoint(os.path.join(t.ckpt_dir, "best.pt"), depth=2)
    _assert_same_tree(got, convert_unet_state_dict(model.state_dict(), depth=2))


def _assert_same_tree(got, want):
    import jax

    def leaves(tree):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves the previous file and no tmp file."""
    t = _mt(tmp_path)
    t.fit(2)
    path = os.path.join(t.ckpt_dir, "latest.pt")
    before = open(path, "rb").read()

    def broken(obj, f, *a, **k):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        t.save_checkpoint("latest", 0.1)
    assert open(path, "rb").read() == before
    assert sorted(os.listdir(t.ckpt_dir)) == ["best.pt", "latest.pt"]


def test_latest_records_the_current_best(tmp_path):
    """An epoch worse than the best: latest holds its metric as current and
    the earlier best as best; best.pt stays the earlier epoch's."""
    t = ttrain.PUNetTrainer("p", _punet(), *_loaders(False), save_root=str(tmp_path),
                            device="cpu", logger=False)
    metrics = iter([0.5, 0.7])
    t.validate = lambda: {"metric": next(metrics)}
    t.fit(4)
    latest = ttrain.load_checkpoint(t.ckpt_dir, which="latest")
    best = ttrain.load_checkpoint(t.ckpt_dir, which="best")
    assert (latest["iteration"], latest["current_metric"], latest["best_metric"]) == (4, 0.7, 0.5)
    assert (best["iteration"], best["current_metric"], best["best_metric"]) == (2, 0.5, 0.5)


def test_fit_resumes_from_latest(tmp_path):
    t = _mt(tmp_path)
    t.fit(2)
    t2 = _mt(tmp_path)
    stats = t2.fit(4, overwrite_training=False)
    assert stats["iterations"] == t2._iteration == t2.state.step == 4
    assert [i for i, _ in t2.history] == [2, 3]
    assert [i for i, _ in t2.val_history] == [4]
    t3 = _mt(tmp_path)  # overwrite_training=True starts again
    t3.fit(2)
    assert [i for i, _ in t3.history] == [0, 1]


def test_warm_start_into_student_and_teacher(tmp_path):
    src = ttrain.PUNetTrainer("src", _punet(seed=3), *_loaders(False), save_root=str(tmp_path),
                              device="cpu", logger=False)
    src.fit(2)
    best = os.path.join(src.ckpt_dir, "best.pt")
    want = torch.load(best, weights_only=True)["model_state"]
    t = _mt(tmp_path, ckpt_model=best, ckpt_teacher=src.ckpt_dir)
    t.initialize()
    for module in (t.state.model, t.state.teacher):
        for name, v in module.state_dict().items():
            assert torch.equal(v, want[name]), name
    mt = _mt(tmp_path, name="mt2")
    mt.fit(2)
    t.warm_start(os.path.join(mt.ckpt_dir, "latest.pt"), into_teacher=True,
                 from_key="teacher_state")
    for name, v in t.state.teacher.state_dict().items():
        assert torch.equal(v, mt.state.teacher.state_dict()[name]), name


def test_trainer_refuses_what_the_port_lacks(tmp_path, monkeypatch):
    args = ("x", _punet(), *_loaders(False))
    with pytest.raises(NotImplementedError, match="M11"):
        ttrain.PUNetTrainer(*args, mesh=object(), device="cpu")
    # mixed precision is pda's bf16 compute now: float32 parameters stay
    mixed = ttrain.PUNetTrainer("x", _punet(), *_loaders(False), mixed_precision=True,
                                device="cpu")
    assert mixed.model.dtype == torch.bfloat16
    assert {p.dtype for p in mixed.model.parameters()} == {torch.float32}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain.PUNetTrainer(*args)  # device="cuda" by default
    empty = Loader(ImageCollectionDataset([], [], patch_shape=(32, 32)), 2)
    t = ttrain.PUNetTrainer("x", _punet(), empty, empty, device="cpu", logger=False,
                            save_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="zero batches"):
        t.fit(2)


def test_throughput_and_trace(tmp_path):
    tp = ttrain.Throughput(torch.device("cpu"))
    tp.update(2)
    tp.update(2)
    tp.stop()
    s = tp.summary()
    assert s["steps"] == 2 and s["samples"] == 4 and s["patches_per_sec"] > 0
    with ttrain.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.listdir(tmp_path / "trace")
