"""The port's LIVECell experiment CLIs (pda_torch/experiments/) against
``pda``'s (experiments/LIVECell/*.py, pda/experiments/) on the CPU: the
parsers, checkpoint naming, ``--mesh``, the augmentation recipes, and for
every CLI what its --train, --predict and --evaluate phases ask of the
trainers, loaders and prediction and dice runners (both sides' runners
replaced by recorders, over a two-type LIVECell tree); prepare_data's label
files; and one real source run on the CPU at tiny width."""

import argparse
import importlib
import importlib.util
import os
import runpy
import sys
import urllib.request

import numpy as np
import pytest
import torch

import pda.experiments.common as jcommon
import pda.experiments.livecell_da as jda
import pda_torch.experiments.common as tcommon
import pda_torch.experiments.livecell_da as tda
from pda_torch.data import tiff
from pda_torch.data.synthetic import write_livecell_tree
from torch_port_utils import numpy_augs

REPO = os.path.join(os.path.dirname(__file__), "..")
SCRIPTS = os.path.join(REPO, "experiments", "LIVECell")
CELLS = ("A172", "BT474")
# pda's script -> the port's module
CLIS = {"livecell_punet": "livecell_punet", "livecell_punet_target": "livecell_punet_target",
        "livecell_unet": "livecell_unet", "livecell_mt": "livecell_mt",
        "livecell_fm": "livecell_fm", "livecell_adamt": "livecell_adamt",
        "livecell_adamatch": "livecell_adamatch", "prepare_data": "livecell_prepare_data"}
THIN = ("livecell_mt", "livecell_fm", "livecell_adamt", "livecell_adamatch")


def port_cli(name):
    return importlib.import_module(f"pda_torch.experiments.{CLIS[name]}")


@pytest.fixture(autouse=True)
def _no_fetch(monkeypatch):
    def refuse(url, path):
        raise OSError(f"this test fetches nothing ({url})")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


class _Parsed(Exception):
    pass


def pda_parser(script):
    """The parser ``experiments/LIVECell/<script>.py`` builds when run."""
    captured = []

    def parse_args(self, args=None, namespace=None):
        captured.append(self)
        raise _Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        mp.setattr(sys, "argv", [script])
        with pytest.raises(_Parsed):
            runpy.run_path(os.path.join(SCRIPTS, script + ".py"), run_name="__main__")
    return captured[0]


def options(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, type(a).__name__, a.type,
                   a.const) for a in parser._actions if a.dest != "help")


@pytest.mark.parametrize("script", sorted(CLIS))
def test_cli_parsers_match_pda(script):
    assert options(port_cli(script).get_parser()) == options(pda_parser(script))


@pytest.mark.parametrize("extra", [(), ("consensus",), ("pseudo",), ("type",),
                                   ("consensus", "pseudo"), ("consensus", "type"),
                                   ("pseudo", "type"), ("consensus", "pseudo", "type")])
def test_standard_parser_matches_pda(extra):
    assert options(tcommon.standard_parser("d", extra)) == options(jcommon.standard_parser("d", extra))


def test_da_name_and_mesh(monkeypatch):
    for method in ("mean-teacher", "fixmatch", "adamt", "adamatch"):
        for consensus in (False, True):
            for masking in (False, True):
                assert (tcommon.da_name(method, "livecell", "A172", "BT474", consensus, masking)
                        == jcommon.da_name(method, "livecell", "A172", "BT474", consensus,
                                           masking))
    args = argparse.Namespace(mesh=None)
    monkeypatch.delenv("PDA_MESH", raising=False)
    assert tcommon.mesh_from_arg(args) is None is jcommon.mesh_from_arg(args)
    # --mesh gives a mesh over torch.distributed: without a launcher a world
    # of 1; data=N > 1 and data=N,space=M say how to launch N (N x M) ranks
    mesh = tcommon.mesh_from_arg(argparse.Namespace(mesh="auto"), "cpu")
    try:
        assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
    finally:
        mesh.destroy()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tcommon.mesh_from_arg(argparse.Namespace(mesh="data=2"), "cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4 .* --mesh data=2,space=2"):
        tcommon.mesh_from_arg(argparse.Namespace(mesh="data=2,space=2"), "cpu")
    # the domain-adaptation CLIs raise before they read anything
    monkeypatch.setattr(tda, "livecell_punet", FakeModel.factory)
    for name in THIN:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            port_cli(name).main(["--train", "--mesh", "data=2"], cell_types=CELLS, device="cpu")
    for name in ("livecell_punet", "livecell_unet"):  # their own --mesh option
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            port_cli(name).main(["--train", "--mesh", "data=2"], cell_types=CELLS, device="cpu")


@pytest.mark.parametrize("recipe", ["weak_augmentations", "fm_strong_augmentations",
                                    "adamatch_strong_augmentations",
                                    "mitoem_strong_augmentations"])
def test_augmentation_recipes_match_pda(recipe):
    x = np.random.default_rng(0).normal(3.0, 2.0, size=(40, 48)).astype(np.float32)
    with numpy_augs():
        port, ref = getattr(tcommon, recipe)(), getattr(jcommon, recipe)()
        for seed in range(6):
            a = port(x.copy(), np.random.default_rng(seed))
            b = ref(x.copy(), np.random.default_rng(seed))
            assert a.dtype == b.dtype and np.array_equal(a, b), seed


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------


def _recipe(aug):
    """What a recipe makes of a fixed patch with a fixed generator."""
    if aug is None:
        return None
    x = np.random.default_rng(1).normal(2.0, 3.0, size=(24, 24)).astype(np.float32)
    out = np.asarray(aug(x, np.random.default_rng(2)))
    return out.dtype.str, out.shape, out.tobytes()


class FakeModel:
    """The port's model in the recorder runs: its flags, the weights loaded."""

    def __init__(self, consensus_masking=False, device="cuda"):
        self.consensus_masking = consensus_masking
        self.loaded = None

    @classmethod
    def factory(cls, consensus_masking=False, generator=None, device="cuda"):
        return cls(consensus_masking, device)

    def load_state_dict(self, weights):
        self.loaded = weights


WEIGHTS = {"params": "student", "model_state": "student", "teacher_params": "teacher",
           "teacher_state": "teacher"}


class Recorder:
    """Recorders for one side's trainers, loader factories, prediction and
    dice runners; everything lands in ``self.log`` in call order."""

    def __init__(self):
        self.log = []

    def factory(self, real, name):
        def wrapped(*args, **kw):
            loader = real(*args, **kw)
            ds = loader.dataset
            self.log.append(("loader", name, kw.get("split"), tuple(kw.get("patch_shape")),
                             kw.get("batch_size"), tuple(kw.get("cell_types") or ()),
                             kw.get("binary"), kw.get("label_path"), kw.get("download"),
                             _recipe(kw.get("augmentation1")), _recipe(kw.get("augmentation2")),
                             tuple(ds.raw_images), tuple(ds.label_images),
                             tuple(getattr(ds, "consensus_masks", None) or ())))
            return loader
        return wrapped

    def trainer(self, cls_name):
        rec = self
        joint = cls_name in ("AdaMTTrainer", "AdaMatchTrainer")
        names = (("name", "model", "source_train_loader", "target_train_loader", "val_loader")
                 if joint else ("name", "model", "train_loader", "val_loader"))

        class Trainer:
            def __init__(self, *args, **kw):
                kw.update(zip(names, args))
                sched = kw.get("lr_scheduler")
                dist = kw.get("source_distribution")
                rec.log.append((
                    "trainer", cls_name, kw["name"], kw.get("learning_rate"),
                    None if sched is None else (sched.factor, sched.patience),
                    kw.get("log_image_interval"),
                    bool(getattr(kw["model"], "consensus_masking", False)),
                    kw.get("do_consensus_masking"),
                    *[None if kw.get(k) is None else
                      (os.path.dirname(kw[k]), os.path.splitext(os.path.basename(kw[k]))[0])
                      for k in ("ckpt_model", "ckpt_teacher")],
                    None if dist is None else tuple(round(float(v), 12) for v in dist)))

            def fit(self, iterations, **kw):
                rec.log.append(("fit", iterations))

        Trainer.__name__ = cls_name
        return Trainer

    def load_params(self, ckpt, *template, key=None, **kw):
        key = key or ("params" if template else "model_state")
        self.log.append(("load", ckpt, WEIGHTS[key]))
        return {"weights": WEIGHTS[key]}

    @staticmethod
    def _weights(model, params):
        return (params[0] if params else model.loaded)["weights"]

    def punet_prediction(self, inp, out, model, *params, prior_samples=8, **kw):
        os.makedirs(out, exist_ok=True)
        self.log.append(("predict", inp, out, prior_samples, self._weights(model, params)))

    def punet_pseudo_prediction(self, inp, out, model, *params, prior_samples=8, cellname=None,
                                split_name=None, **kw):
        """Records, and writes the pseudo-label tree the target loaders read."""
        self.log.append(("pseudo", inp, out, prior_samples, cellname, split_name,
                         self._weights(model, params)))
        folder = os.path.join(inp, cellname)
        for kind in ("annotations", "consensus"):
            os.makedirs(os.path.join(out, kind, split_name, cellname), exist_ok=True)
        for name in sorted(os.listdir(folder)):
            tiff.imwrite(os.path.join(out, "annotations", split_name, cellname, name),
                         np.full((16, 16), 0.75, np.float32))
            tiff.imwrite(os.path.join(out, "consensus", split_name, cellname, name),
                         np.ones((16, 16), np.uint8))

    def unet_prediction(self, inp, out, model, *params, **kw):
        os.makedirs(out, exist_ok=True)
        self.log.append(("unet_predict", inp, out, self._weights(model, params)))

    def dice(self, gt, pred, *a, **kw):
        self.log.append(("dice", gt, pred))
        return 0.5


TRAINERS = ("PUNetTrainer", "PseudoTrainerPUNet", "UNetTrainer", "MeanTeacherTrainer",
            "FixMatchTrainer", "AdaMTTrainer", "AdaMatchTrainer")
FACTORIES = ("get_livecell_loader", "get_my_livecell_loader", "get_dual_livecell_loader")


def _instrument(mp, mod, rec, side):
    """Swap ``mod``'s trainers, runners and checkpoint lookups for ``rec``'s."""
    for name in TRAINERS:
        if hasattr(mod, name):
            mp.setattr(mod, name, rec.trainer(name))
    for name in FACTORIES:
        if hasattr(mod, name):
            mp.setattr(mod, name, rec.factory(getattr(mod, name), name))
    for name, fn in (("punet_prediction", rec.punet_prediction),
                     ("punet_pseudo_prediction", rec.punet_pseudo_prediction),
                     ("unet_prediction", rec.unet_prediction),
                     ("run_dice_evaluation", rec.dice), ("load_params", rec.load_params)):
        if hasattr(mod, name):
            mp.setattr(mod, name, fn)
    mp.setattr(mod, "checkpoint_exists", lambda *a, **k: True)
    if side == "pda":
        mp.setattr(mod, "CELL_TYPES", list(CELLS))
        if hasattr(mod, "init_params_cpu"):
            mp.setattr(mod, "init_params_cpu", lambda *a, **k: {})
    else:
        if hasattr(mod, "livecell_punet"):
            mp.setattr(mod, "livecell_punet", FakeModel.factory)
        if hasattr(mod, "make_model"):
            mp.setattr(mod, "make_model", lambda device="cuda": FakeModel(False, device))


def _load_script(script):
    spec = importlib.util.spec_from_file_location(f"_pda_livecell_{script}",
                                                  os.path.join(SCRIPTS, script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _side_root(tmp_path, side):
    """A two-type LIVECell tree at ./data/livecell/ of the side's directory,
    and one exported source pseudo-label (FixMatch aligns that pair)."""
    root = tmp_path / side
    write_livecell_tree(str(root / "data" / "livecell"), CELLS, shape=(24, 32), seed=4)
    for pred in ("predictions", os.path.join("predictions", "livecell")):
        folder = root / pred / "punet_source_predictions" / "BT474" / "annotations"
        folder = folder / "livecell_train_val_images" / "A172"
        folder.mkdir(parents=True)
        tiff.imwrite(str(folder / "a.tif"),
                     np.random.default_rng(9).random((24, 32)).astype(np.float32))
    return root


def run_pda(script, flags, tmp_path):
    rec = Recorder()
    os.chdir(_side_root(tmp_path, "pda"))
    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        if script in THIN:
            _instrument(mp, jda, rec, "pda")
            mp.setattr(sys, "argv", [script] + flags)
            runpy.run_path(os.path.join(SCRIPTS, script + ".py"), run_name="__main__")
        else:
            mod = _load_script(script)
            _instrument(mp, mod, rec, "pda")
            mod.main(pda_parser(script).parse_args(flags))
    return rec.log


def run_port(script, flags, tmp_path):
    rec = Recorder()
    os.chdir(_side_root(tmp_path, "port"))
    cli = port_cli(script)
    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        _instrument(mp, tda if script in THIN else cli, rec, "port")
        cli.main(flags, cell_types=CELLS, device="cpu")
    return rec.log


RECORDED = {
    "livecell_punet": ["--train", "--predict", "--evaluate", "--iterations", "3"],
    "livecell_punet_target": ["--get_pseudo_labels", "--train", "--predict", "--evaluate",
                              "--consensus", "--iterations", "3"],
    "livecell_unet": ["--train", "--predict", "--evaluate"],
    "livecell_mt": ["--train", "--predict", "--evaluate", "--masking"],
    "livecell_fm": ["--train", "--predict", "--evaluate", "--consensus"],
    "livecell_fm-no-alignment": ["--train", "--no_distribution_alignment", "--iterations", "5"],
    "livecell_adamt": ["--train", "--predict", "--evaluate"],
    "livecell_adamatch": ["--train", "--predict", "--evaluate", "--consensus", "--masking"],
}


@pytest.mark.parametrize("case", sorted(RECORDED))
def test_cli_phases_match_pda(case, tmp_path, monkeypatch):
    """The same trainers (class, run name, learning rate, plateau, image
    interval, consensus and masking, warm starts, source distribution), the
    same loaders (split, patch, batch, cell types, recipes, image and label
    paths), the same fit budgets, predictions (globs, outputs, MC samples,
    student or teacher weights) and dice runs, in the same order."""
    monkeypatch.chdir(tmp_path)
    script = case.split("-")[0]
    ref = run_pda(script, RECORDED[case], tmp_path)
    port = run_port(script, RECORDED[case], tmp_path)
    assert port == ref
    kinds = {entry[0] for entry in port}
    assert {"trainer", "fit", "loader"} <= kinds
    if "--predict" in RECORDED[case]:
        assert {"predict", "dice"} <= kinds or {"unet_predict", "dice"} <= kinds


def test_prepare_data_matches_pda(tmp_path, monkeypatch):
    """The same label TIFFs from pda's prepare_data.py and the port's."""
    roots = {}
    for side in ("pda", "port"):
        roots[side] = str(tmp_path / side)
        write_livecell_tree(roots[side], CELLS, shape=(24, 32), seed=5)
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", "--data", roots["pda"]])
    runpy.run_path(os.path.join(SCRIPTS, "prepare_data.py"), run_name="__main__")
    port_cli("prepare_data").main(["--data", roots["port"]], cell_types=CELLS)
    files = {side: sorted(os.path.relpath(os.path.join(d, f), roots[side])
                          for d, _, fs in os.walk(os.path.join(roots[side], "annotations"))
                          for f in fs) for side in roots}
    assert files["pda"] == files["port"] and len(files["port"]) == 2 * (4 + 1)
    for rel in files["port"]:
        a = tiff.imread(os.path.join(roots["port"], rel))
        b = tiff.imread(os.path.join(roots["pda"], rel))
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b)


def test_livecell_punet_runs_on_the_cpu(tmp_path, monkeypatch):
    """livecell_prepare_data, then livecell_punet --train --predict
    --evaluate --iterations 2 on the CPU, PUNet (4, 8, 12, 16), one cell
    type: checkpoints, one probability map per test frame, a dice value."""
    from pda_torch.data import loader
    from pda_torch.models import ProbabilisticUnet

    cli = port_cli("livecell_punet")
    write_livecell_tree(str(tmp_path / "data"), ("A172",), seed=6)

    def tiny(consensus_masking=False, generator=None, device="cuda"):
        return ProbabilisticUnet(num_filters=(4, 8, 12, 16), latent_dim=6, no_convs_fcomb=3,
                                 beta=1.0, rl_swap=True, consensus_masking=consensus_masking,
                                 generator=torch.Generator().manual_seed(0)).to(device)

    dice = []

    def recording_dice(*a, **k):
        dice.append(run_dice(*a, **k))
        return dice[-1]

    run_dice = cli.run_dice_evaluation
    monkeypatch.setattr(cli, "livecell_punet", tiny)
    monkeypatch.setattr(cli, "run_dice_evaluation", recording_dice)
    monkeypatch.setattr(loader, "_cores", lambda: 1)  # sample inline
    port_cli("prepare_data").main(["--data", str(tmp_path / "data")], cell_types=("A172",))
    cli.main(["--train", "--predict", "--evaluate", "--iterations", "2",
              "--data", str(tmp_path / "data"), "--pred_path", str(tmp_path / "pred"),
              "--save_root", str(tmp_path / "save")], cell_types=("A172",), device="cpu")
    ckpt = tmp_path / "save" / "checkpoints" / "punet-source-livecell-A172"
    assert sorted(os.listdir(ckpt)) == ["best.pt", "latest.pt"]
    assert torch.load(ckpt / "latest.pt", weights_only=True)["iteration"] == 2
    preds = sorted((tmp_path / "pred" / "punet_source" / "A172" / "A172").iterdir())
    assert len(preds) == 1
    p = tiff.imread(str(preds[0]))
    assert p.dtype == np.float32 and p.shape == (520, 704)
    assert np.isfinite(p).all() and 0.0 <= p.min() and p.max() <= 1.0
    assert len(dice) == 1 and 0.0 <= dice[0] <= 1.0


@pytest.mark.parametrize("pattern", ["A172*.tif", "A172*", "*", "A172", "*.tif", "B*"])
def test_glob_images_matches_pda(pattern, tmp_path):
    """The shared image glob keeps pda's semantics (a matched folder expands
    to its images; a pattern that matches nothing finds nothing); only
    ``search_subfolders``, which the LIVECell source CLIs pass, searches one
    folder down."""
    from pda.infer.predict import _glob_images as pda_glob
    from pda_torch.infer.predict import _glob_images

    write_livecell_tree(str(tmp_path), CELLS, shape=(24, 32), seed=3)
    folder = os.path.join(str(tmp_path), "images", "livecell_test_images")
    path = os.path.join(folder, pattern)
    assert _glob_images(path) == pda_glob(path)
    deeper = _glob_images(path, search_subfolders=True)
    if pda_glob(path):
        assert deeper == pda_glob(path)
    else:
        assert deeper == sorted(p for ct in CELLS
                                for p in pda_glob(os.path.join(folder, ct, pattern)))
        assert deeper
