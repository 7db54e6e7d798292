"""The port's MitoEM experiment CLIs (pda_torch/experiments/mitoem_*.py)
against ``pda``'s (experiments/MitoEM/*.py, pda/experiments/mitoem_da.py) on
the CPU: the seven parsers; for every CLI what its --train, --predict and
--evaluate phases ask of the trainers, loader factories, prediction and dice
runners (both sides' runners replaced by recorders, each side in its own
directory over a converted synthetic MitoEM tree); prepare_data's volumes and
slices; and one real run (mitoem_prepare_data, then mitoem_punet --train
--predict --evaluate with the PUNet at (4, 8, 12, 16)) in a subprocess with
h5py, imageio and cv2 blocked. ``urlretrieve`` is patched to raise."""

import argparse
import importlib
import importlib.util
import json
import os
import runpy
import shutil
import subprocess
import sys
import urllib.request

import h5py
import numpy as np
import pytest

import pda.experiments.mitoem_da as jda
import pda_torch.experiments.mitoem_common as tmc
import pda_torch.experiments.mitoem_da as tda
from pda_torch.data import tiff
from pda_torch.data.builders import em as tem
from pda_torch.data.builders import prepare as tprep
from pda_torch.data.synthetic import write_mitoem_tree
from test_torch_experiments import FakeModel, Recorder, _recipe, options
from torch_port_utils import numpy_augs

REPO = os.path.join(os.path.dirname(__file__), "..")
SCRIPTS = os.path.join(REPO, "experiments", "MitoEM")
# pda's script -> the port's module
CLIS = {"mitoem_punet": "mitoem_punet", "mitoem_unet": "mitoem_unet", "mitoem_mt": "mitoem_mt",
        "mitoem_fm": "mitoem_fm", "mitoem_adamt": "mitoem_adamt",
        "mitoem_adamatch": "mitoem_adamatch", "prepare_data": "mitoem_prepare_data"}
THIN = ("mitoem_mt", "mitoem_fm", "mitoem_adamt", "mitoem_adamatch")
SHAPES = {"mitoem": (40, 48), "vnc": (40, 48), "lucchi": (40, 48), "urocell": (40, 48)}


def port_cli(name):
    return importlib.import_module(f"pda_torch.experiments.{CLIS[name]}")


@pytest.fixture(autouse=True)
def _no_fetch(monkeypatch):
    def refuse(url, path):
        raise OSError(f"this test fetches nothing ({url})")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def _pda_common():
    """experiments/MitoEM/common.py, as the scripts import it (``import common``)."""
    spec = importlib.util.spec_from_file_location("common", os.path.join(SCRIPTS, "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def pda_parser(script):
    """The parser ``experiments/MitoEM/<script>.py`` builds when run."""
    captured = []

    def parse_args(self, args=None, namespace=None):
        captured.append(self)
        raise _Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        mp.setattr(sys, "argv", [script])
        mp.setitem(sys.modules, "common", _pda_common())
        with pytest.raises(_Parsed):
            runpy.run_path(os.path.join(SCRIPTS, script + ".py"), run_name="__main__")
    return captured[0]


@pytest.mark.parametrize("script", sorted(CLIS))
def test_cli_parsers_match_pda(script):
    assert options(port_cli(script).get_parser()) == options(pda_parser(script))


def test_common_matches_pda():
    jc = _pda_common()
    assert tmc.EM_TYPES == jc.EM_TYPES == tda.EM_TYPES == jda.EM_TYPES
    assert tda.PRED_SUBDIR == jda.PRED_SUBDIR
    for em_type in tmc.EM_TYPES:
        for fn in ("em_input_glob", "em_gt_glob"):
            assert getattr(tmc, fn)("./d", em_type) == getattr(jc, fn)("./d", em_type)
    x = np.random.default_rng(0).normal(3.0, 2.0, size=(40, 48)).astype(np.float32)
    with numpy_augs():
        for recipe in ("my_weak_augmentations", "my_strong_augmentations"):
            a = getattr(tmc, recipe)()(x.copy(), np.random.default_rng(1))
            b = getattr(jc, recipe)()(x.copy(), np.random.default_rng(1))
            assert a.dtype == b.dtype and np.array_equal(a, b), recipe
    for consensus, masking in ((False, False), (True, False), (False, True), (True, True)):
        args = argparse.Namespace(consensus=consensus, masking=masking)
        assert tda._suffix(args) == jda._suffix(args)


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------


def _kw(value):
    if callable(value) and hasattr(value, "min_fraction"):
        return ("sampler", value.min_fraction)
    if callable(value):
        return _recipe(value)
    return tuple(value) if isinstance(value, list) else value


class EMRecorder(Recorder):
    """:class:`test_torch_experiments.Recorder` with the EM loader factories
    (their arguments, and each volume dataset's shape, labels and length)
    and the dice runner's ``subtype``."""

    def factory(self, real, name):
        def wrapped(*args, **kw):
            loader = real(*args, **kw)
            parts = getattr(loader.dataset, "datasets", [loader.dataset])
            self.log.append((
                "loader", name, args, tuple(sorted((k, _kw(v)) for k, v in kw.items())),
                len(loader.dataset),
                tuple((p.raw.shape, str(p.raw.dtype), p.labels is None, len(p),
                       p.sample_random_index) for p in parts)))
            return loader
        return wrapped

    def dice(self, gt, pred, *a, subtype=None, **kw):
        self.log.append(("dice", gt, pred, subtype))
        return 0.5


TRAINERS = ("PUNetTrainer", "UNetTrainer", "MeanTeacherTrainer", "FixMatchTrainer",
            "AdaMTTrainer", "AdaMatchTrainer")
FACTORIES = ("get_mitoem_loader", "get_vnc_mito_loader", "get_lucchi_loader",
             "get_uro_cell_loader")


def _instrument(mp, mod, rec, side):
    for name in TRAINERS:
        if hasattr(mod, name):
            mp.setattr(mod, name, rec.trainer(name))
    for name in FACTORIES:
        if hasattr(mod, name):
            mp.setattr(mod, name, rec.factory(getattr(mod, name), name))
    for name, fn in (("punet_prediction", rec.punet_prediction),
                     ("unet_prediction", rec.unet_prediction),
                     ("run_dice_evaluation", rec.dice), ("load_params", rec.load_params)):
        if hasattr(mod, name):
            mp.setattr(mod, name, fn)
    if hasattr(mod, "checkpoint_exists"):
        mp.setattr(mod, "checkpoint_exists", lambda *a, **k: True)
    if side == "pda":
        if hasattr(mod, "init_params_cpu"):
            mp.setattr(mod, "init_params_cpu", lambda *a, **k: {})
    else:
        if hasattr(mod, "mitoem_punet"):
            mp.setattr(mod, "mitoem_punet", FakeModel.factory)
        if hasattr(mod, "make_model"):
            mp.setattr(mod, "make_model", lambda device="cuda": FakeModel(False, device))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A small MitoEM-suite tree, converted by the port's prepare step."""
    root = str(tmp_path_factory.mktemp("mitoem") / "data")
    write_mitoem_tree(root, seed=5, shapes=SHAPES, mitoem_slices=(4, 2), vnc_slices=(4, 2),
                      lucchi_slices=(4, 2), urocell_volumes=4, urocell_depth=2, n_blobs=6)
    port_cli("prepare_data").main(["--data", root])
    return root


def _side_root(prepared, tmp_path, side):
    """The converted tree at ./data/ of the side's directory; pda's UroCell
    loader looks for the volumes one folder further down (the port's
    repaired lookup reads them where the prepare step wrote them)."""
    root = tmp_path / side
    shutil.copytree(prepared, root / "data")
    if side == "pda":
        uro = root / "data" / "urocell"
        (uro / "urocell").mkdir()
        for name in os.listdir(uro):
            if name.endswith(".h5"):
                shutil.copy(uro / name, uro / "urocell" / name)
    return root


def run_pda(script, flags, prepared, tmp_path):
    rec = EMRecorder()
    os.chdir(_side_root(prepared, tmp_path, "pda"))
    common = _pda_common()
    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "common", common)
        _instrument(mp, common, rec, "pda")
        if script in THIN:
            _instrument(mp, jda, rec, "pda")
            mp.setattr(sys, "argv", [script] + flags)
            runpy.run_path(os.path.join(SCRIPTS, script + ".py"), run_name="__main__")
        else:
            spec = importlib.util.spec_from_file_location(
                f"_pda_mitoem_{script}", os.path.join(SCRIPTS, script + ".py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _instrument(mp, mod, rec, "pda")
            mod.main(pda_parser(script).parse_args(flags))
    return rec.log


def run_port(script, flags, prepared, tmp_path):
    rec = EMRecorder()
    os.chdir(_side_root(prepared, tmp_path, "port"))
    cli = port_cli(script)
    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        _instrument(mp, tmc, rec, "port")
        _instrument(mp, tda if script in THIN else cli, rec, "port")
        cli.main(flags, device="cpu")
    return rec.log


RECORDED = {
    "mitoem_punet": ["--train", "--predict", "--evaluate", "--iterations", "3"],
    "mitoem_unet": ["--train", "--predict", "--evaluate"],
    "mitoem_mt": ["--train", "--predict", "--evaluate", "--masking"],
    "mitoem_fm": ["--train", "--predict", "--evaluate", "--consensus"],
    "mitoem_adamt": ["--train", "--predict", "--evaluate", "--iterations", "5"],
    "mitoem_adamt-type": ["--train", "--type", "urocell"],
    "mitoem_adamatch": ["--train", "--predict", "--evaluate", "--consensus", "--masking"],
    "mitoem_adamatch-type": ["--train", "--predict", "--type", "vnc", "--consensus"],
}


@pytest.mark.parametrize("case", sorted(RECORDED))
def test_cli_phases_match_pda(case, prepared, tmp_path, monkeypatch):
    """The same trainers (class, run name, learning rate, plateau, image
    interval, consensus and masking, warm starts), the same loaders (every
    argument, the recipes applied to a fixed patch, each volume's shape,
    labels and sample count), fit budgets, predictions (globs, outputs, MC
    samples, student or teacher weights) and dice runs (with their
    subtype), in the same order."""
    monkeypatch.chdir(tmp_path)
    script = case.split("-")[0]
    ref = run_pda(script, RECORDED[case], prepared, tmp_path)
    port = run_port(script, RECORDED[case], prepared, tmp_path)
    assert port == ref
    kinds = {entry[0] for entry in port}
    assert {"trainer", "fit", "loader"} <= kinds
    if "--evaluate" in RECORDED[case]:
        assert {"dice"} <= kinds and ({"predict"} <= kinds or {"unet_predict"} <= kinds)


@pytest.mark.parametrize("skip", [False, True])
def test_prepare_data_matches_pda(skip, tmp_path, monkeypatch):
    """pda's prepare_data.py and the port's: the same files, every volume's
    datasets and every evaluation slice equal."""
    roots = {}
    for side in ("pda", "port"):
        roots[side] = str(tmp_path / side)
        write_mitoem_tree(roots[side], seed=6, shapes=SHAPES, n_blobs=6, urocell_depth=2)
    flags = ["--data", roots["pda"]] + (["--skip_mitoem"] if skip else [])
    monkeypatch.setattr(sys, "argv", ["prepare_data.py"] + flags)
    runpy.run_path(os.path.join(SCRIPTS, "prepare_data.py"), run_name="__main__")
    port_cli("prepare_data").main(["--data", roots["port"]] + flags[2:])
    files = {side: sorted(os.path.relpath(os.path.join(d, f), roots[side])
                          for d, _, fs in os.walk(roots[side]) for f in fs)
             for side in roots}
    assert files["pda"] == files["port"]
    volumes = [f for f in files["port"] if f.endswith(".h5")]
    assert len(volumes) == 4 + 3 + (0 if skip else 4)
    for rel in files["port"]:
        a, b = os.path.join(roots["port"], rel), os.path.join(roots["pda"], rel)
        if rel.endswith(".h5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                names = []
                fa.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset)
                              else None)
                assert names
                for n in names:
                    assert fa[n].dtype == fb[n].dtype and np.array_equal(fa[n][...], fb[n][...])
        elif rel.endswith(".tif") and "preprocessed" in rel:
            assert np.array_equal(tiff.imread(a), tiff.imread(b)), rel


RUN = r"""
import json, os, sys, urllib.request
for name in ("h5py", "imageio", "imageio.v3", "cv2"):
    sys.modules[name] = None

def refuse(url, path):
    raise OSError("no fetch: " + url)

urllib.request.urlretrieve = refuse
import torch
from pda_torch.data import loader
from pda_torch.data.synthetic import write_mitoem_tree
from pda_torch.experiments import mitoem_prepare_data, mitoem_punet
from pda_torch.models import ProbabilisticUnet

def tiny(consensus_masking=False, generator=None, device="cuda"):
    return ProbabilisticUnet(num_filters=(4, 8, 12, 16), latent_dim=6, no_convs_fcomb=3,
                             beta=1.0, rl_swap=True, consensus_masking=consensus_masking,
                             generator=torch.Generator().manual_seed(0)).to(device)

root = sys.argv[1]
loader._cores = lambda: 1
mitoem_punet.mitoem_punet = tiny
dice = []
run_dice = mitoem_punet.run_dice_evaluation
mitoem_punet.run_dice_evaluation = lambda *a, **k: dice.append(run_dice(*a, **k)) or dice[-1]
write_mitoem_tree(os.path.join(root, "data"), seed=1, urocell_depth=2, n_blobs=30)
mitoem_prepare_data.main(["--data", os.path.join(root, "data")])
mitoem_punet.main(["--train", "--predict", "--evaluate", "--iterations", "2",
                   "--data", os.path.join(root, "data"), "--pred_path", os.path.join(root, "pred"),
                   "--save_root", os.path.join(root, "save")], device="cpu")
blocked = [n for n in ("h5py", "imageio", "cv2", "jax", "pda") if sys.modules.get(n) is not None]
print(json.dumps({"dice": dice, "loaded": blocked}))
"""


def test_mitoem_punet_runs_on_the_cpu_without_h5py_imageio_cv2(tmp_path):
    """mitoem_prepare_data, then mitoem_punet --train --predict --evaluate
    --iterations 2 on the CPU, PUNet (4, 8, 12, 16), 512^2 frames, with
    h5py, imageio and cv2 blocked: checkpoints, one probability map per
    target frame in [0, 1], three dice values in [0, 1]."""
    # two intra-op threads: beside the other test workers, a full team of
    # spinning OpenMP threads would oversubscribe the host's cores
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path)], capture_output=True,
                         text=True, cwd=REPO, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert len(result["dice"]) == 3 and all(0.0 <= d <= 1.0 for d in result["dice"])
    ckpt = tmp_path / "save" / "checkpoints" / "punet-source-mitoem"
    assert sorted(os.listdir(ckpt)) == ["best.pt", "latest.pt"]
    counts = {"vnc": 3, "lucchi": 4, "urocell": None}
    for em_type, n in counts.items():
        preds = sorted((tmp_path / "pred" / "punet_predictions" / em_type).iterdir())
        assert preds and (n is None or len(preds) == n)
        for p in preds:
            a = tiff.imread(str(p))
            assert a.dtype == np.float32 and a.shape == (512, 512)
            assert np.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
