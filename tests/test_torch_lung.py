"""The port's Lung X-Ray CLIs (pda_torch/experiments/lung_*.py,
pda_torch/experiments/lung.py) against ``pda``'s (experiments/Lung-XRay/*.py,
pda/experiments/lung.py) on the CPU: the five parsers; for every CLI what
its --train, --predict and --evaluate phases ask of the trainers, the loader
factory, the prediction and dice runners and the checkpoints (both sides'
runners replaced by recorders, each side in its own directory over the same
prepared synthetic Lung tree); the prepare step's files in both invocation
forms; and one real run (lung_prepare_data, then lung_punet --train
--predict --evaluate with the PUNet at (4, 8, 12, 16) and the BCE
reconstruction) in a subprocess with imageio, cv2 and scikit-learn blocked."""

import argparse
import importlib
import importlib.util
import json
import os
import runpy
import shutil
import subprocess
import sys

import imageio.v3 as iio
import numpy as np
import pytest

import pda.experiments.lung as jlx
import pda_torch.experiments.lung as tlx
from pda_torch.data import tiff
from pda_torch.data.builders import lung as tlung
from pda_torch.data.synthetic import write_lung_tree
from test_torch_experiments import FakeModel, Recorder, _recipe, options
from torch_port_utils import numpy_augs

REPO = os.path.join(os.path.dirname(__file__), "..")
SCRIPTS = os.path.join(REPO, "experiments", "Lung-XRay")
# pda's script -> the port's module
CLIS = {"lung_punet": "lung_punet", "lung_unet": "lung_unet", "lung_mt": "lung_mt",
        "lung_adamt": "lung_adamt", "prepare_data": "lung_prepare_data"}
THIN = ("lung_mt", "lung_adamt")
SHAPES = {"jsrt1": [(40, 48)], "jsrt2": [(44, 40)], "nih": [(64, 64)],
          "montgomery": [(72, 60), (60, 72)]}


def port_cli(name):
    return importlib.import_module(f"pda_torch.experiments.{CLIS[name]}")


class _Parsed(Exception):
    pass


def pda_parser(script):
    """The parser ``experiments/Lung-XRay/<script>.py`` builds when run."""
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


@pytest.mark.parametrize("script", sorted(CLIS))
def test_cli_parsers_match_pda(script):
    assert options(port_cli(script).get_parser()) == options(pda_parser(script))


def test_lung_module_matches_pda():
    assert list(tlung.LUNG_DOMAINS) == list(tlx.LUNG_DOMAINS) == list(jlx.LUNG_DOMAINS)
    for d in tlung.LUNG_DOMAINS:
        assert tlx.test_image_glob("./d", d) == jlx.test_image_glob("./d", d)
        assert tlx.test_gt_dir("./d", d) == jlx.test_gt_dir("./d", d)


def test_lung_punet_is_the_flagship_with_bce():
    """The Lung PUNet has the flagship's weights' shapes (64..512, latent 6,
    Fcomb 3) and beta, and the BCE reconstruction; the Lung UNet is UNet2d
    at depth 4 with 64 features and a sigmoid, as pda's scripts build them."""
    from pda.experiments.common import lung_punet as jlung_punet
    from pda_torch.experiments.common import livecell_punet, lung_punet

    model, flagship = lung_punet(device="cpu"), livecell_punet(device="cpu")
    assert model.rl_swap is False and flagship.rl_swap is True
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in flagship.state_dict().items()}
    ref = jlung_punet()
    assert (model.latent_dim, model.beta, model.rl_swap) == (ref.latent_dim, ref.beta,
                                                             ref.rl_swap)
    assert ref.num_filters == (64, 128, 256, 512) and ref.no_convs_fcomb == 3
    unet = port_cli("lung_unet").make_model("cpu")
    script = _load_script("lung_unet").make_model()
    assert (unet.depth, unet.final_activation) == (script.depth, script.final_activation)
    assert script.initial_features == 64
    assert unet.encoder.blocks[0].block[1].out_channels == 64


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------


class LungRecorder(Recorder):
    """:class:`test_torch_experiments.Recorder` with the lung loader factory
    (its arguments, the recipes on a fixed patch, the image and label paths)
    and the lung dice runner (with its domain)."""

    def factory(self, real, name):
        def wrapped(*args, **kw):
            loader = real(*args, **kw)
            self.log.append(("loader", name, args, tuple(sorted(
                (k, _recipe(v) if callable(v) else v) for k, v in kw.items())),
                tuple(loader.dataset.raw_images), tuple(loader.dataset.label_images)))
            return loader
        return wrapped

    def lung_dice(self, gt, pred, lung_domain, **kw):
        self.log.append(("dice", gt, pred, lung_domain))
        return 0.5


TRAINERS = ("PUNetTrainer", "UNetTrainer", "MeanTeacherTrainer", "AdaMTTrainer")


def _instrument(mp, mod, rec, side):
    for name in TRAINERS:
        if hasattr(mod, name):
            mp.setattr(mod, name, rec.trainer(name))
    if hasattr(mod, "get_lung_loader"):
        mp.setattr(mod, "get_lung_loader", rec.factory(mod.get_lung_loader, "get_lung_loader"))
    for name, fn in (("punet_prediction", rec.punet_prediction),
                     ("unet_prediction", rec.unet_prediction),
                     ("run_lung_dice_evaluation", rec.lung_dice),
                     ("load_params", rec.load_params)):
        if hasattr(mod, name):
            mp.setattr(mod, name, fn)
    if hasattr(mod, "checkpoint_exists"):
        mp.setattr(mod, "checkpoint_exists", lambda *a, **k: True)
    if side == "pda":
        if hasattr(mod, "init_params_cpu"):
            mp.setattr(mod, "init_params_cpu", lambda *a, **k: {})
    else:
        if hasattr(mod, "lung_punet"):
            mp.setattr(mod, "lung_punet", FakeModel.factory)
        if hasattr(mod, "make_model"):
            mp.setattr(mod, "make_model", lambda device="cuda": FakeModel(False, device))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A small Lung tree, Montgomery and NIH prepared by the port."""
    root = str(tmp_path_factory.mktemp("lung") / "data")
    write_lung_tree(root, seed=5, shapes=SHAPES)
    port_cli("prepare_data").main(["--data", root])
    return root


def _load_script(script):
    spec = importlib.util.spec_from_file_location(f"_pda_lung_{script}",
                                                  os.path.join(SCRIPTS, script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_pda(script, flags, prepared, tmp_path):
    rec = LungRecorder()
    root = tmp_path / "pda"
    shutil.copytree(prepared, root / "data")
    os.chdir(root)
    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        _instrument(mp, jlx, rec, "pda")
        if script in THIN:
            mp.setattr(sys, "argv", [script] + flags)
            runpy.run_path(os.path.join(SCRIPTS, script + ".py"), run_name="__main__")
        else:
            mod = _load_script(script)
            _instrument(mp, mod, rec, "pda")
            mod.main(pda_parser(script).parse_args(flags))
    return rec.log


def run_port(script, flags, prepared, tmp_path):
    rec = LungRecorder()
    root = tmp_path / "port"
    shutil.copytree(prepared, root / "data")
    os.chdir(root)
    cli = port_cli(script)
    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        _instrument(mp, tlx, rec, "port")
        if script not in THIN:
            _instrument(mp, cli, rec, "port")
        cli.main(flags, device="cpu")
    return rec.log


RECORDED = {
    "lung_punet": ["--train", "--predict", "--evaluate", "--iterations", "3"],
    "lung_unet": ["--train", "--predict", "--evaluate"],
    "lung_mt": ["--train", "--predict", "--evaluate", "--masking"],
    "lung_mt-consensus": ["--train", "--predict", "--evaluate", "--consensus", "--iterations",
                          "4"],
    "lung_adamt": ["--train", "--predict", "--evaluate", "--consensus"],
    "lung_adamt-masking": ["--train", "--predict", "--evaluate", "--consensus", "--masking"],
}


@pytest.mark.parametrize("case", sorted(RECORDED))
def test_cli_phases_match_pda(case, prepared, tmp_path, monkeypatch):
    """The same trainers (class, run name, learning rate, plateau, image
    interval, consensus and masking, warm starts from the source runs'
    best checkpoints), the same loaders (domain, folder, split, batch,
    recipes, image and label paths after scikit-learn's split), fit budgets,
    checkpoints read (student or teacher), predictions (globs, outputs,
    MC-16) and dice runs (with their domain), in the same order, over the
    4 x 4 and 4 x 3 domain pairs."""
    monkeypatch.chdir(tmp_path)
    script = case.split("-")[0]
    ref = run_pda(script, RECORDED[case], prepared, tmp_path)
    port = run_port(script, RECORDED[case], prepared, tmp_path)
    assert port == ref
    kinds = [entry[0] for entry in port]
    assert {"trainer", "fit", "loader", "load", "dice"} <= set(kinds)
    pairs = 12 if script in THIN else 16
    assert kinds.count("dice") == pairs
    assert kinds.count("predict") + kinds.count("unet_predict") == pairs


def test_da_loop_narrows_to_domains(prepared, tmp_path, monkeypatch):
    """``domains`` cuts the 4 x 3 loop to the pairs of the domains given,
    in pda's order; AdaMT's unused source validation loader is closed."""
    rec = LungRecorder()
    shutil.copytree(prepared, tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    closed = []
    real = tlung.get_lung_loader

    def factory(*a, **k):
        loader = real(*a, **k)
        close = loader.close
        loader.close = lambda: closed.append(a[:1] + a[2:]) or close()
        return loader

    with numpy_augs(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlung, "get_lung_loader", factory)
        _instrument(mp, tlx, rec, "port")
        mp.setattr(tlx, "get_lung_loader", rec.factory(factory, "get_lung_loader"))
        port_cli("lung_adamt").main(["--train", "--predict", "--evaluate"],
                                    domains=("jsrt2", "montgomery"), device="cpu")
    names = [e[2] for e in rec.log if e[0] == "trainer"]
    assert names == ["adamt-lung-source-montgomery-target-jsrt2",
                     "adamt-lung-source-jsrt2-target-montgomery"]
    assert [e[3] for e in rec.log if e[0] == "dice"] == ["montgomery", "jsrt2"]
    assert closed == [("montgomery", "val"), ("jsrt2", "val")]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


def _reference_layout(raw, dst):
    """The distribution's trees (the INPUT form's layout) from a raw tree."""
    for src, rel in (("montgomery", "data/Montgomery/MontgomerySet"), ("nih", "data/NIH"),
                     ("jsrt1", "jsrt/Segmentation01"),
                     ("jsrt2", "jsrt/segmentation02/segmentation")):
        shutil.copytree(os.path.join(raw, src), os.path.join(dst, rel))


@pytest.mark.parametrize("form", ["combined", "input"])
def test_prepare_data_matches_pda(form, tmp_path, monkeypatch):
    """pda's prepare_data.py and the port's, in both invocation forms: the
    same files, every image decoded equal (the JSRT trees copied as they
    are in the INPUT form)."""
    raw = str(tmp_path / "raw")
    write_lung_tree(raw, seed=6, shapes=SHAPES)
    outs = {}
    for side in ("pda", "port"):
        if form == "combined":
            outs[side] = str(tmp_path / side)
            shutil.copytree(raw, outs[side])
            argv = ["--data", outs[side]]
        else:
            inp = str(tmp_path / f"input_{side}")
            _reference_layout(raw, inp)
            outs[side] = str(tmp_path / f"out_{side}")
            argv = [inp, "--data", outs[side]]
        if side == "pda":
            monkeypatch.setattr(sys, "argv", ["prepare_data.py"] + argv)
            runpy.run_path(os.path.join(SCRIPTS, "prepare_data.py"), run_name="__main__")
        else:
            port_cli("prepare_data").main(argv)
    files = {side: _files(root) for side, root in outs.items()}
    assert files["pda"] == files["port"]
    want = {"montgomery_processed", "nih_processed"} | ({"jsrt1", "jsrt2"} if form == "input"
                                                        else set())
    assert {f.split(os.sep)[0] for f in files["port"]} >= want
    for rel in files["port"]:
        if rel.endswith((".png", ".bmp")):
            a = iio.imread(os.path.join(outs["port"], rel))
            b = iio.imread(os.path.join(outs["pda"], rel))
            assert a.dtype == b.dtype and np.array_equal(a, b), rel


RUN = r"""
import importlib, json, os, sys
for name in ("imageio", "imageio.v3", "cv2", "sklearn", "sklearn.model_selection"):
    sys.modules[name] = None
import torch
from pda_torch.data import loader
from pda_torch.data.synthetic import write_lung_tree
from pda_torch.models import ProbabilisticUnet
prepare, cli = (importlib.import_module("pda_torch.experiments." + n)
                for n in ("lung_prepare_data", "lung_punet"))

def tiny(consensus_masking=False, generator=None, device="cuda"):
    return ProbabilisticUnet(num_filters=(4, 8, 12, 16), latent_dim=6, no_convs_fcomb=3,
                             beta=1.0, rl_swap=False, consensus_masking=consensus_masking,
                             generator=torch.Generator().manual_seed(0)).to(device)

root = sys.argv[1]
loader._cores = lambda: 1
cli.lung_punet = tiny
dice = []
run_dice = cli.run_lung_dice_evaluation
cli.run_lung_dice_evaluation = lambda *a, **k: dice.append(run_dice(*a, **k)) or dice[-1]
shapes = {"jsrt1": [(300, 280)], "jsrt2": [(280, 300)], "nih": [(512, 512)],
          "montgomery": [(612, 500), (500, 612)]}
write_lung_tree(os.path.join(root, "data"), seed=1, shapes=shapes)
prepare.main(["--data", os.path.join(root, "data")])
cli.main(["--train", "--predict", "--evaluate", "--iterations", "2",
          "--data", os.path.join(root, "data"), "--pred_path", os.path.join(root, "pred"),
          "--save_root", os.path.join(root, "save")], device="cpu")
blocked = [n for n in ("imageio", "cv2", "sklearn", "jax", "pda") if sys.modules.get(n) is not None]
print(json.dumps({"dice": dice, "loaded": blocked}))
"""


def test_lung_punet_runs_on_the_cpu_without_imageio_cv2_sklearn(tmp_path):
    """lung_prepare_data, then lung_punet --train --predict --evaluate
    --iterations 2 on the CPU, PUNet (4, 8, 12, 16) with the BCE
    reconstruction, the four domains (JSRT segmentation02 as BMPs), with
    imageio, cv2 and scikit-learn blocked: checkpoints, one probability map
    per test image and (source, target) in [0, 1] at the image's shape, 16
    dice values in [0, 1]."""
    # two intra-op threads: beside the other test workers, a full team of
    # spinning OpenMP threads would oversubscribe the host's cores
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path)], capture_output=True,
                         text=True, cwd=REPO, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert len(result["dice"]) == 16 and all(0.0 <= d <= 1.0 for d in result["dice"])
    data = str(tmp_path / "data")
    for src in tlung.LUNG_DOMAINS:
        ckpt = tmp_path / "save" / "checkpoints" / f"punet-source-lung-{src}"
        assert sorted(os.listdir(ckpt)) == ["best.pt", "latest.pt"]
        for trg in tlung.LUNG_DOMAINS:
            images = sorted(p for p in __import__("glob").glob(tlx.test_image_glob(data, trg)))
            folder = tmp_path / "pred" / "punet_source" / f"source-{src}-target-{trg}"
            preds = sorted(folder.iterdir())
            assert [p.stem for p in preds] == [os.path.splitext(os.path.basename(i))[0]
                                               for i in images] and preds
            for p, img in zip(preds, images):
                a = tiff.imread(str(p))
                assert a.dtype == np.float32 and a.shape == iio.imread(img).shape[:2]
                assert np.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
