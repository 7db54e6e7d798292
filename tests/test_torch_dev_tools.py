"""The dev checks of ``development/`` as the port's tools
(``pda_torch/tools/``), on the CPU: each through its ``main(argv)`` with
``--device cpu`` in a subprocess (``OMP_NUM_THREADS=2``), its last line read
back; each refusing ``--device cuda`` where there is no card; and the A/B's
measures against ``pda``'s own formulas.

  * ``ab_step_check`` at 64^2, PUNet (4, 8, 12, 16), float32 and bf16: on
    the CPU both legs run the plain versions, so every difference is 0.
  * ``ab.ab_metrics`` against a numpy transcription of
    ``development/ab_step_check.py``'s measures on perturbed gradients,
    within 1e-12 relative; float32's bounds (``ab.f32_bounds``) and its
    consensus rule (``ab.stray_flips``) on hand-made values.
  * ``e2e_drive`` end to end at its own size: dice at least 0.5.
  * ``bench_loader``: one short run of each augmentation path, 0 workers.
  * ``learning_smoke`` then ``mt_smoke`` from its checkpoint, 2 iterations
    each: the result lines, and the exit codes their bars give; a source
    run that fails its bar fails ``mt_smoke`` too.
  * ``dp_check`` at 32^2, PUNet (4, 8, 12, 16), float32 and bf16: two and
    four gloo ranks against one process, within its bounds; its comparison
    failing a mean of the gradients, N times their sum, a lost gradient, a
    skipped and a repeated optimizer step.
  * ``plot_livecell`` on a 48 x 64 synthetic frame (a TIFF) from a
    flagship ``best.pt``: its panel order, grid and PNG; refusing
    ``--device cuda`` where there is no card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pda_torch.tools import (ab, ab_step_check, bench_loader, dp_check, e2e_drive, learning_smoke,
                             mt_smoke, plot_livecell)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"ab_step_check": ab_step_check, "learning_smoke": learning_smoke,
         "mt_smoke": mt_smoke, "bench_loader": bench_loader, "e2e_drive": e2e_drive,
         "dp_check": dp_check}


def _run(tool: str, *argv: str, timeout: int = 240):
    """(exit code, the tool's result dict, output) of ``main([...argv,
    "--device", "cpu"])`` in a subprocess."""
    code = (f"import sys; from pda_torch.tools.{tool} import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, *argv, "--device", "cpu"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(f"{tool} result ")]
    assert lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.returncode, json.loads(lines[-1][len(f"{tool} result "):]), proc.stdout


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ab_step_check_plain_legs_agree_exactly(dtype):
    rc, res, out = _run("ab_step_check", "--hw", "64", "--filters", "4,8,12,16", "--dtype", dtype)
    assert rc == 0, out
    assert res["ok"] and not res["failed"]
    assert (res["loss"], res["cos"], res["leaf"], res["dy"], res["consensus_px"]) == (0, 0, 0, 0, 0)
    assert res["card"] == "cpu" and res["kernel_ms"] is None


def _pda_measures(ga, gb, loss_a, loss_b):
    """development/ab_step_check.py's measures, transcribed in numpy."""
    loss_rel = abs(loss_a - loss_b) / max(abs(loss_b), 1e-12)
    gnorm = np.sqrt(sum(float(np.sum(b * b)) for b in gb))
    worst = 0.0
    dot = naa = nbb = 0.0
    for a, b in zip(ga, gb):
        dot += float(np.sum(a * b))
        naa += float(np.sum(a * a))
        nbb += float(np.sum(b * b))
        rel = float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-4 * gnorm)
        worst = max(worst, rel)
    cos = dot / max(np.sqrt(naa * nbb), 1e-30)
    return loss_rel, 1 - cos, worst


@pytest.mark.parametrize("scale", [1e-6, 1e-2])
def test_ab_metrics_match_pdas_formulas(scale):
    rng = np.random.default_rng(4)
    shapes = [(3, 3, 4, 8), (8,), (16, 6), (1,), (5, 5)]
    gb = [rng.normal(size=s) * 10.0 ** rng.integers(-6, 2) for s in shapes]
    gb[3] *= 1e-9  # a near-zero leaf: the floor at 1e-4 of the global norm
    ga = [b + scale * np.abs(b).max() * rng.normal(size=b.shape) for b in gb]
    loss_a, loss_b = 0.731 * (1 + scale), 0.731
    side = {"a": (ga, loss_a), "b": (gb, loss_b)}
    legs = {k: {"aux": {"loss": v[1], "kl": 0.5}, "names": [f"p{i}" for i in range(len(v[0]))],
                "grads": [torch.from_numpy(g) for g in v[0]]} for k, v in side.items()}
    m = ab.ab_metrics(legs["a"], legs["b"])
    want = _pda_measures(ga, gb, loss_a, loss_b)
    got = (m["loss"], m["cos"], m["leaf"][0])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert m["aux"] == pytest.approx(abs(loss_a - loss_b) / 1.0)
    same = ab.ab_metrics(legs["b"], legs["b"])
    assert (same["loss"], same["cos"], same["leaf"][0]) == (0.0, 0.0, 0.0)


def test_f32_bounds_follow_the_plain_legs_own_spread():
    """float32's bounds: 4x the plain leg's own float32-vs-float64 spread,
    the loss at least the kernels' drift along the deepest path, pda's
    bounds the ceiling; a leg at bf16's precision fails every one."""
    own = {"loss": 2.6e-7, "aux": 2.7e-7, "cos": 1.1e-10, "leaf": (5.0e-5, "w"), "dy": 7.3e-7,
           "dlogit": 4.3e-5, "rms": 2.9e-6, "px": 0}
    b = ab.f32_bounds(own, ab_step_check.deepest_convs(ab_step_check.FILTERS))
    assert b["cos"] == pytest.approx(4.4e-10) and b["leaf"] == pytest.approx(2.0e-4)
    assert b["y"] == pytest.approx(2.92e-6) and b["window"] == pytest.approx(1.72e-4)
    assert b["loss"] == b["aux"] == pytest.approx(21 * ab.TF32X3_LAYER_DRIFT)
    coarse = ab.f32_bounds({**own, "cos": 1.0, "leaf": (1.0, "w"), "loss": 1.0}, 21)
    assert (coarse["cos"], coarse["leaf"], coarse["loss"]) == (1e-4, 5e-2, 2e-3)
    assert ab.f32_bounds({**own, "dlogit": 0.0}, 21)["window"] == ab.THRESHOLD_WINDOW
    bf16_leg = {"loss": 3.47e-4, "cos": 3.74e-6, "leaf": 5.95e-3, "y": 3.51e-3}
    assert all(v > b[k] for k, v in bf16_leg.items())


def test_stray_flips_excuse_only_pixels_near_a_threshold():
    """float32's consensus rule: a pixel may differ between the legs only
    where a sample logit lies within the window of a threshold (log 9)."""
    t = float(np.log(9.0))
    b_logits = torch.tensor([[t + 0.5, t + 1e-5, -t - 2e-5, 3.0],
                             [t + 0.7, t + 0.8, t + 0.9, 3.0]]).view(2, 1, 2, 2, 1)
    a_logits = b_logits.clone()
    z_b = torch.tensor([1.0, 1.0, 1.0, 0.0]).view(1, 2, 2, 1)
    z_a = torch.tensor([0.0, 0.0, 0.0, 1.0]).view(1, 2, 2, 1)
    a, b = {"logits": a_logits, "z": z_a}, {"logits": b_logits, "z": z_b}
    # pixels 1 and 2 lie within 1e-4 of a threshold; 0 and 3 do not
    assert ab.stray_flips(a, b, 1e-4) == 2
    assert ab.stray_flips(a, b, 0.6) == 1
    assert ab.stray_flips(b, b, 1e-4) == 0


def test_e2e_drive_clears_the_dice_floor():
    rc, res, out = _run("e2e_drive")
    assert rc == 0, out
    assert res["ok"] and res["dice"] >= e2e_drive.DICE_FLOOR
    assert set(res["seconds"]) == {"source fit", "mean teacher", "prediction", "pseudo export",
                                   "dice"}


def test_bench_loader_runs_each_path():
    rc, res, out = _run("bench_loader", "--hw", "64", "--workers", "0", "--seconds", "0.3")
    assert rc == 0, out
    assert [(r["path"], r["workers"]) for r in res["rows"]] == [("native", 0), ("numpy", 0)]
    assert all(r["patches_per_sec"] > 0 for r in res["rows"])
    assert res["need"] == pytest.approx(2 / 0.04821) and res["cores"] >= 1
    assert res["margin"] == pytest.approx(max(r["patches_per_sec"] for r in res["rows"])
                                          / res["need"])


def test_learning_smoke_then_mt_smoke(tmp_path):
    root = str(tmp_path)
    rc, res, out = _run("learning_smoke", "--iterations", "2", "--num_workers", "0",
                        "--save_root", root)
    assert rc == (0 if res["dice"] > learning_smoke.BAR else 1), out
    assert res["mixed_precision"] and res["iterations"] == 2 and len(res["dice_by_epoch"]) >= 1
    assert os.path.exists(os.path.join(res["checkpoint"], "best.pt"))
    rc, res, out = _run("mt_smoke", "--iterations", "2", "--num_workers", "0", "--save_root", root)
    assert "running learning_smoke first" not in out
    before, after = res["gt_dice_before"], res["gt_dice_after"]
    assert 0.0 <= before <= 1.0 and 0.0 <= after <= 1.0
    assert rc == (0 if after >= mt_smoke.FLOOR and after >= before - mt_smoke.DROP else 1), out


@pytest.mark.parametrize("world,batch", [(2, 2), (4, 4)])
def test_dp_check_ranks_match_one_process(world, batch):
    rc, res, out = _run("dp_check", "--hw", "32", "--filters", "4,8,12,16", "--world", str(world),
                        "--batch", str(batch))
    assert rc == 0 and res["ok"], out
    assert (res["world"], res["batch"], res["backend"], res["card"]) == (world, batch, "gloo",
                                                                         "cpu")
    for name in ("f32", "bf16"):
        assert all(res[name]["passed"].values()), res[name]
        assert set(res[name]["passed"]) == {"ranks equal", "grad leaves", "loss", "norm", "cos",
                                            "update"}
        assert 1.0 - res[name]["cos"] <= dp_check.COS_TOL
        assert res[name]["update"] <= dp_check.UPDATE_TOL
    assert res["f32"]["aux_rel"] <= dp_check.F32_LOSS_TOL
    assert res["f32"]["leaf"] <= dp_check.F32_GRAD_TOL
    assert abs(res["f32"]["norm_ratio"] - 1.0) <= dp_check.F32_NORM_TOL


def _dp_case(fault: str):
    """(ranks, ref, before) of dp_check's comparison on made-up leaves: the
    reference an Adam-like first step (each element moved by lr against its
    gradient's sign) and an EMA teacher; the ranks' results with ``fault``."""
    gen = torch.Generator().manual_seed(0)
    before = {k: torch.randn(n, generator=gen) for k, n in (("w", 300), ("b", 12))}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in before.items()}

    def result(g, steps):
        params = {k: v - steps * 1e-2 * torch.sign(grads[k]) for k, v in before.items()}
        teacher = {k: v + 1e-3 * (params[k] - v) for k, v in before.items()}
        return {"aux": {"loss": 1.0, "recon_loss": 0.6, "kl": 0.4}, "grads": g,
                "params": params, "teacher": teacher, "launches": {}}

    scale = {"none": 1.0, "mean": 0.5, "times_n": 2.0, "zero": 0.0}.get(fault, 1.0)
    steps = {"zero": 0, "skipped_step": 0, "second_step": 2}.get(fault, 1)
    got = result({k: scale * g for k, g in grads.items()}, steps)
    return [got, got], result(grads, 1), before


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("fault", ["none", "mean", "times_n", "zero", "skipped_step",
                                   "second_step"])
def test_dp_check_sees_the_gradients_scale_and_the_step(fault, name):
    """A mean of the ranks' gradients, a sum N times over, a lost gradient,
    a skipped or a repeated optimizer step each fail a bound; the exact
    result passes them all."""
    passed, _ = dp_check.compare(name, *_dp_case(fault), on_card=False)
    assert all(passed.values()) == (fault == "none"), passed


def test_mt_smoke_fails_when_its_source_run_fails(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(learning_smoke, "main", lambda argv: 1)
    assert mt_smoke.main(["--device", "cpu", "--save_root", str(tmp_path)]) == 1
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("mt_smoke result ")]
    res = json.loads(line[-1][len("mt_smoke result "):])
    assert not res["ok"] and res["failed"] == "learning_smoke"


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_refuses_cuda_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TOOLS[tool].main(["--device", "cuda"])


def _plot_inputs(root):
    """A 48 x 64 synthetic frame as a TIFF and a flagship ``best.pt``."""
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.data.tiff import imwrite
    from pda_torch.models.punet import livecell_punet

    image = os.path.join(root, "frame.tif")
    imwrite(image, make_dataset_arrays(1, (48, 64), seed=2)[0][0].astype(np.float32))
    torch.save({"model_state": livecell_punet(device="cpu").state_dict()},
               os.path.join(root, "best.pt"))
    return image


def test_plot_livecell_writes_the_panels(tmp_path):
    from pda_torch.data import png

    image, out = _plot_inputs(str(tmp_path)), str(tmp_path / "panels.png")
    rc, res, stdout = _run("plot_livecell", "--image", image, "--checkpoint", str(tmp_path),
                           "--out", out, "--n_samples", "8")
    assert rc == 0, stdout
    names = ["input (CLAHE)", "mean prediction", "consensus response"] + [
        f"sample {i}" for i in range(1, 6)]
    assert res["panels"] == names and res["card"] == "cpu" and res["launches"] is None
    assert "panels: " + ", ".join(names) in stdout.splitlines()
    assert stdout.splitlines()[-1] == f"saved panels to {out}"
    gap = plot_livecell.GAP
    assert res["grid"] == [2 * 48 + gap, 4 * 64 + 3 * gap, 3]
    assert list(png.imread(out).shape) == res["grid"]


def test_plot_livecell_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        plot_livecell.main(["--image", str(tmp_path / "x.tif"), "--checkpoint", str(tmp_path),
                            "--device", "cuda"])
