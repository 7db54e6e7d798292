"""The port's ``plot_livecell`` (pda_torch/tools/plot_livecell.py,
pda_torch/tools/colormaps.py) against ``pda``'s
``development/plot_livecell.py`` on the CPU:

  * ``clahe`` bit for bit ``pda``'s (``cv2.createCLAHE(2.0, (8, 8))`` of
    OpenCV 5.0.0 on ``pda``'s uint8 image) under hypothesis: sides from 1 to
    300, those the 8 x 8 grid divides and those it does not (under 8, 1 x N),
    float images with negative values, constant and two-level images; and
    ``equalize`` against cv2 on uint8 images directly;
  * the colour tables and the mapping byte for byte
    ``matplotlib.colormaps[name](Normalize(vmin, vmax)(x), bytes=True)``:
    every table row, random floats with 0, 1, just below 1, values outside
    [0, 1] and NaN, and the gray panel's uint8 scaled from its minimum to
    its maximum;
  * the flagship at full width (64, 128, 256, 512) on a 64 x 80 synthetic
    frame (and a 58 x 76 one, reflect-padded to 64 x 80): the same seeded
    weights (``seeded_params`` on ``pda``'s ``livecell_punet()`` tree, into
    the port by ``state_dict_from_pda``) and the same JAX-drawn noise
    (``PRNGKey(0)``'s normals, what ``pda``'s ``sample_n`` draws) through
    ``pda``'s encode, ``mc_decode_logits`` and ``consensus_from_logits``
    and the port's :func:`sample` (the Fcomb's last layer and latent
    projection scaled by 4, so that the logits cross both thresholds and
    the samples part): logits, probabilities and pseudo-label within 1e-5
    relative (float32; measured 2.6e-6, 3.3e-6, 6.0e-7), the consensus off
    only where a logit lies within 1e-4 of a threshold (the logits' measured
    spread: 2.3e-5);
  * the grid: its shape for n = 1, 2, 8, 9, 16, the panels' order and pixels, and
    ``pda``'s quirk that with n = 8 only samples 1-5 get a cell;
  * the tool end to end in a subprocess with ``cv2``, ``imageio`` and
    ``matplotlib`` set to None in ``sys.modules``.
"""

import importlib.util
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from matplotlib.colors import Normalize

from pda_torch.tools import colormaps, plot_livecell
from torch_port_utils import assert_close_scaled, assert_consensus_matches, seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = settings(max_examples=300, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])
PROBS_REL = 1e-5  # float32: the port's sigmoids against pda's, relative to max(1, |ref|)
WINDOW = 1e-4  # a consensus pixel may differ where a logit is this near +-log 9
N_SAMPLES = 8
LAST_SCALE, Z_SCALE = 4.0, 4.0  # the Fcomb's last layer and latent projection, scaled


def _pda_module():
    spec = importlib.util.spec_from_file_location(
        "pda_plot_livecell", os.path.join(REPO, "development", "plot_livecell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PDA = _pda_module()


# -- CLAHE ----------------------------------------------------------------------------

side = st.one_of(st.integers(1, 24), st.integers(1, 300))


def image(data):
    # no subnormal draws: a process that has loaded the native library (-ffast-math)
    # flushes them to zero, and hypothesis refuses to draw them there
    h, w = data.draw(side), data.draw(side)
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    kind = data.draw(st.sampled_from(["normal", "uniform", "two_level", "constant", "blobs"]))
    if kind == "normal":
        scale = data.draw(st.sampled_from([1.0, 1e-3, 300.0]))
        img = rng.standard_normal((h, w)) * scale + data.draw(st.sampled_from([0.0, -5.0, 40.0]))
    elif kind == "uniform":
        img = rng.uniform(-1.0, 1.0, (h, w))
    elif kind == "two_level":
        img = np.where(rng.random((h, w)) < data.draw(st.floats(0.0, 1.0, allow_subnormal=False)),
                       -2.5, 7.0)
    elif kind == "constant":
        img = np.full((h, w), data.draw(st.floats(-10.0, 10.0, allow_subnormal=False)))
    else:
        yy, xx = np.mgrid[:h, :w]
        img = np.sin(yy / 5.0) * np.cos(xx / 7.0) + 0.1 * rng.standard_normal((h, w))
    return img.astype(np.float32)


@SETTINGS
@given(data=st.data())
def test_clahe_matches_pda_bit_for_bit(data):
    img = image(data)
    got, want = plot_livecell.clahe(img), PDA.clahe(img)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == img.shape
    assert np.array_equal(got, want), (img.shape, int((got != want).sum()))


HAND = {
    "1x1": (1, 1), "1xN": (1, 137), "Nx1": (93, 1), "under_8": (5, 7), "8x8": (8, 8),
    "grid_divides": (64, 80), "rows_divide": (64, 77), "cols_divide": (61, 80),
    "livecell": (520, 704), "padded": (528, 704), "tall": (300, 9),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_clahe_hand_cases(name):
    h, w = HAND[name]
    rng = np.random.default_rng(sum(HAND[name]))
    for img in (rng.standard_normal((h, w)).astype(np.float32) * 3 - 1,
                np.full((h, w), 0.25, np.float32),
                np.where(rng.random((h, w)) < 0.3, -1.0, 1.0).astype(np.float32)):
        assert np.array_equal(plot_livecell.clahe(img), PDA.clahe(img))


@SETTINGS
@given(data=st.data())
def test_equalize_matches_cv2_on_uint8(data):
    h, w = data.draw(side), data.draw(side)
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    lo, hi = sorted(data.draw(st.tuples(st.integers(0, 255), st.integers(0, 255))))
    u8 = rng.integers(lo, hi + 1, (h, w)).astype(np.uint8)
    want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(u8)
    assert np.array_equal(plot_livecell.equalize(u8), want)


# -- colour maps ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gray", "viridis", "magma"])
def test_tables_are_matplotlibs(name):
    want = matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3]
    assert colormaps.TABLES[name].dtype == np.uint8
    assert np.array_equal(colormaps.TABLES[name], want)


@pytest.mark.parametrize("name", ["gray", "viridis", "magma"])
def test_colorize_matches_matplotlib(name):
    rng = np.random.default_rng(7)
    one = np.float32(1)
    rows = (np.arange(256, dtype=np.float32) + np.float32(0.5)) / np.float32(256)
    edges = np.arange(257, dtype=np.float32) / np.float32(256)
    special = np.array([0.0, 1.0, np.nextafter(one, np.float32(0)), -1e-30, -0.5, 1.0 + 1e-7,
                        2.0, 255 / 256, np.nextafter(np.float32(255 / 256), np.float32(0)),
                        np.nan, 1e30, -1e30], np.float32)
    x = np.concatenate([rows, edges, special, rng.uniform(-0.25, 1.25, 50_000).astype(np.float32),
                        rng.random(50_000, dtype=np.float32)])
    want = matplotlib.colormaps[name](Normalize(0, 1)(x), bytes=True)[..., :3]
    assert np.array_equal(colormaps.colorize(x, name, 0, 1), want)
    img = x[:2000].reshape(40, 50)
    assert np.array_equal(colormaps.colorize(img, name, 0, 1),
                          matplotlib.colormaps[name](Normalize(0, 1)(img), bytes=True)[..., :3])


@pytest.mark.parametrize("lo,hi", [(0, 255), (3, 250), (17, 18), (40, 40)])
def test_gray_panel_scales_from_min_to_max(lo, hi):
    """imshow's autoscale of the CLAHE image: Normalize(min, max) of uint8."""
    u8 = np.random.default_rng(lo).integers(lo, hi + 1, (64, 80)).astype(np.uint8)
    vmin, vmax = u8.min(), u8.max()
    want = matplotlib.colormaps["gray"](Normalize(vmin, vmax)(u8), bytes=True)[..., :3]
    assert np.array_equal(colormaps.colorize(u8, "gray", vmin, vmax), want)


# -- the model at full width, against pda ------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    """(pda's flagship module, its seeded params, the port's model)."""
    from pda.experiments import livecell_punet as pda_livecell_punet
    from pda_torch.models import state_dict_from_pda
    from pda_torch.models.punet import livecell_punet

    model = pda_livecell_punet()
    x0 = jnp.zeros((1, 16, 16, 1))
    params = seeded_params(model, x0, x0, seed=3)
    fc = params["fcomb"]
    # logits across both thresholds, and samples that part
    fc["last_layer"] = {k: v * LAST_SCALE for k, v in fc["last_layer"].items()}
    fc["z_proj"] = {k: v * Z_SCALE for k, v in fc["z_proj"].items()}
    port = livecell_punet(device="cpu")
    port.load_state_dict(state_dict_from_pda(params))
    return model, params, port.eval()


def _pda_panels(model, params, img, n):
    """What pda's main computes (development/plot_livecell.py:56-69), and the
    normals its sample_n draws from PRNGKey(0)."""
    from pda.core import consensus_from_logits
    from pda.infer.tiling import pad_to_divisible
    from pda.models.punet import mc_decode_logits

    norm = (img - img.mean()) / (img.std() + 1e-7)
    padded, (h, w) = pad_to_divisible(jnp.asarray(norm[..., None]), (16, 16))
    enc = model.apply({"params": params}, padded[None], method="encode")
    key = jax.random.PRNGKey(0)
    logits = mc_decode_logits(model, params, enc.features, enc.prior, key, n)
    probs = np.asarray(jax.nn.sigmoid(logits))[:, 0, :h, :w, 0]
    pseudo, consensus = consensus_from_logits(logits)
    eps = jax.random.normal(key, (n, 1, 6), enc.prior.mu.dtype)
    return (np.asarray(logits)[:, 0, :h, :w, 0], probs, np.asarray(pseudo)[0, :h, :w, 0],
            np.asarray(consensus)[0, :h, :w, 0], np.asarray(eps))


@pytest.mark.parametrize("shape", [(64, 80), (58, 76)], ids=["64x80", "58x76_padded"])
def test_panels_match_pda_at_full_width(flagship, shape):
    from pda_torch.data.synthetic import make_dataset_arrays

    model, params, port = flagship
    img = make_dataset_arrays(1, shape, seed=4)[0][0].astype(np.float32)
    logits, probs, pseudo, consensus, eps = _pda_panels(model, params, img, N_SAMPLES)
    got = plot_livecell.sample(port, plot_livecell.standardize(img), N_SAMPLES,
                               eps=torch.from_numpy(eps.copy()))
    assert got.probs.shape == probs.shape == (N_SAMPLES, *shape)
    assert got.pseudo.shape == got.consensus.shape == shape
    assert_close_scaled(got.logits, logits, rel=PROBS_REL)
    assert_close_scaled(got.probs, probs, rel=PROBS_REL)
    assert_close_scaled(got.pseudo, pseudo, rel=PROBS_REL)
    assert_consensus_matches(got.consensus, consensus, logits, window=WINDOW)
    assert 0.0 < float(consensus.mean()) < 1.0
    assert 0.0 < float(probs.std())  # the samples differ: the noise matters


def test_noise_comes_from_a_generator_seeded_0(flagship):
    """Without ``eps`` the tool draws from the generator it is handed: the
    same as handing in that generator's normals."""
    _, _, port = flagship
    img = np.random.default_rng(0).standard_normal((32, 48)).astype(np.float32)
    norm = plot_livecell.standardize(img)
    a = plot_livecell.sample(port, norm, 3, generator=torch.Generator().manual_seed(0))
    eps = torch.randn(3, 1, 6, generator=torch.Generator().manual_seed(0))
    b = plot_livecell.sample(port, norm, 3, eps=eps)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# -- the grid -----------------------------------------------------------------------------


def _samples(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=3.0, size=(n, h, w)).astype(np.float32)
    probs = 1 / (1 + np.exp(-logits))
    return plot_livecell.Samples(logits, probs, probs.mean(0),
                                 ((logits >= np.log(9)) | (logits <= -np.log(9))).mean(0))


@pytest.mark.parametrize("n,cols,shown", [(1, 3, 1), (2, 3, 2), (8, 4, 5), (9, 5, 7), (16, 8, 13)])
def test_grid_shape_and_pdas_sample_quirk(n, cols, shown):
    h, w, gap = 24, 36, plot_livecell.GAP
    img = np.random.default_rng(n).standard_normal((h, w)).astype(np.float32)
    s = _samples(n, h, w)
    grid, names = plot_livecell.figure(img, s, n)
    assert plot_livecell.grid_shape(n) == (2, cols)
    assert grid.shape == (2 * h + gap, cols * w + (cols - 1) * gap, 3) and grid.dtype == np.uint8
    assert names == (["input (CLAHE)", "mean prediction", "consensus response"]
                     + [f"sample {i + 1}" for i in range(shown)])

    def cell(k):
        r, c = divmod(k, cols)
        return grid[r * (h + gap):r * (h + gap) + h, c * (w + gap):c * (w + gap) + w]

    enhanced = plot_livecell.clahe(img)
    assert np.array_equal(cell(0), colormaps.colorize(enhanced, "gray", enhanced.min(),
                                                      enhanced.max()))
    assert np.array_equal(cell(1), colormaps.colorize(s.pseudo, "viridis", 0, 1))
    assert np.array_equal(cell(2), colormaps.colorize(s.consensus, "magma", 0, 1))
    for i in range(shown):
        assert np.array_equal(cell(3 + i), colormaps.colorize(s.probs[i], "viridis", 0, 1))
    for k in range(3 + shown, 2 * cols):
        assert (cell(k) == 255).all()  # an empty cell
    assert (grid[h:h + gap] == 255).all() and (grid[:, w:w + gap] == 255).all()


def test_n8_shows_samples_1_to_5():
    """pda's grid for the default n = 8 has 2 x 4 cells: three panels and
    samples 1-5; samples 6-8 are drawn but not shown (ROADMAP watch-list)."""
    rows, cols = plot_livecell.grid_shape(8)
    assert rows * cols - 3 == 5
    s = _samples(8, 16, 16)
    _, names = plot_livecell.figure(np.ones((16, 16), np.float32), s, 8)
    assert names[3:] == [f"sample {i}" for i in range(1, 6)]


# -- the tool without cv2, imageio or matplotlib -----------------------------------------


def test_tool_runs_without_cv2_imageio_matplotlib(tmp_path):
    from pda_torch.data.synthetic import make_dataset_arrays
    from pda_torch.data.tiff import imwrite

    img = make_dataset_arrays(1, (40, 56), seed=1)[0][0].astype(np.float32)
    imwrite(str(tmp_path / "frame.tif"), img)
    out = tmp_path / "panels.png"
    code = ("import sys\n"
            "for m in ('cv2', 'imageio', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from pda_torch.models.punet import livecell_punet\n"
            f"torch.save({{'model_state': livecell_punet(device='cpu').state_dict()}}, "
            f"{str(tmp_path / 'best.pt')!r})\n"
            "from pda_torch.tools.plot_livecell import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, "--image", str(tmp_path / "frame.tif"),
                           "--checkpoint", str(tmp_path), "--out", str(out), "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == f"saved panels to {out}"
    from pda_torch.data import png

    grid = png.imread(str(out))
    assert grid.shape == (2 * 40 + plot_livecell.GAP, 4 * 56 + 3 * plot_livecell.GAP, 3)
