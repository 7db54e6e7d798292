"""The ported serving slice as a whole against pda: tiled MC prediction and
the full-frame pseudo-label + consensus, same weights through the bridge,
same latent noise; and the file-level export contract."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.infer.predict import _full_punet_pseudo, _tiled_punet_probs
from pda.infer.tiling import pad_to_divisible as j_pad
from pda.models.punet import decode as j_decode
from pda.models.punet import encode as j_encode
from pda.models.punet import mc_decode_logits as j_mc_decode_logits
from pda_torch.infer import (full_punet_pseudo, punet_prediction, punet_pseudo_prediction,
                             tiled_punet_probs)
from torch_port_utils import (LATENT, assert_close_scaled, assert_consensus_matches, pda_punet,
                              port_punet, t)

N_SAMPLES = 4


def _image(shape=(40, 56), seed=0):
    """A frame with structure (blobs on a ramp) plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    img = 0.02 * xx + rng.normal(size=shape) * 0.3
    for _ in range(5):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        img += 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0)
    return (img[..., None] * 40 + 100).astype(np.float32)


def test_encode_and_decode_match_pda():
    """The whole PUNet: features, prior and posterior (image + mask input),
    and one decode, against pda with the same weights."""
    jmodel, params = pda_punet()
    port = port_punet(params)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 24, 1)).astype(np.float32)
    segm = (rng.uniform(size=(2, 32, 24, 1)) > 0.5).astype(np.float32)
    z = rng.normal(size=(2, LATENT)).astype(np.float32)
    ref = j_encode(jmodel, params, jnp.asarray(x), jnp.asarray(segm))
    with torch.no_grad():
        enc = port.encode(t(x), t(segm))
        logits = port.decode(enc.features, t(z))
    assert_close_scaled(enc.features.numpy(), ref.features)
    for got, want in ((enc.prior, ref.prior), (enc.posterior, ref.posterior)):
        assert_close_scaled(got.mu.numpy(), want.mu)
        assert_close_scaled(got.log_sigma.numpy(), want.log_sigma)
    assert_close_scaled(logits.numpy(), j_decode(jmodel, params, ref.features, jnp.asarray(z)))


def test_tiled_punet_probs_matches_pda():
    jmodel, params = pda_punet()
    port = port_punet(params)
    img = _image()
    block, halo = (32, 32), (16, 16)  # 2 x 2 tiles of 64^2
    key = jax.random.PRNGKey(3)
    ref = _tiled_punet_probs(jmodel, params, jnp.asarray(img), key, N_SAMPLES, block, halo)
    eps = t(jax.random.normal(key, (N_SAMPLES, 4, LATENT)))
    out = tiled_punet_probs(port, t(img), eps, N_SAMPLES, block, halo)
    assert out.shape == (40, 56, 1)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= 1e-5


def test_full_punet_pseudo_matches_pda():
    jmodel, params = pda_punet()
    port = port_punet(params)
    img = _image(seed=1)
    key = jax.random.PRNGKey(4)
    ref_p, ref_c = _full_punet_pseudo(jmodel, params, jnp.asarray(img), key, N_SAMPLES, True)
    # pda's logits, for the pixels whose consensus sits on a threshold
    x = jnp.asarray(img)
    norm = (x - x.mean()) / (jnp.std(x - x.mean()) + 1e-7)
    padded, _ = j_pad(norm, (16, 16))
    enc = j_encode(jmodel, params, padded[None])
    logits = j_mc_decode_logits(jmodel, params, enc.features, enc.prior, key, N_SAMPLES)
    logits = np.asarray(logits)[:, 0, :40, :56]

    eps = t(jax.random.normal(key, (N_SAMPLES, 1, LATENT)))
    pseudo, cons = full_punet_pseudo(port, t(img), eps, N_SAMPLES, masking=True)
    assert pseudo.shape == cons.shape == (40, 56, 1)
    assert float(np.abs(pseudo.numpy() - np.asarray(ref_p)).max()) <= 1e-5
    assert set(np.unique(cons.numpy())) <= {0.0, 1.0}
    assert_consensus_matches(cons.numpy(), ref_c, logits)


def _write_images(folder, names, shape=(40, 56)):
    import imageio.v3 as imageio

    os.makedirs(folder, exist_ok=True)
    for i, name in enumerate(names):
        imageio.imwrite(os.path.join(folder, name), _image(shape, seed=i)[..., 0])


def test_file_level_prediction_and_pseudo_export(tmp_path):
    import imageio.v3 as imageio

    _, params = pda_punet()
    port = port_punet(params)
    src = str(tmp_path / "images")
    _write_images(src, ["a.tif", "b.tif"])

    punet_prediction(os.path.join(src, "*.tif"), str(tmp_path / "pred"), port,
                     prior_samples=N_SAMPLES, block_shape=(32, 32), halo=(16, 16),
                     verbose=False)
    for name in ("a.tif", "b.tif"):
        pred = imageio.imread(str(tmp_path / "pred" / name))
        assert pred.shape == (40, 56) and pred.dtype == np.float32
        assert 0.0 <= pred.min() and pred.max() <= 1.0

    out = str(tmp_path / "pseudo")
    stale = os.path.join(out, "annotations", "train", "old.tif")
    os.makedirs(os.path.dirname(stale))
    open(stale, "w").close()
    punet_pseudo_prediction(src, out, port, prior_samples=N_SAMPLES, split_name="train",
                            seed=1, verbose=False)
    assert sorted(os.listdir(os.path.join(out, "annotations", "train"))) == ["a.tif", "b.tif"]
    for name in ("a.tif", "b.tif"):
        pseudo = imageio.imread(os.path.join(out, "annotations", "train", name))
        cons = imageio.imread(os.path.join(out, "consensus", "train", name))
        assert pseudo.shape == cons.shape == (40, 56)
        assert cons.dtype == np.uint8 and set(np.unique(cons)) <= {0, 1}
    # the export is the array-level entry on the seeded generator's draws
    eps = torch.randn((N_SAMPLES, 1, LATENT), generator=torch.Generator().manual_seed(1))
    p, _ = full_punet_pseudo(port, torch.from_numpy(_image(seed=0)), eps, N_SAMPLES, True)
    np.testing.assert_array_equal(
        imageio.imread(os.path.join(out, "annotations", "train", "a.tif")), p[..., 0].numpy())


def test_pseudo_export_empty_glob_keeps_earlier_exports(tmp_path):
    _, params = pda_punet()
    port = port_punet(params)
    out = tmp_path / "pseudo"
    keep = out / "annotations" / "train" / "cellA" / "old.tif"
    keep.parent.mkdir(parents=True)
    keep.write_bytes(b"x")
    (tmp_path / "images").mkdir()
    with pytest.raises(FileNotFoundError):
        punet_pseudo_prediction(str(tmp_path / "images"), str(out), port,
                                cellname="cellA", split_name="train", verbose=False)
    assert keep.exists()
