"""Port tiling against pda: tile gather (with numpy reflect semantics, also
where the pad reaches past the whole dimension), stitch, per-tile
standardization and divisible padding."""

import jax.numpy as jnp
import numpy as np
import pytest

from pda.infer import tiling as jtiling
from pda_torch.infer import tiling as ttiling
from torch_port_utils import t

# (image H, W), block, halo; the second and third cases reflect-pad by at
# least the dimension (F.pad's reflect mode refuses that)
CASES = [
    ((40, 56), (32, 32), (16, 16)),
    ((5, 7), (8, 8), (6, 6)),
    ((3, 20), (4, 16), (5, 2)),
    ((64, 64), (64, 64), (0, 0)),
]


@pytest.mark.parametrize("shape,block,halo", CASES)
def test_extract_and_stitch_match_pda(shape, block, halo):
    h, w = shape
    # values encode the source index, so exact equality checks the indices
    img = np.arange(h * w * 2, dtype=np.float32).reshape(h, w, 2)
    ref = jtiling.extract_tiles(jnp.asarray(img), block, halo)
    tiles = ttiling.extract_tiles(t(img), block, halo)
    np.testing.assert_array_equal(tiles.numpy(), ref)
    out = ttiling.stitch_tiles(tiles * 2.0, shape, block, halo)
    np.testing.assert_array_equal(
        out.numpy(), jtiling.stitch_tiles(ref * 2.0, shape, block, halo))
    np.testing.assert_array_equal(out.numpy(), img * 2.0)


def test_tile_standardize_matches_pda():
    x = np.random.default_rng(1).normal(3.0, 2.0, size=(4, 16, 12, 1)).astype(np.float32)
    np.testing.assert_allclose(ttiling.tile_standardize(t(x)).numpy(),
                               jtiling.tile_standardize(jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("shape", [(50, 70), (5, 3), (16, 32)])
def test_pad_to_divisible_matches_pda(shape):
    img = np.random.default_rng(2).normal(size=(*shape, 1)).astype(np.float32)
    ref, ref_hw = jtiling.pad_to_divisible(jnp.asarray(img), (16, 16))
    out, hw = ttiling.pad_to_divisible(t(img), (16, 16))
    assert hw == ref_hw == shape
    np.testing.assert_array_equal(out.numpy(), ref)
