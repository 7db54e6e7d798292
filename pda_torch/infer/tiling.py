"""Tile + halo decomposition for full-frame inference (port of
``pda/infer/tiling.py``).

The frame is reflect-padded to whole blocks plus the halo margin and every
overlapping tile is gathered as one batch by a single indexed read, on
whatever device the image lives; :func:`stitch_tiles` crops the halos and
reassembles the frame.

Reflect padding follows numpy's (and ``jnp.pad``'s) semantics, which keep
reflecting when a pad is at least as long as the dimension; ``F.pad``
refuses that case, so the indices come from ``np.pad`` on an index ramp.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def grid_shape(image_shape: Tuple[int, int], block: Tuple[int, int]) -> Tuple[int, int]:
    return (math.ceil(image_shape[0] / block[0]), math.ceil(image_shape[1] / block[1]))


def reflect_indices(n: int, before: int, after: int) -> np.ndarray:
    """Source index of every position of a reflect-padded axis of length n."""
    return np.pad(np.arange(n), (before, after), mode="reflect")


def extract_tiles(image: torch.Tensor, block: Tuple[int, int],
                  halo: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) -> (n_tiles, bh + 2*hh, bw + 2*hw, C), tiles in row-major
    grid order (as :func:`stitch_tiles` expects)."""
    h, w, _ = image.shape
    (bh, bw), (hh, hw) = block, halo
    gy, gx = grid_shape((h, w), block)
    rows = reflect_indices(h, hh, gy * bh - h + hh)
    cols = reflect_indices(w, hw, gx * bw - w + hw)
    # tile t of the grid covers padded rows [ty*bh, ty*bh + bh + 2*hh)
    tile_rows = np.stack([rows[i * bh: i * bh + bh + 2 * hh] for i in range(gy)])
    tile_cols = np.stack([cols[i * bw: i * bw + bw + 2 * hw] for i in range(gx)])
    r = torch.from_numpy(tile_rows).to(image.device)[:, None, :, None]
    c = torch.from_numpy(tile_cols).to(image.device)[None, :, None, :]
    tiles = image[r, c]  # (gy, gx, th, tw, C)
    return tiles.reshape(gy * gx, *tiles.shape[2:])


def stitch_tiles(tile_outputs: torch.Tensor, image_shape: Tuple[int, int],
                 block: Tuple[int, int], halo: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`extract_tiles`: crop each tile's halo, reassemble the
    block grid, crop the padding -> (H, W, C)."""
    h, w = image_shape
    (bh, bw), (hh, hw) = block, halo
    gy, gx = grid_shape((h, w), block)
    c = tile_outputs.shape[-1]
    centers = tile_outputs[:, hh: hh + bh, hw: hw + bw, :]
    full = centers.reshape(gy, gx, bh, bw, c).permute(0, 2, 1, 3, 4)
    return full.reshape(gy * bh, gx * bw, c)[:h, :w, :]


def tile_standardize(tiles: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-tile (x - mean) / (population std + eps)."""
    mean = tiles.mean(dim=(1, 2, 3), keepdim=True)
    centered = tiles - mean
    std = centered.std(dim=(1, 2, 3), keepdim=True, correction=0)
    return centered / (std + eps)


def pad_to_divisible(image: torch.Tensor,
                     divisor: Tuple[int, int]) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Reflect-pad (H, W, C) at the bottom/right so H and W divide
    ``divisor``; returns the padded image and the original (H, W)."""
    h, w, _ = image.shape
    ph = (divisor[0] - h % divisor[0]) % divisor[0]
    pw = (divisor[1] - w % divisor[1]) % divisor[1]
    rows = torch.from_numpy(reflect_indices(h, 0, ph)).to(image.device)
    cols = torch.from_numpy(reflect_indices(w, 0, pw)).to(image.device)
    return image[rows[:, None], cols[None, :]], (h, w)
