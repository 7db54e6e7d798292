"""Serving path (port of ``pda/infer/predict.py``).

Array-level entries, on the device the model and image live on:
  tiled_punet_probs  — tiled (block + halo) MC-N mean probability map
  full_punet_pseudo  — whole-frame MC-N pseudo-label + consensus
  tiled_unet_probs   — tiled UNet2d probability map
  padded_unet_probs  — whole-frame UNet2d probability map
File-level entries, same directory contract as ``pda``, TIFFs through the
port's codec (:mod:`pda_torch.data.tiff`):
  punet_prediction        — per image a float32 probability TIFF
  punet_pseudo_prediction — annotations/<split>/<cell>/ (float pseudo-labels)
                            and consensus/<split>/<cell>/ (uint8 0/1)
  unet_prediction         — per image a float32 probability TIFF, tiled or
                            padded

Noise: ``eps`` is the ``(n_samples, batch, latent_dim)`` standard-normal
draw of the latent samples, or a ``torch.Generator`` to draw it from.

The PUNet entries compute in the model's dtype (a bf16 model runs the bf16
kernels); probabilities and pseudo-labels leave as float32, as in ``pda``.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..data.tiff import read_image, write_image
from ..models.punet import ProbabilisticUnet, mc_pseudo
from ..utils import clean_folder
from .tiling import (extract_tiles, grid_shape, pad_to_divisible, stitch_tiles,
                     tile_standardize)

BLOCK_SHAPE = (384, 384)  # reference punet_predictions.py:44
HALO = (64, 64)  # reference punet_predictions.py:45

Noise = Union[torch.Tensor, torch.Generator]


def _noise(eps: Noise):
    return (None, eps) if isinstance(eps, torch.Generator) else (eps, None)


@torch.inference_mode()
def tiled_punet_probs(model: ProbabilisticUnet, image: torch.Tensor, eps: Noise,
                      n_samples: int, block: Tuple[int, int] = BLOCK_SHAPE,
                      halo: Tuple[int, int] = HALO) -> torch.Tensor:
    """(H, W, C) image -> (H, W, 1) mean MC probability map: gather the
    tiles, standardize each, encode the tile batch, MC-N mean through the
    MC-consensus kernel, stitch. ``eps``: (n_samples, n_tiles, latent_dim)."""
    tiles = tile_standardize(extract_tiles(image, block, halo))
    e, g = _noise(eps)
    probs, _ = mc_pseudo(model, tiles, n_samples, eps=e, generator=g)
    return stitch_tiles(probs, image.shape[:2], block, halo)


@torch.inference_mode()
def full_punet_pseudo(model: ProbabilisticUnet, image: torch.Tensor, eps: Noise,
                      n_samples: int, masking: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-image MC-N pseudo-label + consensus, each (H, W, 1): standardize
    the frame, reflect-pad to a multiple of 16, one batch of 1. ``eps``:
    (n_samples, 1, latent_dim)."""
    padded, (h, w) = pad_to_divisible(_standardize(image), (16, 16))
    e, g = _noise(eps)
    pseudo, consensus = mc_pseudo(model, padded[None], n_samples, eps=e, generator=g,
                                  masking=masking)
    return pseudo[0, :h, :w], consensus[0, :h, :w]


def _standardize(image: torch.Tensor) -> torch.Tensor:
    """Whole-frame (x - mean) / (population std + 1e-7)."""
    centered = image - image.mean()
    return centered / (centered.std(correction=0) + 1e-7)


@torch.inference_mode()
def tiled_unet_probs(model: torch.nn.Module, image: torch.Tensor,
                     block: Tuple[int, int] = BLOCK_SHAPE,
                     halo: Tuple[int, int] = HALO) -> torch.Tensor:
    """(H, W, C) image -> (H, W, out_channels) UNet2d output: gather the
    tiles, standardize each, one forward of the tile batch, stitch."""
    tiles = tile_standardize(extract_tiles(image, block, halo))
    return stitch_tiles(model(tiles), image.shape[:2], block, halo)


@torch.inference_mode()
def padded_unet_probs(model: torch.nn.Module, image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) image -> (H, W, out_channels): standardize the frame,
    reflect-pad to a multiple of 16, one forward, crop."""
    padded, (h, w) = pad_to_divisible(_standardize(image), (16, 16))
    return model(padded[None])[0, :h, :w]


def _read_image(path: str) -> np.ndarray:
    img = read_image(path).astype(np.float32)
    if img.ndim == 3:  # RGB(A) -> first channel (reference data is grayscale)
        img = img[..., 0]
    return img


_IMAGE_EXTS = (".tif", ".tiff", ".png", ".bmp")


def _glob_images(pattern: str, search_subfolders: bool = False):
    """Glob input images, expanding any matched directory to its images
    (LIVECell keeps images in per-cell-type folders). With
    ``search_subfolders`` a pattern that matches nothing is tried one folder
    down, so ``.../livecell_test_images/A172*.tif`` finds
    ``.../livecell_test_images/A172/A172_*.tif``; ``pda`` has no such rule
    and finds no image there."""
    matched = sorted(glob(pattern))
    if not matched and search_subfolders:
        head, tail = os.path.split(pattern)
        matched = sorted(glob(os.path.join(head, "*", tail)))
    paths = []
    for p in matched:
        if os.path.isdir(p):
            paths.extend(sorted(q for q in glob(os.path.join(p, "*"))
                                if q.lower().endswith(_IMAGE_EXTS)))
        else:
            paths.append(p)
    return paths


def _write_tiff(path: str, data: np.ndarray):
    write_image(path, data)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def punet_prediction(input_image_path: str, output_pred_path: str,
                     model: ProbabilisticUnet, *, prior_samples: int = 8,
                     block_shape: Tuple[int, int] = BLOCK_SHAPE,
                     halo: Tuple[int, int] = HALO, seed: int = 0, verbose: bool = True,
                     search_subfolders: bool = False):
    """Glob input images -> per image a tiled MC-mean probability TIFF
    (``search_subfolders``: see :func:`_glob_images`)."""
    os.makedirs(output_pred_path, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    dev = _device(model)
    for img_path in _glob_images(input_image_path, search_subfolders):
        img = torch.from_numpy(_read_image(img_path)[..., None]).to(dev)
        gy, gx = grid_shape(img.shape[:2], block_shape)
        eps = torch.randn((prior_samples, gy * gx, model.latent_dim), generator=gen)
        pred = tiled_punet_probs(model, img, eps.to(dev), prior_samples, block_shape, halo)
        stem = os.path.splitext(os.path.basename(img_path))[0]
        out = os.path.join(output_pred_path, f"{stem}.tif")
        _write_tiff(out, pred[..., 0].cpu().numpy().astype(np.float32))
        if verbose:
            print(f"Saved image at '{out}'")


def punet_pseudo_prediction(input_image_path: str, output_pred_path: str,
                            model: ProbabilisticUnet, *, prior_samples: int = 8,
                            cellname: Optional[str] = None, split_name: Optional[str] = None,
                            seed: int = 0, verbose: bool = True):
    """Pseudo-label + consensus export for target training: float
    pseudo-labels to ``annotations/<split>/<cell>/``, unanimity consensus
    masks (uint8 0/1) to ``consensus/<split>/<cell>/``."""
    os.makedirs(output_pred_path, exist_ok=True)
    if cellname and os.path.isdir(os.path.join(input_image_path, cellname)):
        pattern = os.path.join(input_image_path, cellname, f"{cellname}*.tif")
    else:
        pattern = os.path.join(input_image_path, f"{cellname or ''}*.tif")
    image_paths = sorted(glob(pattern))
    if not image_paths:
        # fail BEFORE the folders are cleaned: an empty glob must not leave
        # an empty pseudo-label tree for target training
        raise FileNotFoundError(f"no input images match {pattern!r} — nothing to pseudo-label")
    dir1 = os.path.join(output_pred_path, "annotations", split_name or "", cellname or "")
    dir2 = os.path.join(output_pred_path, "consensus", split_name or "", cellname or "")
    for d in (dir1, dir2):
        os.makedirs(d, exist_ok=True)
        clean_folder(d)
    gen = torch.Generator().manual_seed(seed)
    dev = _device(model)
    for img_path in image_paths:
        img_name = os.path.basename(img_path)
        img = torch.from_numpy(_read_image(img_path)[..., None]).to(dev)
        eps = torch.randn((prior_samples, 1, model.latent_dim), generator=gen)
        pseudo, consensus = full_punet_pseudo(model, img, eps.to(dev), prior_samples, True)
        _write_tiff(os.path.join(dir1, img_name), pseudo[..., 0].cpu().numpy())
        _write_tiff(os.path.join(dir2, img_name),
                    consensus[..., 0].cpu().numpy().astype("uint8"))
        if verbose:
            print(f"{img_name}'s predictions saved")


def unet_prediction(input_path: str, output_path: str, model: torch.nn.Module, *,
                    tiling: bool = True, block_shape: Tuple[int, int] = BLOCK_SHAPE,
                    halo: Tuple[int, int] = HALO, verbose: bool = True,
                    search_subfolders: bool = False):
    """Deterministic UNet inference: glob input images -> per image a
    float32 probability TIFF, tiled (:func:`tiled_unet_probs`) or padded
    (:func:`padded_unet_probs`), on the model's device
    (``search_subfolders``: see :func:`_glob_images`)."""
    os.makedirs(output_path, exist_ok=True)
    dev = _device(model)
    for img_path in _glob_images(input_path, search_subfolders):
        img = torch.from_numpy(_read_image(img_path)[..., None]).to(dev)
        pred = (tiled_unet_probs(model, img, block_shape, halo) if tiling
                else padded_unet_probs(model, img))
        stem = os.path.splitext(os.path.basename(img_path))[0]
        out = os.path.join(output_path, f"{stem}.tif")
        _write_tiff(out, pred[..., 0].cpu().numpy().astype(np.float32))
        if verbose:
            print(f"Saved image at '{out}'")
