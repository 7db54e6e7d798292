"""MC-8 panels of one image from a source PUNet checkpoint (``pda``'s
``development/plot_livecell.py``).

    python -m pda_torch.tools.plot_livecell --image IMG --checkpoint CKPT
        [--out ./livecell_panels.png] [--n_samples 8] [--device cuda|cpu]

``--image`` is a TIFF or PNG (:func:`read_frame`: its first channel),
``--checkpoint`` a checkpoint directory (its ``best.pt``) or a ``.pt`` file
whose ``model_state`` is a flagship PUNet's (``livecell_punet``). The image
is standardized and reflect-padded to a multiple of 16, encoded once, and
``n_samples`` prior latents are decoded by the plain MC tail
(``mc_decode_logits``: each sample's logits, which the MC-consensus kernel
does not give); the noise comes from a ``torch.Generator`` seeded 0 on the
run's device. On the card the encoder runs the ConvBlock kernels (8
``conv_block_fwd``, 3 ``conv_block_fwd_dual`` launches a frame).

The figure is one RGB PNG written by the port's own codec, ``pda``'s grid
without matplotlib: 2 rows of ``max(3, (n + 1) // 2)`` panels of the
frame's size with a white gap, in ``pda``'s order: the input after CLAHE
(:func:`clahe`, bit for bit ``cv2``'s) in ``gray`` from its own minimum to
maximum, the mean prediction in ``viridis`` and the consensus in ``magma``
over [0, 1], then the samples in ``viridis``. As in ``pda`` only the cells
left after the first three show samples (with n = 8: samples 1-5). No
titles: the tool prints the panel order, a result line and ``pda``'s
``saved panels to <out>``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .colormaps import colorize
from .common import add_device_arg, card, tool_device

CLIP_LIMIT, TILE_GRID = 2.0, (8, 8)  # pda's cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
DIVISOR = (16, 16)
GAP = 4  # white pixels between panels
NOISE_SEED = 0


def read_frame(path: str) -> np.ndarray:
    """The image as float32 (H, W): a TIFF or PNG through the port's codecs,
    the first channel of a 3-D one."""
    from ..data.tiff import read_image

    img = np.asarray(read_image(path)).astype(np.float32)
    return img[..., 0] if img.ndim == 3 else img


def standardize(img: np.ndarray) -> np.ndarray:
    """``pda``'s ``(img - img.mean()) / (img.std() + 1e-7)`` in float32."""
    return (img - img.mean()) / (img.std() + 1e-7)


def load_model(checkpoint: str, device):
    """The flagship PUNet with the checkpoint's ``model_state``, in eval
    mode on ``device``."""
    from ..models.punet import livecell_punet
    from ..train.checkpoint import load_params

    model = livecell_punet(device=device)
    model.load_state_dict(load_params(checkpoint))
    return model.eval()


class Samples(NamedTuple):
    """Each (n, H, W) or (H, W), float32, cropped to the image."""

    logits: np.ndarray
    probs: np.ndarray
    pseudo: np.ndarray  # the mean of the samples' sigmoids
    consensus: np.ndarray  # the share of samples beyond a threshold (no masking)


@torch.no_grad()
def sample(model, norm: np.ndarray, n_samples: int, *, eps: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> Samples:
    """Encode the standardized image (reflect-padded to a multiple of 16),
    decode ``n_samples`` prior latents with the plain MC tail, then the
    pseudo-label and the consensus. The noise is ``eps`` (n, 1, latent) or a
    draw from ``generator``."""
    from ..core.consensus import consensus_from_logits
    from ..infer.tiling import pad_to_divisible
    from ..models.punet import mc_decode_logits

    dev = next(model.parameters()).device
    padded, (h, w) = pad_to_divisible(torch.from_numpy(norm[..., None]).to(dev), DIVISOR)
    enc = model.encode(padded[None])
    logits = mc_decode_logits(model, enc.features, enc.prior, n_samples, eps=eps,
                              generator=generator)
    pseudo, consensus = consensus_from_logits(logits)
    logits = logits[:, 0, :h, :w, 0]
    return Samples(*(t.cpu().numpy() for t in (logits, torch.sigmoid(logits),
                                               pseudo[0, :h, :w, 0], consensus[0, :h, :w, 0])))


def _reflect101(n_out: int, n: int) -> np.ndarray:
    """OpenCV's ``borderInterpolate(p, n, BORDER_REFLECT_101)`` of p = 0 ..
    n_out - 1 (reflections repeated past the far edge; 0 where n = 1)."""
    if n == 1:
        return np.zeros(n_out, np.int64)
    p = np.arange(n_out) % (2 * n - 2)
    return np.where(p < n, p, 2 * n - 2 - p)


def equalize(u8: np.ndarray) -> np.ndarray:
    """``cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(u8)`` of
    a 2-D uint8 image, in OpenCV's arithmetic:

      tiles     an image the grid does not divide is extended by
                BORDER_REFLECT_101 to the next multiple in both directions
                (a side it divides gains a whole tile's width) for the
                histograms only
      clip      at ``max(int(2.0 * area / 256), 1)``; the excess spread
                evenly over the 256 bins, its residual one count a bin from
                bin 0 at a stride of ``max(256 // residual, 1)``
      LUT       ``saturate_cast<uchar>(cdf * (255.0f / area))`` in float32
      blend     bilinear between the four nearest tiles' LUTs, in float32,
                ``(l11 * xa1 + l12 * xa) * ya1 + (l21 * xa1 + l22 * xa) * ya``,
                rounded half to even"""
    h, w = u8.shape
    gy, gx = TILE_GRID
    if h % gy or w % gx:
        ext = u8[_reflect101(h + gy - h % gy, h)[:, None],
                 _reflect101(w + gx - w % gx, w)[None, :]]
    else:
        ext = u8
    th, tw = ext.shape[0] // gy, ext.shape[1] // gx
    area = th * tw
    tiles = ext.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3).reshape(gy * gx, area)
    hist = np.bincount((np.arange(gy * gx)[:, None] * 256 + tiles).ravel(),
                       minlength=gy * gx * 256).reshape(gy * gx, 256)
    limit = max(int(CLIP_LIMIT * area / 256), 1)
    clipped = np.maximum(hist - limit, 0).sum(axis=1)
    hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
    residual = (clipped % 256)[:, None]
    stride = np.maximum(256 // np.maximum(residual, 1), 1)
    bins = np.arange(256)[None, :]
    hist += (residual > 0) & (bins % stride == 0) & (bins // stride < residual)
    scale = np.float32(255) / np.float32(area)
    lut = np.clip(np.rint(np.cumsum(hist, axis=1).astype(np.float32) * scale), 0, 255)
    lut = lut.astype(np.float32).reshape(gy, gx, 256)

    def axis(n, size, tiles_n):
        f = np.arange(n, dtype=np.float32) * (np.float32(1) / np.float32(size)) - np.float32(0.5)
        lo = np.floor(f).astype(np.int64)
        frac = f - lo.astype(np.float32)
        return (np.maximum(lo, 0), np.minimum(lo + 1, tiles_n - 1), frac,
                np.float32(1) - frac)

    y1, y2, ya, ya1 = (a[:, None] for a in axis(h, th, gy))
    x1, x2, xa, xa1 = (a[None, :] for a in axis(w, tw, gx))
    v = u8.astype(np.int64)
    res = ((lut[y1, x1, v] * xa1 + lut[y1, x2, v] * xa) * ya1
           + (lut[y2, x1, v] * xa1 + lut[y2, x2, v] * xa) * ya)
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def clahe(img: np.ndarray) -> np.ndarray:
    """``pda``'s display contrast: the image scaled to uint8 by ``pda``'s
    expression in float32, ``((img - min) / (ptp + 1e-7) * 255)`` cast with
    ``astype("uint8")``, then :func:`equalize`."""
    img = np.asarray(img, np.float32)
    u8 = ((img - img.min()) / (np.ptp(img) + 1e-7) * 255).astype("uint8")
    return equalize(u8)


def grid_shape(n_samples: int) -> Tuple[int, int]:
    """``pda``'s ``plt.subplots(2, max(3, (n + 1) // 2))``."""
    return 2, max(3, (n_samples + 1) // 2)


def figure(img: np.ndarray, s: Samples, n_samples: int) -> Tuple[np.ndarray, List[str]]:
    """(the RGB uint8 grid, the panels' names in order): ``pda``'s panels
    and colour maps; cells without a panel stay white."""
    rows, cols = grid_shape(n_samples)
    enhanced = clahe(img)
    panels = [("input (CLAHE)", colorize(enhanced, "gray", enhanced.min(), enhanced.max())),
              ("mean prediction", colorize(s.pseudo, "viridis", 0, 1)),
              ("consensus response", colorize(s.consensus, "magma", 0, 1))]
    panels += [(f"sample {i + 1}", colorize(s.probs[i], "viridis", 0, 1))
               for i in range(min(n_samples, rows * cols - 3))]
    h, w = img.shape
    grid = np.full((rows * h + (rows - 1) * GAP, cols * w + (cols - 1) * GAP, 3), 255, np.uint8)
    for k, (_, rgb) in enumerate(panels):
        r, c = divmod(k, cols)
        grid[r * (h + GAP):r * (h + GAP) + h, c * (w + GAP):c * (w + GAP) + w] = rgb
    return grid, [name for name, _ in panels]


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", type=str, required=True, help="Input TIFF/PNG")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Checkpoint dir (with best.pt) or .pt file of a source PUNet")
    parser.add_argument("--out", type=str, default="./livecell_panels.png")
    parser.add_argument("--n_samples", type=int, default=8)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = tool_device(args.device, "plot_livecell")
    from ..data import png
    from . import ab

    t0 = time.perf_counter()
    img = read_frame(args.image)
    model = load_model(args.checkpoint, dev)
    wrappers = ab.kernel_wrappers()
    ab.reset_launches(wrappers)
    out = sample(model, standardize(img), args.n_samples,
                 generator=torch.Generator(device=dev).manual_seed(NOISE_SEED))
    launches = ab.read_launches(wrappers) if dev.type == "cuda" else None
    grid, names = figure(img, out, args.n_samples)
    png.imwrite(args.out, grid)
    print("panels: " + ", ".join(names))
    result = {"image": list(img.shape), "grid": list(grid.shape), "panels": names,
              "n_samples": args.n_samples, "seconds": time.perf_counter() - t0,
              "launches": launches, "card": card(dev)}
    print("plot_livecell result " + json.dumps(result))
    print(f"saved panels to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
