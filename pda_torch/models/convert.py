"""Weight bridge between ``pda`` parameter trees and the port's state dict.

The port names its parameters by the reference torch layout that
``pda/models/convert.py`` documents, so ``pda.models.convert.
convert_punet_state_dict(port.state_dict())`` maps port -> ``pda``.
:func:`state_dict_from_pda` is the other direction, with numpy only:

  unet/ConvBlock_{i}/Conv_{j}                 -> unet.contracting_path.{i}.layers.{k}
  unet/UpBlock_{i}/ConvBlock_0/Conv_{j}       -> unet.upsampling_path.{i}.conv_block.layers.{2j}
  {prior,posterior}/EncoderPyramid_0/...      -> {name}.encoder.layers.{k} (pools interleaved)
  {prior,posterior}/head                      -> {name}.conv_layer
  fcomb/feat_proj + fcomb/z_proj              -> fcomb.layers.0 (rows [features; z])
  fcomb/mid_{m}                               -> fcomb.layers.{2(m+1)}
  fcomb/last_layer                            -> fcomb.last_layer

HWIO kernels become (O, I, kh, kw); Dense kernels (I, O) become 1x1 convs.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(k) -> np.ndarray:
    return np.asarray(k).transpose(3, 2, 0, 1)


def _dense(k) -> np.ndarray:
    return np.asarray(k).T[:, :, None, None]


def _block(sd: Dict, prefix: str, block: Mapping, first: int) -> None:
    for j in range(len(block)):
        conv = block[f"Conv_{j}"]
        sd[f"{prefix}.{first + 2 * j}.weight"] = _conv(conv["kernel"])
        sd[f"{prefix}.{first + 2 * j}.bias"] = np.asarray(conv["bias"])


def _indexed(tree: Mapping, stem: str) -> list:
    """Keys ``{stem}_{i}`` in numeric order."""
    keys = [k for k in tree if k.startswith(stem + "_")]
    return sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))


def state_dict_from_pda(params: Mapping) -> Dict[str, torch.Tensor]:
    """``pda`` ProbabilisticUnet params (arrays) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    unet = params["unet"]
    for i, key in enumerate(_indexed(unet, "ConvBlock")):
        _block(sd, f"unet.contracting_path.{i}.layers", unet[key], 1 if i > 0 else 0)
    for i, key in enumerate(_indexed(unet, "UpBlock")):
        _block(sd, f"unet.upsampling_path.{i}.conv_block.layers",
               unet[key]["ConvBlock_0"], 0)
    for name in ("prior", "posterior"):
        pyramid = params[name]["EncoderPyramid_0"]
        idx = 0
        for i, key in enumerate(_indexed(pyramid, "ConvBlock")):
            idx += i > 0  # the AvgPool before every block but the first
            _block(sd, f"{name}.encoder.layers", pyramid[key], idx)
            idx += 2 * len(pyramid[key])
        head = params[name]["head"]
        sd[f"{name}.conv_layer.weight"] = _dense(head["kernel"])
        sd[f"{name}.conv_layer.bias"] = np.asarray(head["bias"])
    fc = params["fcomb"]
    sd["fcomb.layers.0.weight"] = _dense(
        np.concatenate([np.asarray(fc["feat_proj"]["kernel"]),
                        np.asarray(fc["z_proj"]["kernel"])], axis=0))
    sd["fcomb.layers.0.bias"] = np.asarray(fc["z_proj"]["bias"])
    for m, key in enumerate(_indexed(fc, "mid")):
        sd[f"fcomb.layers.{2 * (m + 1)}.weight"] = _dense(fc[key]["kernel"])
        sd[f"fcomb.layers.{2 * (m + 1)}.bias"] = np.asarray(fc[key]["bias"])
    sd["fcomb.last_layer.weight"] = _dense(fc["last_layer"]["kernel"])
    sd["fcomb.last_layer.bias"] = np.asarray(fc["last_layer"]["bias"])
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in sd.items()}
