"""Weight bridge between ``pda`` parameter trees and the port's state dict.

The port names its parameters by the reference torch layout that
``pda/models/convert.py`` documents, so ``pda.models.convert.
convert_punet_state_dict(port.state_dict())`` maps port -> ``pda``.
:func:`state_dict_from_pda` is the other direction, with numpy only:

  unet/ConvBlock_{i}/Conv_{j}                 -> unet.contracting_path.{i}.layers.{k}
  unet/UpBlock_{i}/ConvBlock_0/Conv_{j}       -> unet.upsampling_path.{i}.conv_block.layers.{2j}
  unet/Conv_0 (PUNetBackbone's 1x1 head)      -> unet.last_layer
  {prior,posterior}/EncoderPyramid_0/...      -> {name}.encoder.layers.{k} (pools interleaved)
  {prior,posterior}/head                      -> {name}.conv_layer
  fcomb/feat_proj + fcomb/z_proj              -> fcomb.layers.0 (rows [features; z])
  fcomb/mid_{m}                               -> fcomb.layers.{2(m+1)}
  fcomb/last_layer                            -> fcomb.last_layer

HWIO kernels become (O, I, kh, kw); Dense kernels (I, O) become 1x1 convs.
A standalone ``PUNetBackbone``'s tree maps the same way without the
``unet`` prefix (:func:`backbone_state_dict_from_pda`).

:func:`unet_state_dict_from_pda` bridges ``pda``'s ``UNet2d`` to the port's,
whose names are torch_em's, the inverse of
``pda.models.convert.convert_unet_state_dict``:

  _DoubleConv_{i}, i < depth      -> encoder.blocks.{i}.block.{1,4}
  _DoubleConv_{depth}             -> base.block.{1,4}
  _DoubleConv_{depth + 1 + i}     -> decoder.blocks.{i}.block.{1,4}
  Conv_{i}, i < depth             -> decoder.samplers.{i}.conv
  Conv_{depth}                    -> out_conv

(block indices 0/2 instead of 1/4 without the norm layers).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32) for k, v in sd.items()}


def _backbone(sd: Dict, prefix: str, unet: Mapping) -> None:
    for i, key in enumerate(_indexed(unet, "ConvBlock")):
        _block(sd, f"{prefix}contracting_path.{i}.layers", unet[key], 1 if i > 0 else 0)
    for i, key in enumerate(_indexed(unet, "UpBlock")):
        _block(sd, f"{prefix}upsampling_path.{i}.conv_block.layers",
               unet[key]["ConvBlock_0"], 0)
    if "Conv_0" in unet:  # the optional 1x1 head
        sd[f"{prefix}last_layer.weight"] = _conv(unet["Conv_0"]["kernel"])
        sd[f"{prefix}last_layer.bias"] = np.asarray(unet["Conv_0"]["bias"])


def backbone_state_dict_from_pda(params: Mapping) -> Dict[str, torch.Tensor]:
    """``pda`` PUNetBackbone params (arrays) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    _backbone(sd, "", params)
    return _tensors(sd)


def state_dict_from_pda(params: Mapping) -> Dict[str, torch.Tensor]:
    """``pda`` ProbabilisticUnet params (arrays) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    _backbone(sd, "unet.", params["unet"])
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
    return _tensors(sd)


def unet_state_dict_from_pda(params: Mapping, norm: Optional[str] = "InstanceNorm"
                             ) -> Dict[str, torch.Tensor]:
    """``pda`` UNet2d params (arrays) -> the port's :class:`UNet2d` state
    dict. ``norm`` is the model's: its norm layers hold no weights, but they
    shift the convs' indices in each block (1/4 with, 0/2 without)."""
    depth = len(_indexed(params, "_DoubleConv")) // 2
    idx = (1, 4) if norm else (0, 2)
    sd: Dict[str, np.ndarray] = {}

    def block(prefix: str, tree: Mapping) -> None:
        for j, k in enumerate(idx):
            sd[f"{prefix}.block.{k}.weight"] = _conv(tree[f"Conv_{j}"]["kernel"])
            sd[f"{prefix}.block.{k}.bias"] = np.asarray(tree[f"Conv_{j}"]["bias"])

    for i in range(depth):
        block(f"encoder.blocks.{i}", params[f"_DoubleConv_{i}"])
        block(f"decoder.blocks.{i}", params[f"_DoubleConv_{depth + 1 + i}"])
        sd[f"decoder.samplers.{i}.conv.weight"] = _conv(params[f"Conv_{i}"]["kernel"])
        sd[f"decoder.samplers.{i}.conv.bias"] = np.asarray(params[f"Conv_{i}"]["bias"])
    block("base", params[f"_DoubleConv_{depth}"])
    sd["out_conv.weight"] = _conv(params[f"Conv_{depth}"]["kernel"])
    sd["out_conv.bias"] = np.asarray(params[f"Conv_{depth}"]["bias"])
    return _tensors(sd)
