"""The float32 -> TF32 rounding of the backward kernels' 3xTF32 products,
in plain PyTorch.

The tensor cores take TF32 operands: float32 with 10 of its 23 mantissa
bits. ``csrc/tf32x3.cuh`` splits each float32 operand into
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` with ``cvt.rna.tf32.f32`` (round
to nearest, ties away from zero) and forms a product as
``lo_a*hi_b + hi_a*lo_b + hi_a*hi_b``: the ``lo*lo`` term it drops is about
2^-22 of the product, so the result keeps float32's accuracy where one
``hi*hi`` product (1xTF32) keeps about three decimal digits.
:func:`round_tf32` is ``cvt.rna.tf32.f32`` bit for bit, so the tests can
hold the split to a float64 reference on the CPU.
"""

from __future__ import annotations

import torch

_HALF_ULP = 0x1000  # half a unit of the 10th mantissa bit
_DROP = -0x2000  # as int32: 0xFFFFE000, keeps sign, exponent, 10 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32
    with the low 13 mantissa bits zero; inf and NaN pass unchanged."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    # sign-magnitude: adding half an ulp to the magnitude bits rounds the
    # magnitude half up, i.e. ties away from zero; a carry into the exponent
    # is the correct rounding up to the next binade
    rounded = ((bits + _HALF_ULP) & _DROP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32x3(x: torch.Tensor) -> tuple:
    """``(hi, lo)``: ``hi = round_tf32(x)``, ``lo = round_tf32(x - hi)``."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)
