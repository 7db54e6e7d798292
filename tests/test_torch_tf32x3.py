"""The numerics of the ConvBlock kernels' tensor-core products (3xTF32),
on the CPU.

``round_tf32`` must be ``cvt.rna.tf32.f32`` bit for bit: hand-worked bit
patterns, ties included. Then the kernels' reductions are emulated in numpy:
each ``mma.sync.m16n8k8`` adds 8 exact TF32 products to its float32
accumulator with round-toward-zero (as the tensor cores do: one chain of
mma over K = 65,536 drifts by ~4e-4 on an H100), and the kernels run short
chains, each added into a float32 sum with round-to-nearest. Held against a
float64 reference over the wgrad's reduction at MT length (K = 65,536
pixels), the dgrad's (K = 9 * 512) and the forward's (K = 9 * 768 at the
512+256 -> 256 decoder block, K = 9 * 64 at level 0):

- the 3-term split with short chains stays within 1e-5 of the largest value;
- one TF32 product (1xTF32) does not, and neither does one long chain.

The MC-consensus kernel's mid layer (K = C = 64 or 32, one chain of C / 8
k-steps) is held closer: within 1e-6 of the largest value, so that a logit
moves by far less than the 1e-4 window around the consensus thresholds in
which the kernel and its plain version may disagree; 1xTF32 moves logits by
more than that window.
"""

import numpy as np
import pytest
import torch

from pda_torch.kernels.tf32x3 import round_tf32, split_tf32x3


def _bits(x: float) -> int:
    return int(np.array([x], np.float32).view(np.uint32)[0])


def _rounded_bits(bits: int) -> int:
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    return int(round_tf32(x).view(torch.int32).to(torch.int64)[0]) & 0xFFFFFFFF


@pytest.mark.parametrize("bits,expect", [
    (0x3F800000, 0x3F800000),  # 1.0: exact
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie with an even last bit: away from zero (RNE: down)
    (0x3F803000, 0x3F804000),  # a tie with an odd last bit: away from zero
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero, i.e. down
    (0x3FFFF000, 0x40000000),  # a tie that carries into the exponent: 2.0
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x7F7FF000, 0x7F800000),  # the largest finite tie rounds to inf
    (0x7F800000, 0x7F800000),  # inf passes
    (0x7FC00000, 0x7FC00000),  # NaN passes
])
def test_round_tf32_matches_cvt_rna_bit_patterns(bits, expect):
    assert _rounded_bits(bits) == expect


def test_round_tf32_is_the_nearest_tf32_value():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=100_000) * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    r = round_tf32(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits left
    ulp = torch.from_numpy(np.spacing(np.abs(r.numpy())).astype(np.float64) * 2.0 ** 13)
    assert bool(((r.double() - x.double()).abs() <= ulp / 2).all())


def test_split_tf32x3_keeps_float32_accuracy():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=100_000).astype(np.float32))
    hi, lo = split_tf32x3(x)
    assert torch.equal(hi, round_tf32(x)) and not (lo.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def _rz32(x: np.ndarray) -> np.ndarray:
    """float64 -> float32, rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _tc_matmul(a: np.ndarray, b: np.ndarray, terms: str, chain: int) -> np.ndarray:
    """a @ b (float32, K a multiple of 8) as the kernels form it: per 8-deep
    k-step the TF32 products of ``terms`` ("3x": lo*hi + hi*lo + hi*hi, in
    that order; "1x": hi*hi), each mma adding its 8 exact products into the
    chain with round-toward-zero; every ``chain`` k-steps (0: never) the chain
    is added into a float32 sum with round-to-nearest and restarts at 0."""
    (a_hi, a_lo), (b_hi, b_lo) = (tuple(t.numpy().astype(np.float64)
                                        for t in split_tf32x3(torch.from_numpy(m)))
                                  for m in (a, b))
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == "3x" else [(a_hi, b_hi)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    run = np.zeros_like(acc)
    for step in range(a.shape[1] // 8):
        k = slice(8 * step, 8 * step + 8)
        for pa, pb in pairs:
            run = _rz32(run.astype(np.float64) + pa[:, k] @ pb[k])
        if chain and (step + 1) % chain == 0:
            acc, run = acc + run, np.zeros_like(run)
    return acc + run


@pytest.mark.parametrize("what,k,terms,chain,within", [
    ("wgrad", 65_536, "3x", 8, True),    # the wgrad kernel: a chain per 8x8-pixel tile
    ("wgrad", 65_536, "1x", 8, False),
    ("wgrad", 65_536, "3x", 0, False),   # one long chain drifts
    ("dgrad", 9 * 512, "3x", 18, True),  # the dgrad kernel: a chain per 16-channel stage
    ("dgrad", 9 * 512, "1x", 18, False),
    ("dgrad", 9 * 512, "3x", 0, False),
    ("fwd", 9 * 768, "3x", 6, True),     # the forward kernel: a chain per 3 taps
    ("fwd", 9 * 768, "1x", 6, False),
    ("fwd", 9 * 768, "3x", 0, False),
    ("fwd", 9 * 64, "3x", 6, True),
    ("fwd", 9 * 64, "1x", 6, False),
    ("fwd", 9 * 64, "3x", 0, True),      # 72 k-steps: one chain still holds at this depth
])
def test_tc_product_against_float64(what, k, terms, chain, within):
    rng = np.random.default_rng(k)
    if what == "wgrad":  # post-ReLU activations times a masked cotangent
        a = np.maximum(rng.normal(size=(16, k)), 0.0).astype(np.float32)
        b = (rng.normal(size=(k, 8)) * (rng.random((k, 8)) > 0.5)).astype(np.float32)
    elif what == "dgrad":  # a masked cotangent times He-scaled weights
        a = (rng.normal(size=(16, k)) * (rng.random((16, k)) > 0.5)).astype(np.float32)
        b = (rng.normal(size=(k, 8)) * np.sqrt(2.0 / k)).astype(np.float32)
    else:  # post-ReLU activations times He-scaled weights
        a = np.maximum(rng.normal(size=(16, k)), 0.0).astype(np.float32)
        b = (rng.normal(size=(k, 8)) * np.sqrt(2.0 / k)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(_tc_matmul(a, b, terms, chain) - ref).max() / np.abs(ref).max()
    assert (err <= 1e-5) == within, err


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("terms", ["3x", "1x"])
def test_mc_mid_layer_product_against_float64(c, terms):
    """K3's mid layer as the kernel forms it: A = relu(feat + z_s) (float32),
    B = W_mid, one chain of C / 8 k-steps; then the logit relu(h + b) . w_last
    in float32, against the same layer and logit in float64."""
    rng = np.random.default_rng(c)
    feat = (rng.normal(size=(64, c)) * 2).astype(np.float32)
    z = rng.normal(size=c).astype(np.float32)
    a = np.maximum(feat + z, 0).astype(np.float32)
    w = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    w_last = (rng.normal(size=c) * 3 / np.sqrt(c)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    prod = _tc_matmul(a, w, terms, c // 8)
    err = np.abs(prod - ref).max() / np.abs(ref).max()
    logit = np.maximum(prod + bias, np.float32(0)) @ w_last
    logit_err = np.abs(logit - np.maximum(ref + bias, 0.0) @ w_last.astype(np.float64)).max()
    if terms == "3x":
        assert err <= 1e-6 and logit_err < 1e-4, (err, logit_err)
    else:
        assert err > 1e-6 and logit_err > 1e-4, (err, logit_err)
