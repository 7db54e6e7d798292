"""The bf16 MC tail's packed layer entry rounds as ``pda`` does.

``csrc/mc_consensus.cu`` (``mc_consensus_wgmma``) forms ``relu(feat + z)``
of two bf16 values with one ``fma.rn.relu.bf16x2`` (``feat * 1 + z``): the
exact sum rounded once to bf16 (to nearest even), then ReLU. ``pda``'s
kernel (``pda/kernels/mc_consensus.py`` ``_kernel``) adds the two bf16
values in float32, rounds the sum to bf16 and takes the ReLU (the port's
plain version takes the ReLU before the rounding). Over every finite bf16
``feat`` value against seeded sets of bf16 ``z`` values (opposite signs of
one magnitude, exponent gaps up to and past 24, subnormals), the float32
path, with the ReLU before or after its rounding, gives the bits of the
exact sum rounded once: a sum of two bf16 values rounded to float32's 24
bits and then to bf16's 8 lands where one rounding to 8 bits lands.

The exact sum is formed in integers and rounded to nearest even on its
bits, never through float32. Each case runs in a fresh interpreter that
imports numpy alone, so that no native library in the test process can set
flush-to-zero or denormals-are-zero under the subnormal cases (the card
holds the kernel's own entry to the same float32 path: ``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import json
import subprocess
import sys

import numpy as np
import pytest

CASES = ("normals", "opposite", "gaps", "subnormals")


def _finite_bf16() -> np.ndarray:
    """Every finite bf16 bit pattern (uint16), subnormals and both zeros."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    return bits[(bits & 0x7F80) != 0x7F80].astype(np.uint16)


def _to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 bits (to nearest even, on the bits)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _f32(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << 16).view(np.float32)


def _relu_bits(b: np.ndarray) -> np.ndarray:
    """ReLU on bf16 bits: negative values and both zeros to +0."""
    neg = (b & 0x8000) != 0
    zero = (b & 0x7FFF) == 0
    return np.where(neg | zero, 0, b).astype(np.uint16)


def float32_path(f: np.ndarray, z: np.ndarray, relu_first: bool) -> np.ndarray:
    """pda's entry: the float32 sum of the two bf16 values, rounded to bf16,
    with the ReLU before or after the rounding."""
    with np.errstate(over="ignore"):
        s = _f32(f) + _f32(z)
    if relu_first:
        return _relu_bits(_to_bf16(np.where(s > 0, s, np.float32(0))))
    return _relu_bits(_to_bf16(s))


def exact_path(f: np.ndarray, z: np.ndarray) -> np.ndarray:
    """The exact sum of the two bf16 values rounded once to bf16 (to nearest
    even), then ReLU: the integer significands aligned, summed, and rounded
    on their bits."""
    def split(b):
        b = b.astype(np.int64)
        e, m = (b >> 7) & 0xFF, b & 0x7F
        mag = np.where(e == 0, m, m + 128)          # value = mag * 2^exp
        exp = np.where(e == 0, -133, e - 134)
        return np.where(b & 0x8000, -mag, mag), exp

    m1, e1 = split(f)
    m2, e2 = split(z)
    # past a gap of 40 the smaller operand lies far inside half an ulp of the
    # larger: it only says on which side, which a unit 2^(big - 40) says too
    big1 = (e1 >= e2) | (m2 == 0)
    far = np.abs(e1 - e2) > 40
    nz1, nz2 = m1 != 0, m2 != 0
    m2 = np.where(far & big1 & nz2, np.sign(m2), m2)
    e2 = np.where(far & big1 & nz2, e1 - 40, e2)
    m1 = np.where(far & ~big1 & nz1, np.sign(m1), m1)
    e1 = np.where(far & ~big1 & nz1, e2 - 40, e1)
    e = np.minimum(np.where(nz1, e1, e2), np.where(nz2, e2, e1))
    total = (m1 << np.maximum(e1 - e, 0)) + (m2 << np.maximum(e2 - e, 0))
    a = np.abs(total)
    length = np.frexp(a.astype(np.float64))[1]      # bits of a (a < 2^50)
    shift = np.maximum(np.maximum(length - 8, -133 - e), 0)
    r = a >> shift
    rem = a - (r << shift)
    half = np.where(shift > 0, np.left_shift(1, np.maximum(shift - 1, 0)), 1 << 62)
    r = r + ((rem > half) | ((rem == half) & (r & 1 == 1)))
    value = np.ldexp(r.astype(np.float64), e + shift)
    with np.errstate(over="ignore"):
        v32 = np.where(value >= 2.0 ** 128, np.float32(np.inf), value.astype(np.float32))
    bits = (v32.view(np.uint32) >> 16).astype(np.uint16)
    return _relu_bits(np.where(total < 0, bits | 0x8000, bits).astype(np.uint16))


def pairs(case: str, rng: np.random.Generator):
    """(feat, z) bf16 bits: every finite feat value against the case's z."""
    f = _finite_bf16()
    if case == "normals":  # seeded normals over 120 binades
        z = _to_bf16(rng.normal(size=24) * 10.0 ** rng.uniform(-18, 18, size=24))
        return np.repeat(f, z.size), np.tile(z, f.size)
    if case == "opposite":  # -feat, and -feat one ulp either way
        zs = [f ^ 0x8000, (f ^ 0x8000) + 1, (f ^ 0x8000) - 1]
        ff = np.concatenate([f] * 3)
        zz = np.concatenate(zs).astype(np.uint16)
        keep = (zz & 0x7F80) != 0x7F80
        return ff[keep], zz[keep]
    if case == "gaps":  # z = +-feat * 2^-k, k up to and past 24
        ff, zz = [], []
        for k in (7, 8, 9, 16, 23, 24, 25, 26, 33, 60, 127):
            for sign in (1.0, -1.0):
                with np.errstate(under="ignore"):
                    z = _to_bf16(sign * np.ldexp(_f32(f).astype(np.float64), -k)
                                 .astype(np.float32))
                ff.append(f)
                zz.append(z)
        return np.concatenate(ff), np.concatenate(zz)
    if case == "subnormals":  # subnormals and the least normals, both signs, as z
        edge = np.array([0x0001, 0x0002, 0x0003, 0x0010, 0x003F, 0x0040, 0x0041, 0x007F,
                         0x0080, 0x0081], dtype=np.uint16)
        z = np.concatenate([edge, edge | 0x8000, _to_bf16(rng.normal(size=4) * 2.0 ** -130)])
        return np.repeat(f, z.size), np.tile(z, f.size)
    raise ValueError(case)


def run_case(case: str) -> dict:
    """The case's counts; ``ftz`` says whether float32 arithmetic here keeps
    subnormals (it must)."""
    tiny = np.array([2.0 ** -149], dtype=np.float32)
    ftz = bool((tiny * np.float32(1.0))[0] == 0 or (tiny + tiny)[0] == 0)
    f, z = pairs(case, np.random.default_rng(CASES.index(case) + 20))
    exact = exact_path(f, z)
    out = {"ftz": ftz, "n": int(f.size), "subnormal_sums": 0, "nonzero": int((exact != 0).sum())}
    s = np.abs(_f32(f).astype(np.float64) + _f32(z).astype(np.float64))
    out["subnormal_sums"] = int(((s > 0) & (s < 2.0 ** -126)).sum())
    for relu_first in (False, True):
        out[f"differ_relu_first_{relu_first}"] = int(
            (float32_path(f, z, relu_first) != exact).sum())
    return out


@pytest.mark.parametrize("case", CASES)
def test_float32_add_then_round_is_one_rounding_of_the_exact_sum(case):
    proc = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["ftz"]
    assert out["n"] >= 65280 and out["nonzero"] > 0
    assert out["differ_relu_first_False"] == 0
    assert out["differ_relu_first_True"] == 0
    if case == "subnormals":
        assert out["subnormal_sums"] > 0


def test_exact_rounding_reference_on_known_values():
    """The integer reference on hand-picked sums: ties to even, a carry into
    the next binade, overflow to inf, a subnormal result, cancellation to
    +0, and a negative sum under ReLU."""
    b = lambda x: _to_bf16(np.array(x, dtype=np.float32))  # noqa: E731
    f = np.concatenate([b([1.0, 1.0, 1.0, 3.3895314e38, 2.0 ** -133, 5.0, 2.0])])
    z = np.concatenate([b([2.0 ** -8, 3 * 2.0 ** -8, 2.0 ** -7, 3.3895314e38, 2.0 ** -133,
                           -5.0, -3.0])])
    got = _f32(exact_path(f, z))
    want = np.array([1.0, 1.0 + 2.0 ** -6, 1.0 + 2.0 ** -7, np.inf, 2.0 ** -132, 0.0, 0.0],
                    dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(exact_path(f, z), float32_path(f, z, False))


if __name__ == "__main__":
    print(json.dumps(run_case(sys.argv[1])))
