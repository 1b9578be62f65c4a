"""The float32 constants of the walkers' sincos / atan2 (ops/cuda/sample_walk.py
and csrc/sample_walk.cu), fitted and printed:

    python3 -m satdump_tpu_torch.tools.walker_coeffs

Each polynomial is a weighted minimax fit (Lawson's iteration on Chebyshev
nodes) of what is left after its leading terms, weighted so that the error
counts as a share of the function's value. The coefficients are rounded to
float32 one at a time, lowest first, each fit again with the ones before it
fixed. The printed error is the fit's alone, in float32 ulp of the result;
tests/test_torch_walker_math.py measures the functions as evaluated.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
# the reduced argument reaches a little past pi/4 where x 2/pi rounds
R_MAX = math.pi / 4 * 1.001
# atan2 reduces to t <= 4/5 (with a margin)
ATAN_T_MAX = 0.8 * 1.0001


def minimax_f32(f, weight, hi: float, degree: int, iters: int = 80):
    """Coefficients c_0..c_degree (float32) of sum c_k z^k ~ f(z) on
    [0, hi], and the largest weighted error."""
    z = (1 - np.cos(np.linspace(0, np.pi, 6000))) / 2 * hi
    z = z[z > 1e-9]
    w = weight(z)
    v = np.vander(z, degree + 1, increasing=True) * w[:, None]
    target = f(z) * w
    fixed: list = []
    for k in range(degree + 1):
        b = target - v[:, :k] @ np.asarray(fixed, float)
        a = v[:, k:]
        lw = np.full(len(z), 1.0 / len(z))
        for _ in range(iters):
            s = np.sqrt(lw)
            c, *_ = np.linalg.lstsq(a * s[:, None], b * s, rcond=None)
            lw = lw * np.abs(a @ c - b)
            lw /= lw.sum()
        fixed.append(float(F32(c[0])))
    c = np.asarray(fixed)
    return c.astype(F32), float(np.abs(v @ c - target).max()) / 2.0 ** -24


def fits() -> dict:
    """name -> (float32 coefficients, fit error in ulp)."""
    def sq(z):
        return np.sqrt(z)
    return {
        # sin r = r + r z S(z)
        "SIN_C": minimax_f32(lambda z: (np.sin(sq(z)) - sq(z)) / (z * sq(z)),
                             lambda z: z * sq(z) / np.sin(sq(z)),
                             R_MAX ** 2, 2),
        # cos r = 1 - z/2 + z^2 C(z)
        "COS_C": minimax_f32(lambda z: (np.cos(sq(z)) - 1 + z / 2) / z ** 2,
                             lambda z: z ** 2 / np.cos(sq(z)), R_MAX ** 2, 2),
        # atan t = t + t z P(z), 0 <= t <= 4/5 (atan2's reduction)
        "ATAN_C": minimax_f32(
            lambda z: (np.arctan(sq(z)) - sq(z)) / (z * sq(z)),
            lambda z: z * sq(z) / np.arctan(sq(z)), ATAN_T_MAX ** 2, 7),
    }


def pio2_parts(bits: int = 12):
    """pi/2 as PIO2_1 + PIO2_2 + PIO2_3: the first two of `bits` bits each
    (so k * part is exact for |k| < 2^(24 - bits)), the third a float32."""
    def round_bits(v: float) -> float:
        e = math.floor(math.log2(abs(v))) - (bits - 1)
        return round(v / 2.0 ** e) * 2.0 ** e
    p1 = round_bits(math.pi / 2)
    p2 = round_bits(math.pi / 2 - p1)
    p3 = float(F32(math.pi / 2 - p1 - p2))
    return p1, p2, p3


def _lit(v) -> str:
    """A float32 as an exact hexadecimal literal (Python's float.fromhex and
    C++17 read it alike) and, for the reader, in decimal."""
    v = F32(v)
    mant, exp = float(v).hex().split("p")
    return (f"{mant.rstrip('0').rstrip('.')}p{exp}  "
            f"# {np.format_float_scientific(v, unique=True)}")


def main() -> int:
    consts = {"TWO_OVER_PI": 2 / math.pi}
    for name, v in (("PI", math.pi), ("PI34", 3 * math.pi / 4),
                    ("PIO2", math.pi / 2), ("PIO4", math.pi / 4)):
        consts[f"{name}_HI"] = v
        consts[f"{name}_LO"] = v - float(F32(v))
    consts.update(zip(("PIO2_1", "PIO2_2", "PIO2_3"), pio2_parts()))
    for name, v in consts.items():
        print(f"{name} = {_lit(v)}")
    for name, (c, err) in fits().items():
        print(f"{name}  (fit error {err:.4f} ulp):")
        for x in c:
            print(f"    {_lit(x)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
