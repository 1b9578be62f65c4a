"""The float32 functions of the AGC and PLL walkers (ops/cuda/sample_walk.py:
sincos_f32, atan2_f32, abs_f32, mix_f32) against float64 math, on the CPU.

They are built only from correctly rounded float32 operations, so the card's
device functions (csrc/sample_walk.cu) give the same bits; chip_smoke.py
holds the two equal on the card. Here: their accuracy in float32 ulp of the
float64 result (at most 2 for sin and cos over [-2 pi, 2 pi], the PLL's
wrapped phase, and for atan2 over all finite pairs), C99's special cases of
atan2, |x| at the AGC's amplitudes, that one function gives the same bits on
scalars (the walks) and on arrays (the grid check), and that the .cu file
holds the constants the numpy functions use.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from satdump_tpu_torch.ops.cuda import sample_walk as sw
from satdump_tpu_torch.tools import walker_coeffs

F32 = np.float32
CU = Path(sw.__file__).resolve().parents[2] / "csrc" / "sample_walk.cu"
TWO_PI = float(F32(2 * math.pi))


def _ulp(got, ref) -> np.ndarray:
    """|got - ref| in float32 ulp of the float64 reference."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    sp = np.spacing(np.abs(ref).astype(F32)).astype(np.float64)
    return np.abs(got - ref) / sp


def _near(v: float, k: int = 64) -> np.ndarray:
    """Every float32 within k ulp of float32(v)."""
    b = np.array([F32(v)], F32).view(np.int32).astype(np.int64)[0]
    if b == 0:
        up = np.arange(k + 1, dtype=np.int32).view(F32)
        return np.concatenate([up, -up])
    return (b + np.arange(-k, k + 1)).astype(np.int32).view(F32)


@pytest.mark.parametrize("grid", ["dense", "near_quarter_pi"])
def test_sincos_within_2_ulp(grid):
    """2^21 evenly spaced phases and 2^20 random ones over [-2 pi, 2 pi],
    or every float32 within 64 ulp of each multiple of pi/4 there."""
    if grid == "dense":
        rng = np.random.default_rng(7)
        x = np.concatenate([
            np.linspace(-TWO_PI, TWO_PI, 1 << 21, dtype=F32),
            rng.uniform(-TWO_PI, TWO_PI, 1 << 20).astype(F32)])
    else:
        x = np.concatenate([_near(m * math.pi / 4) for m in range(-8, 9)])
    s, c = sw.sincos_f32(x)
    assert s.dtype == F32 and c.dtype == F32
    x64 = x.astype(np.float64)
    es, ec = _ulp(s, np.sin(x64)), _ulp(c, np.cos(x64))
    assert es.max() <= 2 and ec.max() <= 2, (es.max(), ec.max())
    # against math's, on a subset
    for v in x[:: max(1, len(x) // 4096)]:
        sv, cv = sw.sincos_f32(v)
        assert _ulp(sv, math.sin(float(v))) <= 2
        assert _ulp(cv, math.cos(float(v))) <= 2


def _pairs(rng, n: int):
    """(y, x): magnitudes over 10^-45..10^38 at random signs, pairs at one
    magnitude and a random angle, and near-diagonal subnormal pairs."""
    mag = 10.0 ** rng.uniform(-45, 38.5, (2, n))
    with np.errstate(over="ignore"):
        yx = (mag * rng.choice([-1.0, 1.0], (2, n))).astype(F32)
        r = 10.0 ** rng.uniform(-40, 38, n)
        a = rng.uniform(-np.pi, np.pi, n)
        polar = np.stack([r * np.sin(a), r * np.cos(a)]).astype(F32)
    units = np.arange(1, 200, dtype=np.int32).view(F32)
    sub = np.stack(np.meshgrid(units, -units)).reshape(2, -1)
    return np.concatenate([yx, polar, sub], axis=1)


def test_atan2_within_2_ulp():
    y, x = _pairs(np.random.default_rng(11), 1 << 20)
    # 4 |ax - ay| overflows above 2^126, as it may (not the diagonal)
    with np.errstate(over="ignore"):
        got = sw.atan2_f32(y, x)
        assert got.dtype == F32
        ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
        e = _ulp(got, ref)
        assert e.max() <= 2, (e.max(), y[e.argmax()], x[e.argmax()])
        for i in range(0, len(y), 997):
            assert _ulp(sw.atan2_f32(y[i], x[i]),
                        math.atan2(float(y[i]), float(x[i]))) <= 2


SPECIAL = [0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 2.5, -2.5, 3.4e38, -3.4e38,
           math.nan]


@pytest.mark.parametrize("y", SPECIAL)
def test_atan2_special_cases_match_math(y):
    """Signed zeros (atan2(+-0, +x) = +-0, atan2(+-0, -x) = +-pi, x = +-0
    too), the axes (+-pi/2), the diagonals (+-pi/4, +-3pi/4) and NaN, each
    equal to math.atan2 rounded to float32, sign of zero included; every
    other pair of these values within 2 ulp of it."""
    for x in SPECIAL:
        with np.errstate(over="ignore", under="ignore"):
            got = sw.atan2_f32(F32(y), F32(x))
        want = math.atan2(F32(y), F32(x))
        if math.isnan(want):
            assert math.isnan(got), (y, x, got)
        elif y == 0 or x == 0 or abs(y) == abs(x):
            assert got == F32(want) and math.copysign(1, got) == \
                math.copysign(1, want), (y, x, got, want)
        else:
            assert _ulp(got, want) <= 2, (y, x, got, want)
    assert sw.atan2_f32(F32(0.0), F32(-0.0)) == sw.PI_HI
    assert math.copysign(1, sw.atan2_f32(F32(-0.0), F32(5.0))) == -1


def test_abs_at_the_agc_amplitudes():
    """|out| of 1e-6 samples times gains from 1 to 1e6 (the ceiling test of
    test_torch_classic.py drives the gain up from 1e-6 input), of one
    component (exact: sqrt(fl(x^2)) = |x|) and of two."""
    g = np.geomspace(1.0, 1e6, 4001).astype(F32)
    re = F32(1e-6) * g
    assert np.array_equal(sw.abs_f32(re, np.zeros_like(re)), re)
    assert np.array_equal(sw.abs_f32(np.zeros_like(re), -re), re)
    im = F32(-0.7e-6) * g
    e = _ulp(sw.abs_f32(re, im), np.hypot(re.astype(np.float64),
                                         im.astype(np.float64)))
    assert e.max() <= 2, e.max()


def test_scalars_and_arrays_give_the_same_bits():
    rng = np.random.default_rng(3)
    ph = rng.uniform(-TWO_PI, TWO_PI, 300).astype(F32)
    y, x = _pairs(rng, 100)[:, ::7]
    s, c = sw.sincos_f32(ph)
    a = sw.atan2_f32(y, x)
    for i, v in enumerate(ph):
        sv, cv = sw.sincos_f32(v)
        assert type(sv) is F32 and sv.tobytes() == s[i].tobytes()
        assert cv.tobytes() == c[i].tobytes()
    with np.errstate(over="ignore", under="ignore"):
        m = sw.abs_f32(y, x)
        for i in range(len(y)):
            assert sw.atan2_f32(y[i], x[i]).tobytes() == a[i].tobytes()
            assert sw.abs_f32(y[i], x[i]).tobytes() == m[i].tobytes()


def test_mix_is_x_times_cos_minus_j_sin():
    """mix_f32 turns x by the phase's quarter turns first; bit for bit it is
    (xr c + xi s, xi c - xr s) with sincos_f32's (s, c)."""
    rng = np.random.default_rng(5)
    n = 1 << 16
    ph = rng.uniform(-TWO_PI, TWO_PI, n).astype(F32)
    xr = rng.standard_normal(n).astype(F32)
    xi = rng.standard_normal(n).astype(F32)
    s, c = sw.sincos_f32(ph)
    mr, mi = sw.mix_f32(xr, xi, ph)
    assert np.array_equal(mr, xr * c + xi * s)
    assert np.array_equal(mi, xi * c - xr * s)
    assert sw.mix_f32(xr[9], xi[9], ph[9]) == (mr[9], mi[9])


def _cu_constants() -> dict:
    """The `constexpr float kName = <hex>f` constants of sample_walk.cu."""
    text = CU.read_text()
    return {m.group(1): float.fromhex(m.group(2)) for m in re.finditer(
        r"\b(k\w+) = (-?0x[0-9a-f.]+p[+-]?\d+)f", text)}


def test_kernel_holds_the_same_constants():
    cu = _cu_constants()
    py = {"kTwoOverPi": sw.TWO_OVER_PI, "kPio2_1": sw.PIO2_1,
          "kPio2_2": sw.PIO2_2, "kPio2_3": sw.PIO2_3, "kPiHi": sw.PI_HI,
          "kPiLo": sw.PI_LO, "kPi34Hi": sw.PI34_HI, "kPi34Lo": sw.PI34_LO,
          "kPio2Hi": sw.PIO2_HI, "kPio2Lo": sw.PIO2_LO,
          "kPio4Hi": sw.PIO4_HI, "kPio4Lo": sw.PIO4_LO}
    py.update({f"kS{i}": v for i, v in enumerate(sw.SIN_C)})
    py.update({f"kC{i}": v for i, v in enumerate(sw.COS_C)})
    py.update({f"kA{i}": v for i, v in enumerate(sw.ATAN_C)})
    assert {k: cu.get(k) for k in py} == {k: float(v) for k, v in py.items()}
    assert all(F32(v) == v for v in cu.values())


def test_coefficients_are_the_fits():
    """tools/walker_coeffs.py fits again what the module stores (within 4
    float32 ulp a coefficient: a BLAS may round the fit otherwise), and
    pi/2's parts."""
    fits = walker_coeffs.fits()
    for name in ("SIN_C", "COS_C", "ATAN_C"):
        got, err = fits[name]
        want = np.asarray(getattr(sw, name), F32)
        assert got.shape == want.shape and err < 0.1, (name, err)
        assert (_ulp(got, want.astype(np.float64)) <= 4).all(), name
    assert tuple(map(F32, walker_coeffs.pio2_parts())) == (
        sw.PIO2_1, sw.PIO2_2, sw.PIO2_3)


def test_walk_math_runs_the_plain_functions_on_the_cpu():
    ph = torch.linspace(-6.0, 6.0, 101)
    s, c = sw.walk_math("sincos", ph)
    ws, wc = sw.sincos_f32(ph.numpy())
    assert np.array_equal(s.numpy(), ws) and np.array_equal(c.numpy(), wc)
    (a,) = sw.walk_math("atan2", ph, ph.flip(0))
    assert np.array_equal(a.numpy(), sw.atan2_f32(ph.numpy(),
                                                  ph.flip(0).numpy()))
    (m,) = sw.walk_math("abs", ph, ph)
    assert m.dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        sw.walk_math("atan2", ph)
    with pytest.raises(ValueError, match="float32"):
        sw.walk_math("abs", ph, ph.double())
    with pytest.raises(ValueError, match="unsupported device"):
        sw.walk_math("sincos", torch.zeros(4, device="meta"))
