"""Wrappers of the sample walkers (csrc/sample_walk.cu): the AGC, the
carrier-tracking PLL and the Costas loop, one complex64 sample in, one out.

Counterparts of the lax.scan loops satdump_tpu/ops/stages.py::agc_scan and
satdump_tpu/ops/costas.py::{pll_carrier_scan,costas_scan}. On a CUDA tensor
a wrapper launches the kernel; on a CPU tensor it runs its plain version,
`*_walk_plain`, which walks the samples with the kernel's float operations in
the kernel's order on numpy float32 scalars. The AGC's |out| and the PLL's
e^{-j phase} and arg() are `abs_f32`, `sincos_f32` and `atan2_f32` below:
float32 functions built only from correctly rounded operations (+ - * /,
sqrt), compares, selects and sign flips, which the kernel repeats operation
for operation, so the card equals the CPU bit for bit. The Costas loop still
forms e^{-j phase} in float64 and rounds once (`_mix`). The state is a
float32 tensor, (1,) gain or (2,) phase and frequency: the kernel reads it
and writes a new one, so a block needs no host sync.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda import _build

F32 = np.float32
_F0, _F1, _FM1 = F32(0.0), F32(1.0), F32(-1.0)
# the reference's Python-float constants, as float32 rounds them
TWO_PI = F32(2 * math.pi)
FOUR_PI = F32(4 * math.pi)
SQRT2_M1 = F32(math.sqrt(2.0) - 1.0)
MODES = {"agc": 0, "pll": 1, 2: 2, 4: 4, 8: 8}

_KERNEL = _build.Kernel("sample_walk", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float])


def _sgn(v):
    return _F1 if v > 0 else (_FM1 if v < 0 else _F0)


def _clip(v, lo, hi):
    return min(max(v, lo), hi)


# -- float32 e^{-j phase}, arg() and |x| of the AGC and the PLL --------------
# Each function is written once for numpy float32 scalars and arrays: the
# walks call it on scalars, chip_smoke.py's grid check on arrays. Its
# operations are + - * / and sqrt (each correctly rounded in float32 on the
# CPU and, as __fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn, on the card),
# compares, selects and exact sign flips; csrc/sample_walk.cu repeats them in
# the same order. The coefficients are minimax fits rounded to float32
# (python3 -m satdump_tpu_torch.tools.walker_coeffs prints them).
_HALF, _TWO, _FOUR, _QUARTER = F32(0.5), F32(2.0), F32(4.0), F32(0.25)
# x + 1.5 2^23 - 1.5 2^23 rounds x to an integer, ties to even (|x| < 2^22)
_RINT = F32(12582912.0)


def _h(*hexes):
    """Exact float32 constants from hexadecimal literals (csrc/sample_walk.cu
    holds the same literals)."""
    v = tuple(F32(float.fromhex(h)) for h in hexes)
    return v if len(v) > 1 else v[0]


TWO_OVER_PI = _h("0x1.45f306p-1")                   # 2/pi
# pi/2 in three parts: PIO2_1 and PIO2_2 have 12 bits (k * part is exact
# for |k| < 2^12, and x - k PIO2_1 is exact by Sterbenz), PIO2_3 the rest
PIO2_1, PIO2_2, PIO2_3 = _h("0x1.922p+0", "-0x1.2aep-18", "-0x1.de974p-31")
# pi, 3pi/4, pi/2 and pi/4 as float32 and the rest
PI_HI, PI_LO = _h("0x1.921fb6p+1", "-0x1.777a5cp-24")
PI34_HI, PI34_LO = _h("0x1.2d97c8p+1", "-0x1.99bc5cp-28")
PIO2_HI, PIO2_LO = _h("0x1.921fb6p+0", "-0x1.777a5cp-25")
PIO4_HI, PIO4_LO = _h("0x1.921fb6p-1", "-0x1.777a5cp-26")
# sin r = r + r z (S0 + S1 z + S2 z^2), z = r^2, |r| <= pi/4
SIN_C = _h("-0x1.555546p-3", "0x1.110774p-7", "-0x1.9951f8p-13")
# cos r = 1 - z/2 + z^2 (C0 + C1 z + C2 z^2)
COS_C = _h("0x1.55554ap-5", "-0x1.6c0c28p-10", "0x1.99e814p-16")
# atan t = t + t z P(z), z = t^2, 0 <= t <= 4/5; P of degree 7
ATAN_C = _h("-0x1.55554cp-2", "0x1.9995c6p-3", "-0x1.244ce4p-3",
            "0x1.c2455ep-4", "-0x1.5bbc2p-4", "0x1.dc1658p-5",
            "-0x1.d7763ep-6", "0x1.d4a47p-8")
_BIG = F32(2.0 ** 125)


def _sel(c, a, b):
    """c ? a : b: np.where on arrays, a branch on scalars."""
    if type(c) is np.ndarray:
        return np.where(c, a, b)
    return a if c else b


def _signbit(v):
    """The sign bit (-0 and -NaN included); math's on scalars, which is
    faster than the ufunc."""
    if type(v) is np.ndarray:
        return np.signbit(v)
    return math.copysign(1.0, v) < 0.0


def _rint(v):
    return (v + _RINT) - _RINT


def _sincos_reduced(x):
    """(k, sin r, cos r) with x = k pi/2 + r, |r| <= ~pi/4. r is carried
    as rh + rl (Cody-Waite): x - k PIO2_1 and k PIO2_2 are exact, rh is
    their difference rounded and rl its rounding error (exact, Fast2Sum)
    less k PIO2_3; sin r = rh + (rl + rh z S), cos r = 1 - hz + (z^2 C -
    rh rl)."""
    k = _rint(x * TWO_OVER_PI)
    r1 = x - k * PIO2_1
    u = k * PIO2_2
    rh = r1 - u
    rl = ((r1 - rh) - u) - k * PIO2_3
    z = rh * rh
    z2 = z * z
    s0, s1, s2 = SIN_C
    s = rh + (rl + (rh * z) * ((s0 + s1 * z) + s2 * z2))
    c0, c1, c2 = COS_C
    hz = _HALF * z
    w = _F1 - hz
    # 1 - hz as w plus its exact rounding error (1 - w) - hz
    c = w + ((((_F1 - w) - hz) - rh * rl) + z2 * ((c0 + c1 * z) + c2 * z2))
    return k, s, c


def _quadrant(k):
    """k mod 4 as -2, -1, 0, 1 or 2."""
    return k - _FOUR * _rint(k * _QUARTER)


def sincos_f32(x):
    """(sin x, cos x) in float32, within 2 ulp for |x| <= 2 pi (the PLL's
    wrapped phase; tests/test_torch_walker_math.py)."""
    k, s, c = _sincos_reduced(x)
    q = _quadrant(k)
    odd = (q == _F1) | (q == _FM1)
    sn, cs = _sel(odd, c, s), _sel(odd, s, c)
    sn = _sel((q < _F0) | (q == _TWO), -sn, sn)
    cs = _sel((q > _F0) | (q == -_TWO), -cs, cs)
    return sn, cs


def mix_f32(xr, xi, phase):
    """(xr + j xi) e^{-j phase} in float32, the reference's x (c - j s):
    (xr c + xi s, xi c - xr s) with (s, c) = sincos_f32(phase). x is first
    turned by k quarter turns (exact) and then mixed with sin r and cos r:
    the same products summed in the other order, so bit for bit the same,
    and the quadrant's selects wait for x, not for the polynomials."""
    k, s, c = _sincos_reduced(phase)
    q = _quadrant(k)
    odd = (q == _F1) | (q == _FM1)
    ar, ai = _sel(odd, xi, xr), _sel(odd, xr, xi)       # x (-j)^k, k odd:
    ar = _sel((q < _F0) | (q == _TWO), -ar, ar)         # (xi, -xr) or
    ai = _sel((q > _F0) | (q == -_TWO), -ai, ai)        # (-xi, xr)
    return ar * c + ai * s, ai * c - ar * s


def atan2_f32(y, x):
    """atan2(y, x) in float32, within 2 ulp for finite y and x, with C99's
    signed zeros and quadrants: atan2(+-0, +x) = +-0, atan2(+-0, -x) =
    +-pi (x = +-0 too); NaN in, NaN out.

    With mn, mx the smaller and the larger of |x| and |y|, the octant gives
    res = C + sigma atan(mn / mx) for C in {0, pi/2, pi} and sigma = +-1.
    Near the diagonal (mn > 4/5 mx) atan(mn / mx) = pi/4 + atan t with
    t = (mn - mx) / (mn + mx) in [-1/9, 0] (the difference exact, Sterbenz;
    both scaled by 1/4 above 2^125, exactly, so that the sum cannot
    overflow), else t = mn / mx in [0, 4/5]: both arms before one
    division.
    sigma goes on t before the polynomial (ts = sigma t, lo = ts z P(z), so
    sigma atan t = ts + lo); hi = C' + ts and its rounding error e (exact:
    Fast2Sum, |C'| >= pi/4 >= |t| or C' = 0) are formed while the polynomial
    runs, and res = hi + (e + lo). No select waits on the division's chain
    but the sign of y."""
    ax, ay = abs(x), abs(y)
    swap = ay > ax
    # 4 |ax - ay| is exact within a factor 2 (Sterbenz; x 4 exactly):
    # diag means mn > 4/5 mx, and not diag mn <= 4/5 mx, subnormals too
    d4 = _FOUR * abs(ax - ay)
    diag = (d4 < ax) & (d4 < ay)
    # mn + mx overflows above 2^127: scaled by 1/4 there (both normal)
    q = _sel((ax > _BIG) | (ay > _BIG), _QUARTER, _F1)
    aq, bq = ax * q, ay * q
    # both zero: 0 / 1, not 0 / 0
    num = _sel(diag, -abs(aq - bq), _sel(swap, ax, ay))
    den = _sel(diag, aq + bq, _sel(swap, ay, _sel(ax == _F0, _F1, ax)))
    neg = _signbit(x)
    c_hi = _sel(diag, _sel(neg, PI34_HI, PIO4_HI),
                _sel(swap, PIO2_HI, _sel(neg, PI_HI, _F0)))
    c_lo = _sel(diag, _sel(neg, PI34_LO, PIO4_LO),
                _sel(swap, PIO2_LO, _sel(neg, PI_LO, _F0)))
    t = num / den
    ts = _sel(swap != neg, -t, t)
    hi = c_hi + ts
    e = ((c_hi - hi) + ts) + c_lo
    z = t * t
    z2 = z * z
    p = ATAN_C
    b0 = (p[0] + p[1] * z) + (p[2] + p[3] * z) * z2
    b1 = (p[4] + p[5] * z) + (p[6] + p[7] * z) * z2
    lo = (ts * z) * (b0 + b1 * (z2 * z2))
    res = abs(hi + (e + lo))
    return _sel(_signbit(y), -res, res)


def abs_f32(re, im):
    """|re + j im| = sqrt(re re + im im) in float32. Unscaled, unlike XLA's
    hypot: the squares overflow above |x| ~ 1.8e19 and lose bits below ~1e-19.
    The AGC's samples come from int8 / int16 SDR input scaled to about 1:
    zero or at least ~3e-5, times a gain of at most 65536 by default."""
    return np.sqrt(re * re + im * im)


def _mix(xr, xi, phase):
    """(xr + j xi) e^{-j phase} in float64, rounded once to float32 (the
    Costas loop's)."""
    p = float(phase)
    c, s = math.cos(p), math.sin(p)
    a, b = float(xr), float(xi)
    return F32(a * c + b * s), F32(b * c - a * s)


def _costas_error(order: int, re, im):
    if order == 2:
        return re * im
    if order == 4:
        return _sgn(re) * im - _sgn(im) * re
    if abs(re) >= abs(im):
        return _sgn(re) * im - _sgn(im) * re * SQRT2_M1
    return _sgn(re) * im * SQRT2_M1 - _sgn(im) * re


def _floored_mod(a, p):
    r = F32(math.fmod(float(a), float(p)))      # exact, as fmodf
    return r + p if r < 0 else r


def _walk_plain(mode, x: torch.Tensor, state: torch.Tensor, p0, p1, p2):
    """The kernel's walk on the CPU: returns (y, new state)."""
    xs = torch.view_as_real(x).numpy()
    xr, xi = xs[:, 0].copy(), xs[:, 1].copy()
    st = state.numpy()
    s0 = F32(st[0])
    s1 = F32(st[1]) if mode != "agc" else _F0
    p0, p1, p2 = F32(p0), F32(p1), F32(p2)
    yr, yi = [], []
    if mode == "agc":
        for a, b in zip(xr, xi):
            o_r, o_i = a * s0, b * s0
            gn = s0 + p0 * (p1 - abs_f32(o_r, o_i))
            s0 = p2 if p2 < gn else gn
            yr.append(o_r)
            yi.append(o_i)
    else:
        order = MODES[mode]
        for a, b in zip(xr, xi):
            if mode == "pll":
                mr, mi = mix_f32(a, b, s0)
                err = atan2_f32(mi, mr)
                f = _clip(s1 + p1 * err, -p2, p2)
            else:
                mr, mi = _mix(a, b, s0)
                err = _clip(_costas_error(order, mr, mi), _FM1, _F1)
                f = s1 + p1 * err
            ph = s0 + f + p0 * err
            s0 = _floored_mod(ph + TWO_PI, FOUR_PI) - TWO_PI
            s1 = f if mode == "pll" else _clip(f, -p2, p2)
            yr.append(mr)
            yi.append(mi)
    y = np.stack([np.asarray(yr, F32), np.asarray(yi, F32)], axis=-1)
    out_state = np.asarray([s0] if mode == "agc" else [s0, s1], F32)
    return (torch.view_as_complex(torch.from_numpy(y.reshape(-1, 2))),
            torch.from_numpy(out_state))


_MATH_KERNEL = _build.Kernel("sample_walk", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int], entry="walk_math")
# walk_math_launch's fn code, the inputs and the plain function
_MATH = {"sincos": (0, 1, sincos_f32), "atan2": (1, 2, atan2_f32),
         "abs": (2, 2, abs_f32)}


def walk_math(fn: str, *args: torch.Tensor):
    """The AGC's and the PLL's float32 functions elementwise, for checking
    them on a grid: "sincos" (x) -> (sin, cos), "atan2" (y, x) -> (angle,),
    "abs" (re, im) -> (magnitude,), on contiguous 1-D float32 tensors of one
    length. On the card the kernel's device functions (walk_math_launch),
    on the CPU the numpy ones above."""
    code, nin, plain = _MATH[fn]
    if len(args) != nin or any(
            a.dtype != torch.float32 or a.ndim != 1 or not a.is_contiguous()
            or a.shape != args[0].shape or a.device != args[0].device
            for a in args):
        raise ValueError(f"walk_math {fn}: needs {nin} contiguous 1-D "
                         f"float32 tensors of one shape on one device")
    dev = args[0].device
    if dev.type == "cpu":
        out = plain(*(a.numpy() for a in args))
        out = out if isinstance(out, tuple) else (out,)
        return tuple(torch.from_numpy(np.asarray(o, F32)) for o in out)
    if dev.type != "cuda":
        raise ValueError(f"walk_math: unsupported device {dev}")
    n = args[0].shape[0]
    outs = tuple(torch.empty_like(args[0]) for _ in range(2 if code == 0
                                                          else 1))
    if n:
        _MATH_KERNEL(dev.index, args[0].data_ptr(), args[-1].data_ptr(),
                     outs[0].data_ptr(), outs[-1].data_ptr(), n, code)
    return outs


def _walk(mode, x: torch.Tensor, state: torch.Tensor, p0, p1, p2, wrapper):
    """Checks, then the kernel on the card (counted on `wrapper`) or the
    plain version on the CPU."""
    name = wrapper.__name__
    nstate = 1 if mode == "agc" else 2
    if x.device.type == "cpu":
        return _walk_plain(mode, x, state, p0, p1, p2)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.complex64 or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous 1-D complex64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if state.dtype != torch.float32 or state.shape != (nstate,) \
            or not state.is_contiguous() or state.device != x.device:
        raise ValueError(f"{name}: state must be ({nstate},) float32 on "
                         f"{x.device}, got {tuple(state.shape)} {state.dtype} "
                         f"on {state.device}")
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{name}: block of {n} samples, need < 2^31")
    y = torch.empty_like(x)
    out_state = torch.empty_like(state)
    if n == 0:
        out_state.copy_(state)
        return y, out_state
    _KERNEL(x.device.index, x.data_ptr(), y.data_ptr(), n, state.data_ptr(),
            out_state.data_ptr(), MODES[mode], float(F32(p0)), float(F32(p1)),
            float(F32(p2)))
    wrapper.launches += 1
    return y, out_state


def agc_walk(x: torch.Tensor, gain: torch.Tensor, rate: float,
             reference: float, max_gain: float):
    """Per-sample AGC (ref agc.cpp:17-44) of complex64 x from the (1,)
    float32 gain; max_gain <= 0 means no ceiling. Returns (y, gain')."""
    ceiling = max_gain if max_gain > 0 else math.inf
    return _walk("agc", x, gain, rate, reference, ceiling, agc_walk)


def agc_walk_plain(x, gain, rate, reference, max_gain):
    """agc_walk's plain version (CPU tensors)."""
    return _walk_plain("agc", x, gain, rate, reference,
                       max_gain if max_gain > 0 else math.inf)


def pll_walk(x: torch.Tensor, state: torch.Tensor, alpha: float, beta: float,
             max_offset: float):
    """Carrier-tracking PLL (ref pll_carrier_tracking.cpp) of complex64 x
    from the (2,) float32 [phase, freq]. Returns (the carrier-wiped y,
    state')."""
    return _walk("pll", x, state, alpha, beta, max_offset, pll_walk)


def pll_walk_plain(x, state, alpha, beta, max_offset):
    """pll_walk's plain version (CPU tensors)."""
    return _walk_plain("pll", x, state, alpha, beta, max_offset)


def costas_walk(x: torch.Tensor, state: torch.Tensor, alpha: float,
                beta: float, order: int, freq_limit: float):
    """Costas loop of order 2, 4 or 8 (ref costas_loop.cpp:24-67) on
    complex64 x from the (2,) float32 [phase, freq]. Returns (y, state')."""
    if order not in (2, 4, 8):
        raise ValueError(f"unsupported Costas order {order}")
    return _walk(order, x, state, alpha, beta, freq_limit, costas_walk)


def costas_walk_plain(x, state, alpha, beta, order, freq_limit):
    """costas_walk's plain version (CPU tensors)."""
    if order not in (2, 4, 8):
        raise ValueError(f"unsupported Costas order {order}")
    return _walk_plain(order, x, state, alpha, beta, freq_limit)


agc_walk.launches = 0
pll_walk.launches = 0
costas_walk.launches = 0
