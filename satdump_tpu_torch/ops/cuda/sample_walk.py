"""Wrappers of the sample walkers (csrc/sample_walk.cu): the AGC, the
carrier-tracking PLL and the Costas loop, one complex64 sample in, one out.

Counterparts of the lax.scan loops satdump_tpu/ops/stages.py::agc_scan and
satdump_tpu/ops/costas.py::{pll_carrier_scan,costas_scan}. On a CUDA tensor
a wrapper launches the kernel; on a CPU tensor it runs its plain version,
`*_walk_plain`, which walks the samples with the kernel's float operations in
the kernel's order (numpy float32 scalars, float64 for e^{-j phase}, |x| and
arg). The state is a float32 tensor, (1,) gain or (2,) phase and frequency:
the kernel reads it and writes a new one, so a block needs no host sync.
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


def _mix(xr, xi, phase):
    """(xr + j xi) e^{-j phase} in float64, rounded once to float32."""
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
            fr, fi = float(o_r), float(o_i)
            mag = F32(math.sqrt(fr * fr + fi * fi))
            gn = s0 + p0 * (p1 - mag)
            s0 = p2 if p2 < gn else gn
            yr.append(o_r)
            yi.append(o_i)
    else:
        order = MODES[mode]
        for a, b in zip(xr, xi):
            mr, mi = _mix(a, b, s0)
            if mode == "pll":
                err = F32(math.atan2(float(mi), float(mr)))
                f = _clip(s1 + p1 * err, -p2, p2)
            else:
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
