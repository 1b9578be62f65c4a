"""Wrapper of the Mueller & Mueller walker (csrc/mm_clock.cu).

Counterpart of the lax.scan in satdump_tpu/ops/clock_recovery.py::
mm_clock_recovery. On a CUDA tensor `mm_walk` launches the kernel; on a CPU
tensor it runs `mm_walk_plain`, which walks the output slots with the
kernel's float32 operations in the kernel's order (numpy float32 scalars,
the 8-tap sums in order, the imaginary products fused into their adds in
float64), so the two give the same symbols bit for bit.

The state is a float32 vector of STATE_SLOTS: mu, omega, inc (int32 bits),
last_sample, then p_regs and c_regs as (re, im) pairs, newest first. The
kernel reads it and writes a new one, with inc already moved into the next
block (max(inc - n, 0)).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda import _build

F32 = np.float32
_F0, _F1, _FM1 = F32(0.0), F32(1.0), F32(-1.0)
NFILT, NTAPS = 128, 8
STATE_SLOTS = 16
MU, OMEGA, INC, LAST, P_REGS, C_REGS = 0, 1, 2, 3, 4, 10

_KERNEL = _build.Kernel("mm_clock", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_int])


def _sgn(v):
    return _F1 if v > 0 else (_FM1 if v < 0 else _F0)


def _clip(v, lo, hi):
    return min(max(v, lo), hi)


def mm_walk_plain(ext: torch.Tensor, n: int, state: torch.Tensor,
                  bank: torch.Tensor, *, omega_mid: float, gain_omega: float,
                  gain_mu: float, omega_limit: float, out_cap: int,
                  complex_mode: bool):
    """mm_walk's plain version (CPU tensors): (syms, valid, state')."""
    e = torch.view_as_real(ext).numpy()
    er, ei64 = e[:, 0].copy(), e[:, 1].astype(np.float64)
    b = bank.numpy()
    b64 = b.astype(np.float64)
    st = state.numpy()
    mu, omega, last = F32(st[MU]), F32(st[OMEGA]), F32(st[LAST])
    inc = int(st[INC:INC + 1].view(np.int32)[0])
    p = [[F32(st[P_REGS + 2 * r]), F32(st[P_REGS + 2 * r + 1])]
         for r in range(3)]
    c = [[F32(st[C_REGS + 2 * r]), F32(st[C_REGS + 2 * r + 1])]
         for r in range(3)]
    mid, g_om, g_mu, lim = (F32(omega_mid), F32(gain_omega), F32(gain_mu),
                            F32(omega_limit))
    nfilt = F32(NFILT)
    syms = np.zeros((out_cap, 2), F32)
    k = 0
    while k < out_cap and inc < n:
        start = min(max(inc, 0), n - 1)
        imu = min(max(int(np.rint(mu * nfilt)), 0), NFILT - 1)
        t = b[imu]
        sr = np.add.accumulate(er[start:start + NTAPS] * t)[-1]
        si = _F0
        for v in ei64[start:start + NTAPS] * b64[imu]:     # exact products
            si = F32(float(si) + v)
        if complex_mode:
            c0r = _F1 if sr > 0 else _F0
            c0i = _F1 if si > 0 else _F0
            first = (sr - p[1][0]) * c[0][0] + (si - p[1][1]) * c[0][1]
            second = (c0r - c[1][0]) * p[0][0] + (c0i - c[1][1]) * p[0][1]
            err = first - second
            p = [[sr, si], p[0], p[1]]
            c = [[c0r, c0i], c[0], c[1]]
        else:
            err = _sgn(last) * sr - _sgn(sr) * last
            last = sr
        err = _clip(err, _FM1, _F1)
        om = omega + g_om * err
        om = mid + _clip(om - mid, -lim, lim)
        mun = mu + om + g_mu * err
        fl = np.floor(mun)
        inc = max(inc + int(fl), 0)
        mu = mun - fl
        omega = om
        syms[k] = sr, si
        k += 1
    valid = np.zeros(out_cap, bool)
    valid[:k] = True
    out = np.zeros(STATE_SLOTS, F32)
    out[MU], out[OMEGA], out[LAST] = mu, omega, last
    out[INC:INC + 1].view(np.int32)[0] = max(inc - n, 0)
    for r in range(3):
        out[P_REGS + 2 * r: P_REGS + 2 * r + 2] = p[r]
        out[C_REGS + 2 * r: C_REGS + 2 * r + 2] = c[r]
    return (torch.view_as_complex(torch.from_numpy(syms)),
            torch.from_numpy(valid), torch.from_numpy(out))


def mm_walk(ext: torch.Tensor, n: int, state: torch.Tensor,
            bank: torch.Tensor, *, omega_mid: float, gain_omega: float,
            gain_mu: float, omega_limit: float, out_cap: int,
            complex_mode: bool):
    """M&M clock recovery over one block: ext = [history (7) | block (n)]
    complex64, bank (128, 8) float32, state float32[STATE_SLOTS]. Returns
    (syms (out_cap,) complex64, zero past the valid ones; valid (out_cap,)
    bool, a prefix; state')."""
    if ext.device.type == "cpu":
        return mm_walk_plain(ext, n, state, bank, omega_mid=omega_mid,
                             gain_omega=gain_omega, gain_mu=gain_mu,
                             omega_limit=omega_limit, out_cap=out_cap,
                             complex_mode=complex_mode)
    if ext.device.type != "cuda":
        raise ValueError(f"mm_walk: unsupported device {ext.device}")
    dev = ext.device
    if ext.dtype != torch.complex64 or ext.ndim != 1 \
            or not ext.is_contiguous() or ext.shape[0] != n + NTAPS - 1:
        raise ValueError(f"mm_walk: ext must be contiguous 1-D complex64 of "
                         f"n + {NTAPS - 1} = {n + NTAPS - 1}, got "
                         f"{tuple(ext.shape)} {ext.dtype}")
    if bank.shape != (NFILT, NTAPS) or bank.dtype != torch.float32 \
            or not bank.is_contiguous() or bank.device != dev:
        raise ValueError(f"mm_walk: bank must be contiguous ({NFILT}, "
                         f"{NTAPS}) float32 on {dev}, got {tuple(bank.shape)}"
                         f" {bank.dtype} on {bank.device}")
    if state.shape != (STATE_SLOTS,) or state.dtype != torch.float32 \
            or not state.is_contiguous() or state.device != dev:
        raise ValueError(f"mm_walk: state must be ({STATE_SLOTS},) float32 "
                         f"on {dev}, got {tuple(state.shape)} {state.dtype} "
                         f"on {state.device}")
    if n < 1 or n + NTAPS >= 2 ** 31 or not 1 <= out_cap < 2 ** 31:
        raise ValueError(f"mm_walk: need 1 <= n < 2^31 - {NTAPS} and "
                         f"1 <= out_cap < 2^31 (n={n}, out_cap={out_cap})")
    syms = torch.empty(out_cap, dtype=torch.complex64, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    out_state = torch.empty_like(state)
    _KERNEL(dev.index, ext.data_ptr(), n, bank.data_ptr(), state.data_ptr(),
            out_state.data_ptr(), syms.data_ptr(), valid.data_ptr(), out_cap,
            float(F32(omega_mid)), float(F32(gain_omega)),
            float(F32(gain_mu)), float(F32(omega_limit)), int(complex_mode))
    mm_walk.launches += 1
    return syms, valid, out_state


mm_walk.launches = 0
