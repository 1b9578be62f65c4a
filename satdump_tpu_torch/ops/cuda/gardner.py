"""Wrapper of the Gardner clock-recovery walker (csrc/gardner_clock.cu).

Counterpart of the lax.scan in satdump_tpu/ops/clock_recovery.py::
gardner_clock_recovery. On a CUDA tensor `gardner_walk` launches the
kernel; on a CPU tensor it runs `gardner_walk_plain`, which walks the
output slots with the kernel's float32 operations in the kernel's order
(numpy float32 scalars; each 8-tap sum in order, the imaginary products
fused into their adds, as in the M&M walker), so the two give the same
symbols bit for bit. XLA's CPU fusion also contracts three of the loop's
products into their adds here (`_fma`): the detector's real term into
the imaginary one, and the omega and mu updates; the tests hold the plain
version to the JAX scan bit for bit, state included.

The state is a float32 vector of STATE_SLOTS: mu, omega, inc (int32 bits),
a pad, last_sample as (re, im) (at an even slot, so that it views as
complex64), then padding. The kernel reads it and writes
a new one, with inc already moved into the next block (max(inc - n, 0)).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda import _build

F32 = np.float32
_F0, _F1, _FM1, _HALF = F32(0.0), F32(1.0), F32(-1.0), F32(0.5)
NFILT, NTAPS = 128, 8
STATE_SLOTS = 8
MU, OMEGA, INC, LAST = 0, 1, 2, 4          # LAST: re, then im at LAST + 1

_KERNEL = _build.Kernel("gardner_clock", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float])


def _fma(a, b, c):
    """a * b + c with one rounding to float32: the product is exact in
    float64 and the sum rounds there first (as the kernel's __dmul_rn /
    __dadd_rn / __double2float_rn)."""
    return F32(float(a) * float(b) + float(c))


def _clip(v, lo, hi):
    return min(max(v, lo), hi)


def _branch(mu):
    """clip(rint(mu * 128), 0, 127): jnp.round rounds half to even."""
    return min(max(int(np.rint(mu * F32(NFILT))), 0), NFILT - 1)


def _interp(er, ei64, b, b64, start, imu):
    """sum_j ext[start + j] * bank[imu, j] in order: the real part with
    each product rounded, the imaginary part with each product fused into
    its add (exact in float64, the sum rounded once to float32)."""
    sr = np.add.accumulate(er[start:start + NTAPS] * b[imu])[-1]
    si = _F0
    for v in ei64[start:start + NTAPS] * b64[imu]:     # exact products
        si = F32(float(si) + v)
    return sr, si


def gardner_walk_plain(ext: torch.Tensor, n: int, state: torch.Tensor,
                       bank: torch.Tensor, *, omega_mid: float,
                       gain_omega: float, gain_mu: float, omega_limit: float,
                       out_cap: int):
    """gardner_walk's plain version (CPU tensors): (syms, valid, state')."""
    e = torch.view_as_real(ext).numpy()
    er, ei64 = e[:, 0].copy(), e[:, 1].astype(np.float64)
    b = bank.numpy()
    b64 = b.astype(np.float64)
    st = state.numpy()
    mu, omega = F32(st[MU]), F32(st[OMEGA])
    lr, li = F32(st[LAST]), F32(st[LAST + 1])
    inc = int(st[INC:INC + 1].view(np.int32)[0])
    mid, g_om, g_mu, lim = (F32(omega_mid), F32(gain_omega), F32(gain_mu),
                            F32(omega_limit))
    syms = np.zeros((out_cap, 2), F32)
    k = 0
    while k < out_cap and inc < n:
        # the zero crossing half a symbol back (gardner.cpp:50-58), with
        # jnp.mod's rule: fmod, then + 1 where it is negative (which can
        # round to 1.0; the branch then clips to 127)
        muz = mu - omega * _HALF
        offzc = int(np.floor(omega * _HALF))
        a = muz + F32(offzc)
        mupos = np.fmod(a, _F1)
        if mupos < 0:
            mupos = mupos + _F1
        zr, zi = _interp(er, ei64, b, b64, _clip(inc - offzc, 0, n - 1),
                         _branch(mupos))
        sr, si = _interp(er, ei64, b, b64, _clip(inc, 0, n - 1), _branch(mu))
        err = _fma(zr, lr - sr, zi * (li - si))
        err = _clip(err, _FM1, _F1)
        om = _fma(g_om, err, omega)
        om = mid + _clip(om - mid, -lim, lim)
        mun = _fma(g_mu, err, mu + om)
        fl = np.floor(mun)
        inc = max(inc + int(fl), 0)
        mu = mun - fl
        omega = om
        lr, li = sr, si
        syms[k] = sr, si
        k += 1
    valid = np.zeros(out_cap, bool)
    valid[:k] = True
    out = np.zeros(STATE_SLOTS, F32)
    out[MU], out[OMEGA], out[LAST], out[LAST + 1] = mu, omega, lr, li
    out[INC:INC + 1].view(np.int32)[0] = max(inc - n, 0)
    return (torch.view_as_complex(torch.from_numpy(syms)),
            torch.from_numpy(valid), torch.from_numpy(out))


def gardner_walk(ext: torch.Tensor, n: int, state: torch.Tensor,
                 bank: torch.Tensor, *, omega_mid: float, gain_omega: float,
                 gain_mu: float, omega_limit: float, out_cap: int):
    """Gardner clock recovery over one block: ext = [history (7) | block
    (n)] complex64, bank (128, 8) float32, state float32[STATE_SLOTS].
    Returns (syms (out_cap,) complex64, zero past the valid ones; valid
    (out_cap,) bool, a prefix; state')."""
    if ext.device.type == "cpu":
        return gardner_walk_plain(ext, n, state, bank, omega_mid=omega_mid,
                                  gain_omega=gain_omega, gain_mu=gain_mu,
                                  omega_limit=omega_limit, out_cap=out_cap)
    if ext.device.type != "cuda":
        raise ValueError(f"gardner_walk: unsupported device {ext.device}")
    dev = ext.device
    if ext.dtype != torch.complex64 or ext.ndim != 1 \
            or not ext.is_contiguous() or ext.shape[0] != n + NTAPS - 1:
        raise ValueError(f"gardner_walk: ext must be contiguous 1-D "
                         f"complex64 of n + {NTAPS - 1} = {n + NTAPS - 1}, "
                         f"got {tuple(ext.shape)} {ext.dtype}")
    if bank.shape != (NFILT, NTAPS) or bank.dtype != torch.float32 \
            or not bank.is_contiguous() or bank.device != dev:
        raise ValueError(f"gardner_walk: bank must be contiguous ({NFILT}, "
                         f"{NTAPS}) float32 on {dev}, got {tuple(bank.shape)}"
                         f" {bank.dtype} on {bank.device}")
    if state.shape != (STATE_SLOTS,) or state.dtype != torch.float32 \
            or not state.is_contiguous() or state.device != dev:
        raise ValueError(f"gardner_walk: state must be ({STATE_SLOTS},) "
                         f"float32 on {dev}, got {tuple(state.shape)} "
                         f"{state.dtype} on {state.device}")
    if n < 1 or n + NTAPS >= 2 ** 31 or not 1 <= out_cap < 2 ** 31:
        raise ValueError(f"gardner_walk: need 1 <= n < 2^31 - {NTAPS} and "
                         f"1 <= out_cap < 2^31 (n={n}, out_cap={out_cap})")
    syms = torch.empty(out_cap, dtype=torch.complex64, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    out_state = torch.empty_like(state)
    _KERNEL(dev.index, ext.data_ptr(), n, bank.data_ptr(), state.data_ptr(),
            out_state.data_ptr(), syms.data_ptr(), valid.data_ptr(), out_cap,
            float(F32(omega_mid)), float(F32(gain_omega)),
            float(F32(gain_mu)), float(F32(omega_limit)))
    gardner_walk.launches += 1
    return syms, valid, out_state


gardner_walk.launches = 0
