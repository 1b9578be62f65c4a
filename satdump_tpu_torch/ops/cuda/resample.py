"""K2 wrapper: arithmetic-grid polyphase resampler (csrc/resample_arith.cu).

Counterpart of satdump_tpu/ops/pallas/resample.py::resample_arith_grid. On a
CUDA tensor it launches the hand kernel; on a CPU tensor it runs the plain
version, `resample_arith_grid_plain`: `interp_at` (the unmasked core of
ops/ffsync.py::ff_resample_at) on the grid p_k = start + k*omega.
"""

from __future__ import annotations

import ctypes

import torch

from satdump_tpu_torch.ops.cuda import _build

NFILT = 128
NTAPS = 8

_KERNEL = _build.Kernel("resample_arith", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])


def interp_at(ext: torch.Tensor, positions: torch.Tensor, bank: torch.Tensor,
              n_in: int) -> torch.Tensor:
    """Unmasked polyphase interpolation of `ext` at `positions` (+ntaps/2,
    the bank's group delay), the core of ops/ffsync.py::ff_resample_at.
    Window ext[src .. src+ntaps) with src clipped to [0, n_in)."""
    nfilt, ntaps = bank.shape
    if ext.shape[0] < n_in + ntaps - 1:
        raise ValueError(f"interp_at: ext has {ext.shape[0]} samples, "
                         f"needs n_in + ntaps - 1 = {n_in + ntaps - 1}")
    p = positions + ntaps / 2
    ip = torch.floor(p)
    frac = p - ip
    # torch raises on out-of-range gathers where JAX clamps: the clip keeps
    # every window inside ext by construction
    srcc = ip.to(torch.int64).clamp(0, n_in - 1)
    branch = torch.round(frac * nfilt).to(torch.int64).clamp(0, nfilt - 1)
    idx = srcc[:, None] + torch.arange(ntaps, device=ext.device)[None, :]
    windows = ext[idx]                  # (cap, ntaps)
    taps = bank[branch]                 # (cap, ntaps)
    return (windows * taps).sum(dim=-1)


def resample_arith_grid_plain(ext: torch.Tensor, start: torch.Tensor,
                              omega: torch.Tensor, bank: torch.Tensor, *,
                              out_cap: int) -> torch.Tensor:
    """Plain torch version of the kernel (any device): `interp_at` on the
    grid p_k = start + k*omega, formed in float32 as the kernel forms it."""
    k = torch.arange(out_cap, dtype=torch.float32, device=ext.device)
    positions = start + k * omega
    return interp_at(ext, positions, bank, ext.shape[0] - (NTAPS - 1))


def resample_arith_grid(ext: torch.Tensor, start: torch.Tensor,
                        omega: torch.Tensor, bank: torch.Tensor, *,
                        out_cap: int) -> torch.Tensor:
    """Polyphase-interpolate complex `ext` at p_k = start + k*omega
    (+NTAPS/2 group-delay shift, as ff_resample_at) for k < out_cap.

    ext: (n_ext,) complex64. start, omega: float32 scalars on ext's device
    (read by the kernel through device pointers, no host sync). bank:
    (128, 8) float32, 16-byte aligned on the card. Returns (out_cap,)
    complex64; the caller applies the validity mask. (The TPU kernel's
    `sps_max` sized its DMA window; this kernel stages no window, so it
    takes none and is right for any omega.)"""
    dev = ext.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return resample_arith_grid_plain(ext, start, omega, bank,
                                             out_cap=out_cap)
        raise ValueError(f"resample_arith_grid: unsupported device {dev}")
    if ext.dtype != torch.complex64 or ext.ndim != 1 \
            or not ext.is_contiguous():
        raise ValueError("resample_arith_grid: ext must be contiguous 1-D "
                         f"complex64, got {tuple(ext.shape)} {ext.dtype}")
    bank_ptr = bank.data_ptr()
    # the kernel reads a bank row as two 16-byte loads
    if bank.shape != (NFILT, NTAPS) or bank.dtype != torch.float32 \
            or not bank.is_contiguous() or bank_ptr % 16:
        raise ValueError("resample_arith_grid: bank must be contiguous, "
                         "16-byte aligned (128, 8) float32, got "
                         f"{tuple(bank.shape)} {bank.dtype}")
    # a one-element tensor is contiguous whatever its strides
    if start.dtype != torch.float32 or omega.dtype != torch.float32 \
            or start.numel() != 1 or omega.numel() != 1:
        raise ValueError("resample_arith_grid: start and omega must be one "
                         f"float32 each, got {tuple(start.shape)} "
                         f"{start.dtype}, {tuple(omega.shape)} {omega.dtype}")
    if start.device != dev or omega.device != dev or bank.device != dev:
        raise ValueError("resample_arith_grid: all inputs on one device")
    n_ext = ext.shape[0]
    if n_ext < NTAPS or n_ext >= 2 ** 31 or out_cap >= 2 ** 24:
        # k is formed in float32 inside the kernel: exact below 2^24
        raise ValueError(f"resample_arith_grid: need {NTAPS} <= n_ext < "
                         f"2^31 and out_cap < 2^24 (n_ext={n_ext}, "
                         f"out_cap={out_cap})")
    out = torch.empty(out_cap, dtype=torch.complex64, device=dev)
    if out_cap == 0:
        return out
    _KERNEL(dev.index, ext.data_ptr(), n_ext, start.data_ptr(),
            omega.data_ptr(), bank_ptr, out.data_ptr(), out_cap)
    resample_arith_grid.launches += 1
    return out


resample_arith_grid.launches = 0
