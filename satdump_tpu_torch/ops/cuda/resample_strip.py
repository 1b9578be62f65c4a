"""K4 wrapper: the strip symbol pick (csrc/resample_strip.cu).

Replaces no Pallas kernel: the JAX package's ops/ffsync.py::resample_strip
is plain jnp that XLA fuses. On a CUDA tensor this launches the hand kernel,
one launch a block; on a CPU tensor it runs the plain version,
ops/ffsync.py::resample_strip, which the kernel equals bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from satdump_tpu_torch.ops.cuda import _build

NTAPS = 8
NCOEF = 11          # the degree-10 polynomials of ops/ffsync.py

_KERNEL = _build.Kernel("resample_strip", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int])


def resample_strip(ext: torch.Tensor, start: torch.Tensor,
                   omega: torch.Tensor, coefs: torch.Tensor, *, out_cap: int,
                   sps: float, n_in: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick symbols from complex `ext` (history + block) at p_k = start +
    k*omega, k < out_cap, as ops/ffsync.py::resample_strip: returns
    (symbols (out_cap,) complex64, zero where invalid; valid (out_cap,)).

    ext: (n_ext,) complex64, n_ext >= n_in + NTAPS - 1. start, omega: one
    float32 each on ext's device (the kernel reads them through device
    pointers, no host sync). coefs: the (NCOEF, NTAPS) float32 tap
    polynomials (ops/ffsync.py::interp_tables). sps must have a strip
    geometry (ops/ffsync.py::_strip_geometry)."""
    from satdump_tpu_torch.ops import ffsync
    if ext.dtype != torch.complex64 or ext.ndim != 1 \
            or not ext.is_contiguous():
        raise ValueError("resample_strip: ext must be contiguous 1-D "
                         f"complex64, got {tuple(ext.shape)} {ext.dtype}")
    # a one-element tensor is contiguous whatever its strides
    if start.dtype != torch.float32 or omega.dtype != torch.float32 \
            or start.numel() != 1 or omega.numel() != 1:
        raise ValueError("resample_strip: start and omega must be one "
                         f"float32 each, got {tuple(start.shape)} "
                         f"{start.dtype}, {tuple(omega.shape)} {omega.dtype}")
    if tuple(coefs.shape) != (NCOEF, NTAPS) \
            or coefs.dtype != torch.float32 or not coefs.is_contiguous():
        raise ValueError(f"resample_strip: coefs must be contiguous "
                         f"({NCOEF}, {NTAPS}) float32, got "
                         f"{tuple(coefs.shape)} {coefs.dtype}")
    n_ext = ext.shape[0]
    if not 0 <= out_cap < 2 ** 24 or not 0 < n_in <= n_ext - (NTAPS - 1) \
            or n_ext >= 2 ** 31:
        # k is formed in float32 inside the kernel: exact below 2^24
        raise ValueError(f"resample_strip: need 0 <= out_cap < 2^24, "
                         f"0 < n_in <= n_ext - {NTAPS - 1} and n_ext < "
                         f"2^31 (out_cap={out_cap}, n_in={n_in}, "
                         f"n_ext={n_ext})")
    geo = ffsync._strip_geometry(sps, NTAPS)
    if geo is None:
        raise ValueError(f"resample_strip: sps {sps} has no strip geometry")
    dev = ext.device
    if start.device != dev or omega.device != dev or coefs.device != dev:
        raise ValueError("resample_strip: all inputs on one device")
    if dev.type == "cpu":
        return ffsync.resample_strip(ext, start, omega, coefs,
                                     out_cap=out_cap, sps=sps, n_in=n_in)
    if dev.type != "cuda":
        raise ValueError(f"resample_strip: unsupported device {dev}")
    G, D = geo
    s0 = round(sps)
    out = torch.empty(out_cap, dtype=torch.complex64, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    if out_cap == 0:
        return out, valid
    _KERNEL(dev.index, ext.data_ptr(), n_ext, start.data_ptr(),
            omega.data_ptr(), coefs.data_ptr(), out.data_ptr(),
            valid.data_ptr(), out_cap, n_in,
            ffsync.strip_window(out_cap, n_ext, G, D, s0, NTAPS)[1],
            ffsync.STRIP_FRONT, G, D, s0)
    resample_strip.launches += 1
    return out, valid


resample_strip.launches = 0
