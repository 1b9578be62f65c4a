"""Toolchain probe wrapper: y = 2x + 1 on float32 (csrc/probe_affine.cu).

Counterpart of tools/pallas_smoke.py:10 `f`, the JAX package's check that its
TPU toolchain builds and launches a kernel. It lies on no data path:
chip_smoke.py launches it right after the build. Bound by bytes (one read
and one write per element). On a CUDA tensor it launches the kernel; on a
CPU tensor it runs the plain version, `x * 2 + 1`, which equals the kernel
bit for bit (2x is exact, so both round once).
"""

from __future__ import annotations

import ctypes

import torch

from satdump_tpu_torch.ops.cuda import _build

_KERNEL = _build.Kernel("probe_affine", [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_longlong])


def affine_probe(x: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 x of any shape -> 2x + 1, same shape."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"affine_probe: need contiguous float32, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    dev = x.device
    if dev.type == "cpu":
        return x * 2 + 1
    if dev.type != "cuda":
        raise ValueError(f"affine_probe: unsupported device {dev}")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    _KERNEL(dev.index, x.data_ptr(), y.data_ptr(), n)
    affine_probe.launches += 1
    return y


affine_probe.launches = 0
