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

_NAME = "probe_affine"


def _launcher():
    lib = _build.load(_NAME)
    fn = lib.probe_affine_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def affine_probe(x: torch.Tensor) -> torch.Tensor:
    """Contiguous float32 x of any shape -> 2x + 1, same shape."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"affine_probe: need contiguous float32, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    if x.device.type == "cpu":
        return x * 2 + 1
    if x.device.type != "cuda":
        raise ValueError(f"affine_probe: unsupported device {x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    _build.check(_NAME, lib, err)
    affine_probe.launches += 1
    return y


affine_probe.launches = 0
