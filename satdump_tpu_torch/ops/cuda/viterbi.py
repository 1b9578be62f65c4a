"""K1 wrapper: the register-exchange Viterbi (csrc/viterbi_re.cu).

Counterpart of satdump_tpu/ops/pallas/viterbi.py::viterbi_re_pallas. On a
CUDA tensor it launches the hand kernel; on a CPU tensor it runs the plain
version, ops/fec/convolutional.py::viterbi_decode_tiled_re. The two are
bit-identical (chip_smoke.py holds them to that on the card).
"""

from __future__ import annotations

import ctypes

import torch

from satdump_tpu_torch.ops.cuda import _build
from satdump_tpu_torch.ops.fec import convolutional as cc

_KERNEL = _build.Kernel("viterbi_re", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


def viterbi_re(soft: torch.Tensor, seg: int = 1024, ovl: int = 128
               ) -> torch.Tensor:
    """soft (T, 2) float32 in [0, 255] (T a multiple of seg, 128 =
    erasure) -> (T,) uint8 decoded bits."""
    if soft.device.type == "cpu":
        return cc.viterbi_decode_tiled_re(soft, seg=seg, ovl=ovl)
    if soft.device.type != "cuda":
        raise ValueError(f"viterbi_re: unsupported device {soft.device}")
    if soft.dtype != torch.float32 or soft.ndim != 2 or soft.shape[1] != 2:
        raise ValueError(f"viterbi_re: need (T, 2) float32, got "
                         f"{tuple(soft.shape)} {soft.dtype}")
    # the kernel stages each pair by an 8-byte cp.async
    if not soft.is_contiguous() or soft.data_ptr() % 8:
        raise ValueError("viterbi_re: soft must be contiguous, its pairs "
                         "8-byte aligned")
    T = soft.shape[0]
    if T % seg or ovl < cc.RE_DELAY or T + ovl + seg >= 2 ** 31:
        raise ValueError(f"viterbi_re: need T % seg == 0, ovl >= "
                         f"{cc.RE_DELAY}, T + ovl + seg < 2^31 (T={T}, "
                         f"seg={seg}, ovl={ovl})")
    out = torch.empty(T, dtype=torch.uint8, device=soft.device)
    if T == 0:
        return out
    _KERNEL(soft.device.index, soft.data_ptr(), T, T // seg, seg, ovl,
            out.data_ptr())
    viterbi_re.launches += 1
    return out


viterbi_re.launches = 0
