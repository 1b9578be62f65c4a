"""K3 wrapper: the block Viterbi's ACS pass and traceback
(csrc/viterbi_block.cu).

The port's own kernel (the JAX package runs a lax.scan there). Its entry
points are ops/fec/convolutional.py's `viterbi_acs` and `viterbi_traceback`
(and so `viterbi_decode_block`, `viterbi_decode_tiled` and `StreamViterbi`):
on a CPU tensor they run their plain versions (`_acs_plain`,
`_traceback_plain`), on a CUDA tensor they call `viterbi_block_acs` and
`viterbi_block_traceback` here (the entries `viterbi_block_acs_launch` and
`viterbi_block_traceback_launch`).
These two take CUDA tensors only and raise otherwise: there is no fallback.

Decisions are one int64 word a step, (B, T): the decision of state 2m + c
is bit 32c + m.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from satdump_tpu_torch.ops.cuda import _build

NSTATES = 64
MAX_T = 1 << 29             # the kernel indexes a row's floats with int

_ACS = _build.Kernel("viterbi_block", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int], entry="viterbi_block_acs")
_TRACEBACK = _build.Kernel("viterbi_block", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int], entry="viterbi_block_traceback")


def _check_cuda(fn: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev} (a CUDA tensor; "
                         "convolutional.py runs the plain version on the "
                         "CPU)")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs on one device")
    return dev


def viterbi_block_acs(pm: torch.Tensor, soft: torch.Tensor,
                      renorm: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pm (B, 64) float32, soft (B, T, 2) float32 in [0, 255] on the card ->
    (new pm (B, 64), decisions (B, T) int64)."""
    dev = _check_cuda("viterbi_block_acs", pm, soft)
    if soft.dtype != torch.float32 or pm.dtype != torch.float32 \
            or soft.ndim != 3 or soft.shape[2] != 2 \
            or pm.shape != (soft.shape[0], NSTATES):
        raise ValueError(f"viterbi_block_acs: need pm (B, 64) and soft "
                         f"(B, T, 2) float32, got {tuple(pm.shape)} "
                         f"{pm.dtype}, {tuple(soft.shape)} {soft.dtype}")
    B, T = soft.shape[0], soft.shape[1]
    if T >= MAX_T:
        raise ValueError(f"viterbi_block_acs: T = {T} >= 2^29")
    pm_out = torch.empty((B, NSTATES), dtype=torch.float32, device=dev)
    dec = torch.empty((B, T), dtype=torch.int64, device=dev)
    if B == 0:
        return pm_out, dec
    soft, pm = soft.contiguous(), pm.contiguous()
    _ACS(dev.index, soft.data_ptr(), pm.data_ptr(), pm_out.data_ptr(),
         dec.data_ptr(), B, T, int(bool(renorm)))
    viterbi_block_acs.launches += 1
    return pm_out, dec


def viterbi_block_traceback(pm: torch.Tensor, decisions: torch.Tensor
                            ) -> torch.Tensor:
    """pm (B, 64) float32, decisions (B, T) int64 on the card -> bits (B, T)
    uint8, traced back from argmin(pm) (the lowest state on ties)."""
    dev = _check_cuda("viterbi_block_traceback", pm, decisions)
    if pm.dtype != torch.float32 or decisions.dtype != torch.int64 \
            or decisions.ndim != 2 \
            or pm.shape != (decisions.shape[0], NSTATES):
        raise ValueError(f"viterbi_block_traceback: need pm (B, 64) float32 "
                         f"and decisions (B, T) int64, got "
                         f"{tuple(pm.shape)} {pm.dtype}, "
                         f"{tuple(decisions.shape)} {decisions.dtype}")
    B, T = decisions.shape
    if T >= MAX_T:
        raise ValueError(f"viterbi_block_traceback: T = {T} >= 2^29")
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    if B == 0:
        return bits
    pm, decisions = pm.contiguous(), decisions.contiguous()
    _TRACEBACK(dev.index, pm.data_ptr(), decisions.data_ptr(),
               bits.data_ptr(), B, T)
    viterbi_block_traceback.launches += 1
    return bits


viterbi_block_acs.launches = 0
viterbi_block_traceback.launches = 0
