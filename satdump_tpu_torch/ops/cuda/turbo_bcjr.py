"""Wrapper of the max-log BCJR kernel (csrc/turbo_bcjr.cu).

Counterpart of the two lax.scan recursions of satdump_tpu/ops/fec/turbo.py::
_bcjr_maxlog. On a CUDA tensor `turbo_bcjr` launches the kernel; on a CPU
tensor it runs `turbo_bcjr_plain`, which does the kernel's operations in
the kernel's order with torch ops (the branch metrics summed over the
components in order, then the forward and backward recursions one step at a
time over all frames and states, then the APP), so the two give the same
LLRs bit for bit. The plain version takes tensors on any device, so it can
also be timed and compared on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda import _build
from satdump_tpu_torch.ops.fec.turbo_trellis import (MEMORY, NSTATES,
                                                    _bcjr_tables)

NEG = -1e9
# the component ids of the kernel's code (csrc/turbo_bcjr.cu code_of)
COMP_IDS = {"sys": 0, "p1": 1, "p2": 2, "p3": 3}
# the component lists of the CCSDS rates: the kernel's template instances
KERNEL_COMPS = (("sys", "p1"), ("sys", "p2", "p3"), ("sys", "p1", "p2", "p3"),
                ("p1",), ("p1", "p3"))

_KERNEL = _build.Kernel("turbo_bcjr", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int])


def comps_code(comps: Tuple[str, ...]) -> int:
    """The kernel's code for a component list: id_c << 2c summed."""
    return sum(COMP_IDS[c] << (2 * i) for i, c in enumerate(comps))


def _tables(comps: Tuple[str, ...], dev: torch.device):
    """Next states (16, 2), output signs (16, 2, C) and, for each next
    state, the flat (s * 2 + b) indices of its two incoming branches."""
    ns_t, sgn, _ = _bcjr_tables(tuple(comps))
    pred = np.zeros((NSTATES, 2), np.int64)
    for sp in range(NSTATES):
        pred[sp] = np.flatnonzero(ns_t.reshape(-1) == sp)
    return (torch.from_numpy(ns_t.astype(np.int64)).to(dev),
            torch.from_numpy(sgn).to(dev),
            torch.from_numpy(pred.reshape(-1)).to(dev))


def branch_metrics(Lch: torch.Tensor, La: torch.Tensor, sg: torch.Tensor
                   ) -> torch.Tensor:
    """g (B, S, 16, 2): 0.5 * (the components' signed LLRs summed in
    order) + (0.5 * La) * (-1, +1), La zero on the tail steps."""
    B, S, C = Lch.shape
    acc = Lch[:, :, None, None, 0] * sg[:, :, 0]
    for c in range(1, C):
        acc = acc + Lch[:, :, None, None, c] * sg[:, :, c]
    La_full = torch.cat([La, La.new_zeros((B, S - La.shape[1]))], dim=1)
    pm = torch.tensor([-1.0, 1.0], dtype=torch.float32, device=Lch.device)
    return 0.5 * acc + (0.5 * La_full)[:, :, None, None] * pm


def turbo_bcjr_plain(Lch: torch.Tensor, La: torch.Tensor,
                     comps: Tuple[str, ...]) -> torch.Tensor:
    """turbo_bcjr's plain version (tensors on any device): APP (B, K)."""
    dev = Lch.device
    B, S, C = Lch.shape
    K = S - MEMORY
    ns, sg, pred = _tables(comps, dev)
    g = branch_metrics(Lch, La, sg)
    start = torch.full((B, NSTATES), NEG, dtype=torch.float32, device=dev)
    start[:, 0] = 0.0
    alphas = torch.empty((B, S, NSTATES), dtype=torch.float32, device=dev)
    alpha = start
    for t in range(S):
        alphas[:, t] = alpha
        m = (alpha[:, :, None] + g[:, t]).reshape(B, 2 * NSTATES)
        c = m.index_select(1, pred).reshape(B, NSTATES, 2)
        a2 = torch.maximum(c[..., 0], c[..., 1]).clamp_min(NEG)
        alpha = a2 - a2.amax(-1, keepdim=True)
    betas = torch.empty((B, S, NSTATES), dtype=torch.float32, device=dev)
    beta = start
    flat_ns = ns.reshape(-1)
    for t in range(S - 1, -1, -1):
        betas[:, t] = beta                  # beta_{t+1}
        bn = beta.index_select(1, flat_ns).reshape(B, NSTATES, 2)
        b2 = (g[:, t] + bn).amax(-1)
        beta = b2 - b2.amax(-1, keepdim=True)
    bn = betas[:, :K].index_select(2, flat_ns).reshape(B, K, NSTATES, 2)
    metric = (alphas[:, :K, :, None] + g[:, :K]) + bn
    return metric[..., 1].amax(-1) - metric[..., 0].amax(-1)


def turbo_bcjr(Lch: torch.Tensor, La: torch.Tensor,
               comps: Tuple[str, ...]) -> torch.Tensor:
    """Max-log BCJR over a batch of frames: Lch (B, S, C) float32 channel
    LLRs of the components `comps`, La (B, S - 4) float32 a-priori LLRs.
    Returns the APP LLRs (B, S - 4) float32 on their device."""
    if Lch.device.type == "cpu":
        return turbo_bcjr_plain(Lch, La, comps)
    if Lch.device.type != "cuda":
        raise ValueError(f"turbo_bcjr: unsupported device {Lch.device}")
    comps = tuple(comps)
    if comps not in KERNEL_COMPS:
        raise ValueError(f"turbo_bcjr: no kernel for components {comps}")
    dev = Lch.device
    if Lch.dtype != torch.float32 or Lch.ndim != 3 \
            or not Lch.is_contiguous() or Lch.shape[2] != len(comps):
        raise ValueError(f"turbo_bcjr: Lch must be contiguous (B, S, "
                         f"{len(comps)}) float32, got {tuple(Lch.shape)} "
                         f"{Lch.dtype}")
    B, S, C = Lch.shape
    if La.dtype != torch.float32 or tuple(La.shape) != (B, S - MEMORY) \
            or not La.is_contiguous() or La.device != dev:
        raise ValueError(f"turbo_bcjr: La must be contiguous ({B}, "
                         f"{S - MEMORY}) float32 on {dev}, got "
                         f"{tuple(La.shape)} {La.dtype} on {La.device}")
    if B < 1 or S <= MEMORY or B * S * NSTATES * 2 >= 2 ** 62:
        raise ValueError(f"turbo_bcjr: need B >= 1 and S > {MEMORY} "
                         f"(B={B}, S={S})")
    app = torch.empty((B, S - MEMORY), dtype=torch.float32, device=dev)
    ws = torch.empty((2, S, NSTATES, B), dtype=torch.float32, device=dev)
    _KERNEL(dev.index, Lch.data_ptr(), La.data_ptr(), app.data_ptr(),
            ws.data_ptr(), B, S, C, comps_code(comps))
    turbo_bcjr.launches += 1
    return app


turbo_bcjr.launches = 0
