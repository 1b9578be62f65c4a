"""Costas carrier-recovery loop, orders 2/4/8, and the carrier-tracking PLL
(ref common/dsp/pll/costas_loop.cpp, pll_carrier_tracking.cpp) — port of
satdump_tpu/ops/costas.py.

Both are per-sample feedback loops; each block is one walk of the sample
walker (ops/cuda/sample_walk.py: a hand kernel on the card, its plain
version on the CPU), with the loop state in a float32 tensor on the block's
device. The feedforward carrier sync of the fast path is ops/ffsync.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from satdump_tpu_torch.ops.cuda import sample_walk
from satdump_tpu_torch.utils.device import resolve_device


class CostasState(NamedTuple):
    phase: torch.Tensor  # float32 scalar
    freq: torch.Tensor   # float32 scalar (rad/sample)


def _zeros2(device) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros(2, dtype=torch.float32, device=resolve_device(device))
    return z[0], z[1]


def costas_init(device: str | torch.device | None = None) -> CostasState:
    return CostasState(*_zeros2(device))


def costas_gains(loop_bw: float) -> Tuple[float, float]:
    """alpha/beta from loop bandwidth (ref costas_loop.cpp:8-12)."""
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4 * damping * loop_bw) / denom
    beta = (4 * loop_bw * loop_bw) / denom
    return alpha, beta


def _state_vec(phase: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    return torch.stack([phase, freq]).to(torch.float32)


def costas_scan(state: CostasState, x: torch.Tensor, loop_bw: float,
                order: int, freq_limit: float = 1.0
                ) -> Tuple[CostasState, torch.Tensor]:
    """Per-sample Costas loop on (N,) complex64 x: mix by e^{-j phase},
    error of the order's detector clipped to +-1, freq += beta err, phase
    += freq + alpha err (wrapped to [-2 pi, 2 pi)), freq clipped to
    +-freq_limit. Returns (state', mixed samples)."""
    alpha, beta = costas_gains(loop_bw)
    y, st = sample_walk.costas_walk(x, _state_vec(*state), alpha, beta,
                                    order, freq_limit)
    return CostasState(st[0], st[1]), y


class PLLState(NamedTuple):
    phase: torch.Tensor
    freq: torch.Tensor


def pll_init(device: str | torch.device | None = None) -> PLLState:
    return PLLState(*_zeros2(device))


def pll_carrier_scan(state: PLLState, x: torch.Tensor, loop_bw: float,
                     max_offset: float = 3.14
                     ) -> Tuple[PLLState, torch.Tensor]:
    """Carrier-tracking PLL: locks to a residual carrier through the
    arg(x e^{-j phase}) error and returns the carrier-wiped signal."""
    alpha, beta = costas_gains(loop_bw)
    y, st = sample_walk.pll_walk(x, _state_vec(*state), alpha, beta,
                                 max_offset)
    return PLLState(st[0], st[1]), y
