"""Mueller & Müller symbol-timing recovery (ref common/dsp/clock_recovery/
clock_recovery_mm.cpp) — port of satdump_tpu/ops/clock_recovery.py's
`mm_clock_recovery`.

The reference consumes a data-dependent number of input samples per output
symbol (`inc += floor(mu)`). As in the JAX package, a block gives a fixed
capacity of output slots with a validity mask (a prefix), and the input
offset and the last ntaps - 1 samples carry into the next block. The walk
is the M&M walker (ops/cuda/mm_clock.py: a hand kernel on the card, its
plain version on the CPU). Interpolation uses the 128-branch Nuttall
windowed-sinc bank (firdes.mm_interpolator_bank).

`gardner_clock_recovery` (ref clock_recovery_gardner.cpp) walks the same
way on the Gardner walker (ops/cuda/gardner.py); as in the JAX package, no
pipeline calls it.

The feedforward (Oerder & Meyr) fast path lives in ops/ffsync.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda import gardner, mm_clock
from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
from satdump_tpu_torch.utils.device import resolve_device

F32 = torch.float32


class MMState(NamedTuple):
    mu: torch.Tensor          # float32, fractional interpolation phase [0,1)
    omega: torch.Tensor       # float32, samples/symbol estimate
    inc: torch.Tensor         # int32, input offset carried into the next block
    history: torch.Tensor     # (ntaps-1,) last input samples
    p_regs: torch.Tensor      # (3,) complex64: p_0T, p_1T, p_2T
    c_regs: torch.Tensor      # (3,) complex64: c_0T, c_1T, c_2T
    last_sample: torch.Tensor  # float32 (real-mode M&M)


def mm_init(omega: float, mu: float = 0.5, ntaps: int = 8,
            dtype=torch.complex64,
            device: str | torch.device | None = None) -> MMState:
    dev = resolve_device(device)
    return MMState(
        mu=torch.tensor(mu, dtype=F32, device=dev),
        omega=torch.tensor(omega, dtype=F32, device=dev),
        inc=torch.zeros((), dtype=torch.int32, device=dev),
        history=torch.zeros(ntaps - 1, dtype=dtype, device=dev),
        p_regs=torch.zeros(3, dtype=torch.complex64, device=dev),
        c_regs=torch.zeros(3, dtype=torch.complex64, device=dev),
        last_sample=torch.zeros((), dtype=F32, device=dev),
    )


def mm_params_from_loop(omega: float, clock_alpha: float = 8.7e-3,
                        omega_relative_limit: float = 0.005):
    """Gain derivation as in module_psk_demod.cpp:43-47."""
    gain_mu = clock_alpha
    gain_omega = clock_alpha * clock_alpha / 4.0
    return dict(omega=omega, gain_omega=gain_omega, gain_mu=gain_mu,
                omega_relative_limit=omega_relative_limit)


def _pack(state: MMState) -> torch.Tensor:
    """MMState -> the walker's float32[STATE_SLOTS] vector."""
    scalars = torch.stack([state.mu.to(F32), state.omega.to(F32),
                           state.inc.to(torch.int32).view(F32),
                           state.last_sample.to(F32)])
    regs = torch.cat([torch.view_as_real(state.p_regs).reshape(-1),
                      torch.view_as_real(state.c_regs).reshape(-1)])
    return torch.cat([scalars, regs]).contiguous()


def _unpack(v: torch.Tensor, history: torch.Tensor) -> MMState:
    s = mm_clock
    return MMState(
        mu=v[s.MU], omega=v[s.OMEGA], inc=v[s.INC:s.INC + 1].view(
            torch.int32)[0], history=history,
        p_regs=torch.view_as_complex(v[s.P_REGS:s.C_REGS].reshape(3, 2)),
        c_regs=torch.view_as_complex(
            v[s.C_REGS:s.STATE_SLOTS].reshape(3, 2)),
        last_sample=v[s.LAST])


def mm_clock_recovery(state: MMState, x: torch.Tensor, *,
                      omega_mid: float, gain_omega: float, gain_mu: float,
                      omega_relative_limit: float,
                      bank: torch.Tensor | None = None,
                      out_cap: int | None = None,
                      complex_mode: bool = True
                      ) -> Tuple[MMState, torch.Tensor, torch.Tensor]:
    """One block of M&M clock recovery on (n,) complex64 x (real mode reads
    the real part: fsk_demod, sdpsk_demod). Returns (state', symbols
    (out_cap,), valid (out_cap,) bool); symbols past the valid count are
    zeros. out_cap defaults to ceil(n / (omega_mid*(1-limit)))+2."""
    v, history, syms, valid = mm_clock_recovery_packed(
        _pack(state), state.history, x, omega_mid=omega_mid,
        gain_omega=gain_omega, gain_mu=gain_mu,
        omega_relative_limit=omega_relative_limit, bank=bank,
        out_cap=out_cap, complex_mode=complex_mode)
    return _unpack(v, history), syms, valid


def mm_clock_recovery_packed(v: torch.Tensor, history: torch.Tensor,
                             x: torch.Tensor, *, omega_mid: float,
                             gain_omega: float, gain_mu: float,
                             omega_relative_limit: float,
                             bank: torch.Tensor | None = None,
                             out_cap: int | None = None,
                             complex_mode: bool = True):
    """mm_clock_recovery on the walker's packed state vector (`_pack`), as
    a demod keeps it from block to block: returns (v', history', symbols,
    valid), with no packing or unpacking between blocks."""
    if bank is None:
        bank = torch.as_tensor(mm_interpolator_bank(), device=x.device)
    nfilt, ntaps = bank.shape
    n = x.shape[-1]
    if out_cap is None:
        out_cap = int(np.ceil(n / (omega_mid * (1.0 - omega_relative_limit)))
                      ) + 2
    # [history(ntaps-1) | input(n)], the reference's buffer layout
    # (clock_recovery_mm.cpp:47)
    ext = torch.cat([history[: ntaps - 1], x])
    syms, valid, v = mm_clock.mm_walk(
        ext, n, v, bank, omega_mid=omega_mid,
        gain_omega=gain_omega, gain_mu=gain_mu,
        omega_limit=omega_relative_limit * omega_mid, out_cap=out_cap,
        complex_mode=complex_mode)
    return v, ext[n:], syms, valid


class GardnerState(NamedTuple):
    mu: torch.Tensor           # float32, fractional interpolation phase
    omega: torch.Tensor        # float32, samples/symbol estimate
    inc: torch.Tensor          # int32, input offset carried into the next block
    history: torch.Tensor      # (ntaps-1,) last input samples
    last_sample: torch.Tensor  # complex64, the previous on-time sample


def gardner_init(omega: float, mu: float = 0.5, ntaps: int = 8,
                 dtype=torch.complex64,
                 device: str | torch.device | None = None) -> GardnerState:
    dev = resolve_device(device)
    return GardnerState(
        mu=torch.tensor(mu, dtype=F32, device=dev),
        omega=torch.tensor(omega, dtype=F32, device=dev),
        inc=torch.zeros((), dtype=torch.int32, device=dev),
        history=torch.zeros(ntaps - 1, dtype=dtype, device=dev),
        last_sample=torch.zeros((), dtype=torch.complex64, device=dev),
    )


def _gardner_pack(state: GardnerState) -> torch.Tensor:
    """GardnerState -> the walker's float32[STATE_SLOTS] vector."""
    g = gardner
    v = torch.zeros(g.STATE_SLOTS, dtype=F32, device=state.mu.device)
    v[g.MU] = state.mu
    v[g.OMEGA] = state.omega
    v[g.INC:g.INC + 1] = state.inc.to(torch.int32).reshape(1).view(F32)
    v[g.LAST:g.LAST + 2] = torch.view_as_real(
        state.last_sample.to(torch.complex64))
    return v


def _gardner_unpack(v: torch.Tensor, history: torch.Tensor) -> GardnerState:
    g = gardner
    return GardnerState(
        mu=v[g.MU], omega=v[g.OMEGA],
        inc=v[g.INC:g.INC + 1].view(torch.int32)[0], history=history,
        last_sample=torch.view_as_complex(v[g.LAST:g.LAST + 2]))


def gardner_clock_recovery(state: GardnerState, x: torch.Tensor, *,
                           omega_mid: float, gain_omega: float,
                           gain_mu: float, omega_relative_limit: float,
                           bank: torch.Tensor | None = None,
                           out_cap: int | None = None
                           ) -> Tuple[GardnerState, torch.Tensor,
                                      torch.Tensor]:
    """Gardner timing-error-detector clock recovery over one block of (n,)
    complex64 x (ref common/dsp/clock_recovery/clock_recovery_gardner.cpp:
    33-100): per output symbol interpolate the on-time sample and the
    zero-crossing sample half a symbol earlier; the TED is
    Re{zc} (Re{last} - Re{cur}) + Im{zc} (Im{last} - Im{cur}). Returns
    (state', symbols (out_cap,), valid (out_cap,) bool); symbols past the
    valid count are zeros. out_cap defaults to
    ceil(n / (omega_mid*(1-limit)))+2."""
    if bank is None:
        bank = torch.as_tensor(mm_interpolator_bank(), device=x.device)
    nfilt, ntaps = bank.shape
    n = x.shape[-1]
    if out_cap is None:
        out_cap = int(np.ceil(n / (omega_mid * (1.0 - omega_relative_limit)))
                      ) + 2
    ext = torch.cat([state.history[: ntaps - 1], x])
    syms, valid, v = gardner.gardner_walk(
        ext, n, _gardner_pack(state), bank, omega_mid=omega_mid,
        gain_omega=gain_omega, gain_mu=gain_mu,
        omega_limit=omega_relative_limit * omega_mid, out_cap=out_cap)
    return _gardner_unpack(v, ext[n:]), syms, valid
