"""Rational polyphase resampler — port of satdump_tpu/ops/resamp.py.

The reference SmartResamplerBlock (common/dsp/resamp/smart_resampler.h:11,
rational_resampler.h) runs a per-sample polyphase loop. Here every output
position of a block is computed at once (integer source index + branch
phase) and each output is a gather + ntaps-term dot, in plain torch on the
device of the input. The position numerator is carried mod L, so blocks
join without drift.

Positions are int64, where the reference forms them in int32: outputs are
identical wherever the reference's `pos_num + m*decim` stays below 2^31,
and right where it wraps (ROADMAP.md §3: NOAA APT resamples a whole
recording in one call and wraps after 206 s of 50 kHz audio).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.firdes import windowed_sinc
from satdump_tpu_torch.utils.device import resolve_device

F32 = torch.float32


def design_resampler_taps(interp: int, decim: int,
                          ntaps_per_phase: int = 8) -> np.ndarray:
    """Prototype lowpass for L/M resampling, cutoff at 0.5/max(L,M) of the
    upsampled rate, gain L (ref rational_resampler.h uses an equivalent
    windowed design)."""
    count = interp * ntaps_per_phase
    omega = math.pi / max(interp, decim)
    return windowed_sinc(count, omega, norm=float(interp))


class RationalResamplerState(NamedTuple):
    history: torch.Tensor   # (ntaps-1,) complex64 input history
    pos_num: torch.Tensor   # int64: next output position numerator (1/L)


def rational_resampler_init(interp: int, ntaps_per_phase: int = 8,
                            dtype=torch.complex64,
                            device: str | torch.device | None = None
                            ) -> RationalResamplerState:
    dev = resolve_device(device)
    return RationalResamplerState(
        history=torch.zeros((ntaps_per_phase - 1,), dtype=dtype, device=dev),
        pos_num=torch.zeros((), dtype=torch.int64, device=dev))


def rational_resampler(state: RationalResamplerState, x: torch.Tensor,
                       bank, interp: int, decim: int,
                       out_cap: int | None = None
                       ) -> Tuple[RationalResamplerState, torch.Tensor,
                                  torch.Tensor]:
    """Resample a block by interp/decim on x's device.

    bank: (interp, ntaps) polyphase bank from `polyphase_bank(proto,
    interp)`, host numpy or a float32 tensor. Returns (state', y[out_cap],
    valid[out_cap]).

    Output m sits at input position (pos_num + m*decim)/interp; the integer
    part indexes the input (with ntaps-1 history prepended), the remainder
    selects the polyphase branch. The ntaps products are summed in tap
    order.
    """
    dev = x.device
    bank_t = torch.as_tensor(bank, dtype=F32, device=dev)
    L, ntaps = bank_t.shape
    if L != interp:
        raise ValueError(f"rational_resampler: bank has {L} branches, "
                         f"interp is {interp}")
    n = x.shape[-1]
    if out_cap is None:
        out_cap = int(np.ceil(n * interp / decim)) + 1

    ext = torch.cat([state.history, x])                   # n + ntaps - 1
    m = torch.arange(out_cap, dtype=torch.int64, device=dev)
    pos = state.pos_num + m * decim         # in units of 1/L input samples
    src = torch.div(pos, L, rounding_mode="floor")        # input index
    phase = pos - src * L                                 # polyphase branch
    valid = src < n

    # window rows ext[src + k], k < ntaps (the history supplies the causal
    # taps); the reference clips the index into ext, as JAX clamps gathers.
    # The sum runs in tap order as XLA's fused reduction does on the CPU:
    # each real product rounded, then added; each imaginary product fused
    # into its add (one rounding, formed here in float64, whose 48-bit
    # product is exact)
    bank_k = bank_t.t().contiguous()                      # (ntaps, L)
    yr = torch.zeros(out_cap, dtype=F32, device=dev)
    yi = torch.zeros(out_cap, dtype=F32, device=dev)
    for k in range(ntaps):
        w = ext[(src + k).clamp(0, n + ntaps - 2)]
        t = bank_k[k][phase]
        yr = yr + w.real * t
        yi = (yi.double() + w.imag.double() * t.double()).to(F32)
    y = torch.complex(yr, yi)
    y = torch.where(valid, y, torch.zeros_like(y))

    n_out = valid.sum()
    new_pos = state.pos_num + n_out * decim - n * L
    return (RationalResamplerState(history=ext[n:], pos_num=new_pos),
            y.to(x.dtype), valid)


def make_rational(pair_srate_in: float, srate_out: float) -> Tuple[int, int]:
    """Reduce srate_out/srate_in to an integer interp/decim pair."""
    frac = (srate_out, pair_srate_in)
    # use exact integers when both rates are integral, else a fine grid
    if float(frac[0]).is_integer() and float(frac[1]).is_integer():
        a, b = int(frac[0]), int(frac[1])
    else:
        a, b = int(round(frac[0] * 1000)), int(round(frac[1] * 1000))
    g = math.gcd(a, b)
    return a // g, b // g
