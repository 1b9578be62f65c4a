"""Per-block DSP stages, ``(state, x) -> (state, y)`` — port of the parts of
satdump_tpu/ops/stages.py that the resampled, FM and classic paths run.

Each stage mirrors a reference dsp:: block (cited per function) and runs in
plain torch on the device of its input, its state kept there too. The
linear recurrences (DC blocker, the feedforward AGC's gain smoothing) run as
blocked products (`linear_recurrence`) where the JAX package uses
`associative_scan` or `lax.scan`, so they sum in another order. The
per-sample AGC (`agc_scan`) is nonlinear: it runs on the sample walker
(ops/cuda/sample_walk.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda import sample_walk
from satdump_tpu_torch.utils.device import full_precision_matmul, resolve_device

F32 = torch.float32
C64 = torch.complex64
TWO_PI = 2 * np.pi


def _mod(a: torch.Tensor, period: float) -> torch.Tensor:
    """jnp.mod for a positive float period: the exact remainder (fmod),
    moved into [0, period) where it is negative."""
    p = torch.tensor(period, dtype=a.dtype, device=a.device)
    r = torch.fmod(a, p)
    return torch.where(r < 0, r + p, r)


def linear_recurrence(b: torch.Tensor, beta: float, chunk: int = 256
                      ) -> torch.Tensor:
    """acc[i] = beta * acc[i-1] + b[i] along a 1-D float32 or complex64
    tensor, with acc[-1] = 0 (fold an initial value into b[0]).

    Blocked: within a chunk of C samples, one product with the C x C
    lower-triangular matrix of beta^(i-j); across chunks, the same
    recurrence over the chunk ends (with beta^C), then each chunk adds
    beta^(i+1) times the previous chunk's end. Exact in its carries at any
    length; float32 products at full precision (no TF32)."""
    if b.is_complex():
        return torch.view_as_complex(
            _recurrence_cols(torch.view_as_real(b), beta, chunk).contiguous())
    return _recurrence_cols(b[:, None], beta, chunk)[:, 0]


def _tri_powers(n: int, beta: float, device) -> torch.Tensor:
    """(n, n) matrix of beta^(i-j) for j <= i, else 0."""
    i = np.arange(n)
    e = i[:, None] - i[None, :]
    m = np.where(e >= 0, np.power(beta, np.maximum(e, 0), dtype=np.float64),
                 0.0)
    return torch.as_tensor(m.astype(np.float32), device=device)


def _recurrence_cols(b: torch.Tensor, beta: float, C: int) -> torch.Tensor:
    """linear_recurrence over the rows of b (n, k), each column apart."""
    n, k = b.shape
    if n <= C:
        with full_precision_matmul():
            return _tri_powers(n, beta, b.device) @ b
    m = -(-n // C)
    bp = torch.cat([b, b.new_zeros(m * C - n, k)])
    cols = bp.reshape(m, C, k).permute(1, 0, 2).reshape(C, m * k)
    with full_precision_matmul():
        local = (_tri_powers(C, beta, b.device) @ cols).reshape(C, m, k)
    ends = _recurrence_cols(local[-1], beta ** C, C)           # (m, k)
    prev = torch.cat([ends.new_zeros(1, k), ends[:-1]])        # (m, k)
    powers = torch.as_tensor(
        np.power(beta, np.arange(1, C + 1), dtype=np.float64).astype(
            np.float32), device=b.device)
    acc = local + powers[:, None, None] * prev[None]
    return acc.permute(1, 0, 2).reshape(m * C, k)[:n]


# ---------------------------------------------------------------------------
# Frequency shift (complex NCO)  — ref common/dsp/utils/freq_shift.cpp
# ---------------------------------------------------------------------------
class FreqShiftState(NamedTuple):
    phase: torch.Tensor  # scalar float32, radians


def freq_shift_init(device: str | torch.device | None = None
                    ) -> FreqShiftState:
    return FreqShiftState(torch.zeros((), dtype=F32,
                                      device=resolve_device(device)))


def _rotate(x: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """x * exp(j ph) for complex64 x and float32 ph. The rotation and the
    product are formed in float64 and rounded once, so that the card and
    the CPU give the same samples (their float32 sin/cos and complex
    products round differently)."""
    p = ph.double()
    c, s = torch.cos(p), torch.sin(p)
    xr, xi = x.real.double(), x.imag.double()
    return torch.complex((xr * c - xi * s).to(F32), (xr * s + xi * c).to(F32))


def abs64(x: torch.Tensor) -> torch.Tensor:
    """|x| of complex64 x, formed in float64 and rounded once to float32
    (the same on the card and the CPU)."""
    xr, xi = x.real.double(), x.imag.double()
    return torch.sqrt(xr * xr + xi * xi).to(F32)


def freq_shift(state: FreqShiftState, x: torch.Tensor, phase_delta: float
               ) -> Tuple[FreqShiftState, torch.Tensor]:
    """Mix with exp(j(phase0 + n*delta)), delta in rad/sample; n and the
    phase in float32, as the reference forms them."""
    n = x.shape[-1]
    k = torch.arange(n, dtype=F32, device=x.device)
    y = _rotate(x, state.phase + k * phase_delta)
    new_phase = _mod(state.phase + n * phase_delta, TWO_PI)
    return FreqShiftState(new_phase), y


# ---------------------------------------------------------------------------
# DC blocker — ref common/dsp/utils/correct_iq.cpp (single-pole moving avg)
# ---------------------------------------------------------------------------
class DCBlockState(NamedTuple):
    acc: torch.Tensor  # complex64 accumulator


def dc_block_init(dtype=C64, device: str | torch.device | None = None
                  ) -> DCBlockState:
    return DCBlockState(torch.zeros((), dtype=dtype,
                                    device=resolve_device(device)))


def dc_block(state: DCBlockState, x: torch.Tensor, alpha: float = 0.0001
             ) -> Tuple[DCBlockState, torch.Tensor]:
    """y[n] = x[n] - acc[n],  acc[n] = (1-alpha)*acc[n-1] + alpha*x[n]: a
    linear recurrence, evaluated with `linear_recurrence`."""
    beta = 1.0 - alpha
    b = alpha * x
    b = torch.cat([(b[:1] + beta * state.acc), b[1:]])
    acc = linear_recurrence(b, beta)
    return DCBlockState(acc[-1]), x - acc


# ---------------------------------------------------------------------------
# AGC — ref common/dsp/utils/agc.cpp, feedforward form
# ---------------------------------------------------------------------------
class AGCState(NamedTuple):
    gain: torch.Tensor  # scalar float32


def agc_init(gain: float = 1.0, device: str | torch.device | None = None
             ) -> AGCState:
    return AGCState(torch.tensor(gain, dtype=F32,
                                 device=resolve_device(device)))


def agc_scan(state: AGCState, x: torch.Tensor, rate: float = 1e-2,
             reference: float = 1.0, max_gain: float = 65536.0
             ) -> Tuple[AGCState, torch.Tensor]:
    """Per-sample AGC (ref agc.cpp:17-44): out = x*g; g += rate*(reference
    - |out|); g = min(g, max_gain) (no ceiling when max_gain <= 0). A
    nonlinear recurrence: one walk of the sample walker
    (ops/cuda/sample_walk.py)."""
    y, g = sample_walk.agc_walk(x, state.gain.reshape(1).to(F32), rate,
                                reference, max_gain)
    return AGCState(g[0]), y


def agc_block(state: AGCState, x: torch.Tensor, rate: float = 1e-2,
              reference: float = 1.0, max_gain: float = 65536.0,
              sub: int = 4096) -> Tuple[AGCState, torch.Tensor]:
    """Feedforward AGC: one gain per sub-block of `sub` samples, an EMA
    (per-sub-block weight min(1, rate*sub)) of reference / mean|x|, seeded
    with the carried gain; a tail shorter than `sub` takes the last gain."""
    n = x.shape[-1]
    nsub = n // sub
    xs = x[: nsub * sub].reshape(nsub, sub)
    mag = abs64(xs).double().mean(dim=-1).to(F32)                 # (nsub,)
    target = torch.tensor(reference, dtype=F32, device=x.device) \
        / mag.clamp_min(1e-12)
    if max_gain > 0:
        target = target.clamp_max(max_gain)
    alpha = float(np.float32(min(1.0, rate * sub)))
    beta = float(np.float32(1.0) - np.float32(alpha))
    b = alpha * target
    b = torch.cat([b[:1] + beta * state.gain, b[1:]])
    gains = linear_recurrence(b, beta)
    gain_last = gains[-1] if nsub else state.gain
    y = (xs * gains[:, None]).reshape(-1)
    if nsub * sub < n:
        y = torch.cat([y, x[nsub * sub:] * gain_last])
    return AGCState(gain_last), y


# ---------------------------------------------------------------------------
# Quadrature (FM) demod — ref common/dsp/demod/quadrature_demod.cpp
# ---------------------------------------------------------------------------
class QuadDemodState(NamedTuple):
    last: torch.Tensor  # complex64, previous sample


def quadrature_demod_init(device: str | torch.device | None = None
                          ) -> QuadDemodState:
    return QuadDemodState(torch.ones((), dtype=C64,
                                     device=resolve_device(device)))


def quadrature_demod(state: QuadDemodState, x: torch.Tensor, gain: float
                     ) -> Tuple[QuadDemodState, torch.Tensor]:
    """y[n] = gain * arg(x[n] * conj(x[n-1])), the wrapped phase
    difference of the reference's loop (quadrature_demod.cpp:37-50);
    `gain` is the final multiplier. The product and its angle are formed in
    float64 and rounded once, the same on the card and the CPU."""
    prev = torch.cat([state.last[None], x[:-1]])
    xr, xi = x.real.double(), x.imag.double()
    pr, pi = prev.real.double(), prev.imag.double()
    ang = torch.atan2(xi * pr - xr * pi, xr * pr + xi * pi).to(F32)
    return QuadDemodState(x[-1]), gain * ang


# ---------------------------------------------------------------------------
# OQPSK delay-one-imag — ref common/dsp/demod/delay_one_imag.h
# ---------------------------------------------------------------------------
class DelayImagState(NamedTuple):
    last_imag: torch.Tensor  # float32


def delay_one_imag_init(device: str | torch.device | None = None
                        ) -> DelayImagState:
    return DelayImagState(torch.zeros((), dtype=F32,
                                      device=resolve_device(device)))


def delay_one_imag(state: DelayImagState, x: torch.Tensor
                   ) -> Tuple[DelayImagState, torch.Tensor]:
    """The imaginary rail one sample late: y[n] = re x[n] + j im x[n-1]."""
    im_prev = torch.cat([state.last_imag[None], x.imag[:-1]])
    return DelayImagState(x.imag[-1]), torch.complex(x.real, im_prev)


# ---------------------------------------------------------------------------
# M2M4 SNR estimator — ref common/dsp/utils/snr_estimator.cpp
# ---------------------------------------------------------------------------
def snr_m2m4(x: torch.Tensor) -> torch.Tensor:
    """Block moment-based SNR estimate in dB (non-data-aided, M2M4)."""
    p = x.abs() ** 2
    m2 = p.mean()
    m4 = (p ** 2).mean()
    es = torch.sqrt(torch.clamp_min(2 * m2 * m2 - m4, 0.0))
    noise = torch.clamp_min(m2 - es, 1e-20)
    return 10.0 * torch.log10(torch.clamp_min(es / noise, 1e-20))


# ---------------------------------------------------------------------------
# Soft symbol quantization — ref module_psk_demod.cpp:196-213 + clamp
# ---------------------------------------------------------------------------
def to_soft_int8(sym: torch.Tensor, scale: float) -> torch.Tensor:
    """float -> int8 soft bits with the reference's clamp semantics
    (module_demod_base.h clamp(): clip to +-127, then truncate)."""
    return (sym * scale).clamp(-127.0, 127.0).to(torch.int8)


def qpsk_soft_interleave(sym: torch.Tensor, scale: float = 100.0
                         ) -> torch.Tensor:
    """Complex symbols -> interleaved int8 [re,im,re,im,...] (x100 clamp)."""
    out = torch.stack([sym.real, sym.imag], dim=-1).reshape(-1)
    return to_soft_int8(out, scale)


def bpsk_soft(sym: torch.Tensor, scale: float = 50.0) -> torch.Tensor:
    """BPSK uses only the real branch, x50 (module_psk_demod.cpp:198-202)."""
    return to_soft_int8(sym.real if sym.is_complex() else sym, scale)


# ---------------------------------------------------------------------------
# Averaged spectrum — ref common/dsp/fft/fft_pan.{h,cpp}
# ---------------------------------------------------------------------------
class FFTPanState(NamedTuple):
    avg: torch.Tensor   # (nbins,) running average magnitude (linear)


def fft_pan_init(nbins: int = 512,
                 device: str | torch.device | None = None) -> FFTPanState:
    return FFTPanState(avg=torch.zeros(nbins, dtype=F32,
                                       device=resolve_device(device)))


def fft_pan(state: FFTPanState, x: torch.Tensor, rate: float = 0.1
            ) -> Tuple[FFTPanState, torch.Tensor]:
    """Streaming averaged spectrum for displays and status: segment the
    block into nbins-point FFTs, average the shifted magnitudes, and fold
    them into an exponential running average, on the state's device.
    Returns (state', spectrum_dB (nbins,)). A block shorter than nbins
    averages no segments (NaN), as the JAX stage does."""
    nbins = state.avg.shape[0]
    x = x.to(state.avg.device)
    nseg = x.shape[-1] // nbins
    segs = x[: nseg * nbins].reshape(nseg, nbins)
    if nseg:
        mag = torch.fft.fftshift(torch.fft.fft(segs, dim=-1), dim=-1).abs()
    else:                   # torch.fft refuses an empty batch
        mag = torch.empty((0, nbins), dtype=F32, device=x.device)
    m = mag.mean(dim=0) / nbins
    avg = state.avg * (1.0 - rate) + m * rate
    db = 20.0 * torch.log10(torch.clamp_min(avg, 1e-12))
    return FFTPanState(avg=avg), db


# ---------------------------------------------------------------------------
# Doppler pre-correction — ref common/dsp/utils/doppler_correct.h
# ---------------------------------------------------------------------------
def doppler_correct(state: FreqShiftState, x: torch.Tensor, doppler_hz,
                    samplerate: float) -> Tuple[FreqShiftState, torch.Tensor]:
    """Mix the block by the negated predicted Doppler: `doppler_hz` is a
    host scalar (constant over the block) or array (one value a sample);
    the NCO phase (a float32 cumulative sum) carries across blocks."""
    n = x.shape[-1]
    d = torch.as_tensor(np.asarray(doppler_hz, np.float32), device=x.device)
    if d.ndim == 0:
        d = d.expand(n)
    phase_inc = (-2.0 * math.pi) * d / torch.tensor(
        samplerate, dtype=F32, device=x.device)
    phase = state.phase + torch.cumsum(phase_inc, 0)
    y = _rotate(x, phase)
    return FreqShiftState(_mod(phase[-1], TWO_PI)), y
