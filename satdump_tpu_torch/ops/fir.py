"""FIR filtering as overlap-save FFT convolution — port of
satdump_tpu/ops/fir.py (the classic demod chain's FIR, the VFO
channelizer's decimating FIR and the direct form).

Replaces the reference's VOLK dot-product FIR (common/dsp/filter/fir.h:16).
Causal semantics match the reference FIRBlock: y[n] = sum_k taps[k] x[n-k],
with ntaps - 1 samples of history carried between blocks. The FFTs are
torch.fft, as the JAX package leaves them to XLA's FFT, so the two round
differently in the last bits.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.utils.device import resolve_device


class FIRState(NamedTuple):
    history: torch.Tensor  # last (ntaps-1) input samples
    # the taps (float32, host) and their FFT at nfft, on the device: made
    # at the first block and kept while the taps and block size stay
    taps: np.ndarray | None = None
    spectrum: torch.Tensor | None = None


def fir_init(ntaps: int, dtype=torch.complex64,
             device: str | torch.device | None = None) -> FIRState:
    return FIRState(torch.zeros(ntaps - 1, dtype=dtype,
                                device=resolve_device(device)))


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fir_apply(state: FIRState, x: torch.Tensor, taps,
              fft_size: int | None = None) -> Tuple[FIRState, torch.Tensor]:
    """Causal FIR of one block via overlap-save. x: (N,) complex64 or
    float32; taps: (ntaps,) host or device float taps. Returns y with
    y[n] = sum_k taps[k] xext[n-k], xext the history then x."""
    t = np.asarray(taps.cpu() if torch.is_tensor(taps) else taps, np.float32)
    ntaps = t.shape[0]
    n = x.shape[-1]
    ext = torch.cat([state.history, x])            # N + ntaps - 1
    nfft = fft_size or max(256, _next_pow2(n + ntaps - 1))
    H = state.spectrum
    nbins = nfft if x.is_complex() else nfft // 2 + 1
    if H is None or H.shape[0] != nbins or H.device != x.device \
            or not np.array_equal(state.taps, t):
        h = torch.as_tensor(t, device=x.device)
        H = (torch.fft.fft(h.to(torch.complex64), nfft) if x.is_complex()
             else torch.fft.rfft(h, nfft))
    if x.is_complex():
        y = torch.fft.ifft(torch.fft.fft(ext, nfft) * H)
    else:
        y = torch.fft.irfft(torch.fft.rfft(ext, nfft) * H, nfft)
    return FIRState(ext[n:], t, H), y[ntaps - 1: ntaps - 1 + n].to(x.dtype)


def fir_direct(state: FIRState, x: torch.Tensor, taps
               ) -> Tuple[FIRState, torch.Tensor]:
    """Direct-form causal FIR (small ntaps): a sum over shifted slices,
    y[n] = sum_k taps[k] ext[n + ntaps-1 - k], in the taps' order."""
    t = np.asarray(taps.cpu() if torch.is_tensor(taps) else taps, np.float32)
    ntaps = t.shape[0]
    n = x.shape[-1]
    ext = torch.cat([state.history, x])
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for k in range(ntaps):
        y = y + float(t[k]) * ext[ntaps - 1 - k: ntaps - 1 - k + n]
    return FIRState(ext[n:]), y


def decimating_fir_apply(state: FIRState, x: torch.Tensor, taps, decim: int
                         ) -> Tuple[FIRState, torch.Tensor]:
    """FIR, then every decim-th output (ref filter/decimating_fir.h). The
    block length must be a multiple of decim to keep the phase aligned."""
    state, y = fir_apply(state, x, taps)
    return state, y[::decim]


def design_fft_size(block_size: int, ntaps: int) -> int:
    return _next_pow2(block_size + ntaps - 1)


def np_fir_reference(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """NumPy golden model: causal FIR with zero initial history."""
    full = np.convolve(x, taps)
    return full[: len(x)]
