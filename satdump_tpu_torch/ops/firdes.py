"""FIR filter design (taps generation), NumPy-side.

Tap design runs on host at graph-build time; only the filtering itself runs
on TPU. Formulas match the reference so filters are drop-in equivalent:
root_raised_cosine and low_pass follow src-core/common/dsp/filter/firdes.cpp
(GNU-Radio-style), windowed_sinc + nuttall follow common/dsp/window/window.cpp,
and the polyphase interpolation bank follows common/dsp/resamp/polyphase_bank.cpp.
"""

from __future__ import annotations

import numpy as np


def root_raised_cosine(gain: float, sampling_freq: float, symbol_rate: float,
                       alpha: float, ntaps: int) -> np.ndarray:
    """RRC taps (ref firdes.cpp:34-78)."""
    ntaps |= 1  # odd
    spb = sampling_freq / symbol_rate
    taps = np.zeros(ntaps, dtype=np.float64)
    scale = 0.0
    for i in range(ntaps):
        xindx = i - ntaps // 2
        x1 = np.pi * xindx / spb
        x2 = 4 * alpha * xindx / spb
        x3 = x2 * x2 - 1
        if abs(x3) >= 1e-6:
            if i != ntaps // 2:
                num = np.cos((1 + alpha) * x1) + np.sin((1 - alpha) * x1) / (4 * alpha * xindx / spb)
            else:
                num = np.cos((1 + alpha) * x1) + (1 - alpha) * np.pi / (4 * alpha)
            den = x3 * np.pi
        else:
            if alpha == 1:
                taps[i] = -1
                scale += taps[i]
                continue
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (np.sin(x2) * (1 + alpha) * np.pi
                   - np.cos(x3) * ((1 - alpha) * np.pi * spb) / (4 * alpha * xindx)
                   + np.sin(x3) * spb * spb / (4 * alpha * xindx * xindx))
            den = -32 * np.pi * alpha * alpha * xindx / spb
        taps[i] = 4 * alpha * num / den
        scale += taps[i]
    return (taps * gain / scale).astype(np.float32)


def _window_cosine(n: np.ndarray, N: float, coefs) -> np.ndarray:
    win = np.zeros_like(n, dtype=np.float64)
    sign = 1.0
    for i, c in enumerate(coefs):
        win += sign * c * np.cos(i * 2.0 * np.pi * n / N)
        sign = -sign
    return win


def nuttall_window(n: np.ndarray, N: float) -> np.ndarray:
    """Nuttall window, evaluated at (possibly fractional) positions n of N."""
    return _window_cosine(n, N, [0.355768, 0.487396, 0.144232, 0.012604])


def hamming_window(ntaps: int) -> np.ndarray:
    n = np.arange(ntaps)
    return 0.54 - 0.46 * np.cos(2 * np.pi * n / (ntaps - 1))


def windowed_sinc(count: int, omega: float, norm: float = 1.0) -> np.ndarray:
    """Nuttall-windowed sinc prototype (ref window.cpp:34-50)."""
    half = count / 2.0
    corr = norm * omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    x = t * omega
    s = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0.0, 1.0, x))
    return (s * nuttall_window(t - half, count) * corr).astype(np.float32)


def low_pass(gain: float, sampling_freq: float, cutoff_freq: float,
             transition_width: float, attenuation_db: float = 53.0) -> np.ndarray:
    """Windowed-sinc lowpass (ref firdes.cpp:80-121, Hamming window)."""
    ntaps = int(attenuation_db * sampling_freq / (22.0 * transition_width))
    if ntaps % 2 == 0:
        ntaps += 1
    w = hamming_window(ntaps)
    M = (ntaps - 1) // 2
    fwT0 = 2 * np.pi * cutoff_freq / sampling_freq
    n = np.arange(-M, M + 1, dtype=np.float64)
    taps = np.where(n == 0, fwT0 / np.pi,
                    np.sin(n * fwT0) / np.where(n == 0, 1.0, n * np.pi)) * w
    fmax = taps[M] + 2 * np.sum(taps[M + 1:])
    return (taps * gain / fmax).astype(np.float32)


def polyphase_bank(rtaps: np.ndarray, nfilt: int) -> np.ndarray:
    """Arrange prototype taps into an (nfilt, ntaps) interpolation bank.

    Matches ref polyphase_bank.cpp:6-40 including the reversed-branch layout:
    ``bank[(nfilt-1) - (i % nfilt), i // nfilt] = rtaps[i]``.
    """
    ntaps = (len(rtaps) + nfilt - 1) // nfilt
    if (len(rtaps) / nfilt) % 1.0 > 0.0:
        ntaps += 1
    bank = np.zeros((nfilt, ntaps), dtype=np.float32)
    for i in range(nfilt * ntaps):
        if i < len(rtaps):
            bank[(nfilt - 1) - (i % nfilt), i // nfilt] = rtaps[i]
    return bank


def mm_interpolator_bank(nfilt: int = 128, ntaps: int = 8) -> np.ndarray:
    """The clock-recovery interpolator bank (ref clock_recovery_mm.cpp:18):
    windowed_sinc(nfilt*ntaps, pi/nfilt, nuttall, norm=nfilt)."""
    proto = windowed_sinc(nfilt * ntaps, np.pi / nfilt, norm=float(nfilt))
    return polyphase_bank(proto, nfilt)
