"""TX modulators (test fixtures + the minimal TX path the reference has).

Reference: src-core/common/dsp/hier/gfsk_mod.cpp — gaussian-shaped NRZ at
2 samples/symbol into a VCO — and the QPSK shaping in sim.py. The VCO's
per-sample phase accumulation is a cumsum here (exact, parallel)."""

from __future__ import annotations

import numpy as np


def gaussian_taps(samples_per_symbol: float, bt: float, ntaps: int
                  ) -> np.ndarray:
    """Gaussian pulse taps (ref common/dsp/filter/firdes gaussian): BT
    product `bt`, unit gain."""
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / samples_per_symbol
    alpha = np.sqrt(np.log(2.0) / 2.0) / bt
    h = np.exp(-0.5 * (np.pi * t / alpha) ** 2)
    return (h / h.sum()).astype(np.float32)


def gfsk_modulate(bits: np.ndarray, sensitivity: float = np.pi / 2,
                  bt: float = 0.5, ntaps: int = 31) -> np.ndarray:
    """bits -> complex64 GFSK baseband at 2 samples/symbol (gfsk_mod.cpp:
    rational-resample x2 through gaussian*[1,1] shaping, then VCO)."""
    nrz = 2.0 * np.asarray(bits, np.float32) - 1.0
    up = np.zeros(2 * len(nrz), np.float32)
    up[0::2] = nrz
    up[1::2] = nrz
    g = np.convolve(gaussian_taps(2.0, bt, ntaps), [0.5, 0.5])
    freq = np.convolve(up, g, "same")
    phase = np.cumsum(sensitivity * freq)
    return np.exp(1j * phase).astype(np.complex64)


def fsk_modulate(bits: np.ndarray, sps: float,
                 deviation_cycles: float = 0.1) -> np.ndarray:
    """Hard 2FSK at integer sps (test fixture for fsk_demod)."""
    sym = 2.0 * np.asarray(bits, np.float32) - 1.0
    freq = np.repeat(sym, int(sps)) * deviation_cycles
    return np.exp(2j * np.pi * np.cumsum(freq)).astype(np.complex64)
