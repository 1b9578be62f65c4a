"""Constellation registry + vectorized soft demodulation.

Reference: src-core/common/dsp/demod/constellation.h/.cpp — point tables for
BPSK/QPSK/OQPSK/8PSK/16APSK/32APSK (with DVB-S2 gamma ring ratios), hard and
soft demod, and a 2-D soft LUT. Here demodulation is a batched max-log LLR
over whole sample arrays (the per-pixel LUT becomes one vectorized pass);
`make_soft_lut` still materializes the reference-style grid for parity
checks and table-driven consumers."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from satdump_tpu_torch.ops.dvbs2.defs import constellation as _s2_points


def get_points(kind: str, g1: float = 0.0, g2: float = 0.0) -> np.ndarray:
    """Constellation points indexed by symbol bits (Gray mappings as the
    DVB-S2 definitions; BPSK/QPSK match the PSK demod convention)."""
    kind = kind.lower()
    if kind == "bpsk":
        return np.array([-1.0 + 0j, 1.0 + 0j], np.complex64)
    if kind in ("qpsk", "oqpsk", "8psk", "16apsk", "32apsk"):
        return np.asarray(_s2_points(kind if kind != "oqpsk" else "qpsk",
                                     g1, g2), np.complex64)
    raise ValueError(f"unknown constellation '{kind}'")


def bits_per_symbol(kind: str) -> int:
    return {"bpsk": 1, "qpsk": 2, "oqpsk": 2, "8psk": 3,
            "16apsk": 4, "32apsk": 5}[kind.lower()]


def hard_demod(samples: np.ndarray, kind: str, g1: float = 0.0,
               g2: float = 0.0) -> np.ndarray:
    """Nearest-point symbol indices, vectorized (constellation.cpp
    soft_demod's decision half)."""
    pts = get_points(kind, g1, g2)
    d = np.abs(np.asarray(samples, np.complex64)[..., None] - pts[None])
    return np.argmin(d, axis=-1).astype(np.uint8)


def soft_demod(samples: np.ndarray, kind: str, g1: float = 0.0,
               g2: float = 0.0, noise_var: float = 0.1) -> np.ndarray:
    """Max-log LLRs per bit, (..., m) float32, positive = bit 1."""
    pts = get_points(kind, g1, g2)
    m = bits_per_symbol(kind)
    s = np.asarray(samples, np.complex64)
    d2 = np.abs(s[..., None] - pts[None]) ** 2 / max(noise_var, 1e-6)
    idx = np.arange(len(pts))
    llrs = []
    for b in range(m - 1, -1, -1):
        one = (idx >> b) & 1 == 1
        llr = np.min(d2[..., ~one], axis=-1) - np.min(d2[..., one], axis=-1)
        llrs.append(llr)
    return np.stack(llrs, axis=-1).astype(np.float32)


def phase_error(samples: np.ndarray, kind: str, g1: float = 0.0,
                g2: float = 0.0) -> np.ndarray:
    """Decision-directed phase error per sample (the LUT's phase_err
    column, constellation.cpp:300-322)."""
    pts = get_points(kind, g1, g2)
    s = np.asarray(samples, np.complex64)
    dec = pts[hard_demod(s, kind, g1, g2)]
    return np.angle(s * np.conj(dec)).astype(np.float32)


def make_soft_lut(kind: str, resolution: int = 256, g1: float = 0.0,
                  g2: float = 0.0, noise_var: float = 0.1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's 2-D LUT over [-0.75, 0.75)^2 x 1.5 grid
    (constellation.cpp make_lut): returns (bits (R, R, m) int8 clamped
    LLRs, phase_err (R, R) f32)."""
    r = np.arange(resolution)
    xv = ((r - resolution / 2) / resolution) * 1.5
    grid = (xv[:, None] + 1j * xv[None, :]).astype(np.complex64)
    llr = soft_demod(grid, kind, g1, g2, noise_var)
    bits = np.clip(llr * 16.0, -127, 127).astype(np.int8)
    return bits, phase_error(grid, kind, g1, g2)


# 16/32-APSK default ring ratios (DVB-S2 gamma for common code rates)
APSK16_GAMMA = {"2/3": 3.15, "3/4": 2.85, "4/5": 2.75, "5/6": 2.70,
                "8/9": 2.60, "9/10": 2.57}
APSK32_GAMMA = {"3/4": (2.84, 5.27), "4/5": (2.72, 4.87),
                "5/6": (2.64, 4.64), "8/9": (2.54, 4.33),
                "9/10": (2.53, 4.30)}
