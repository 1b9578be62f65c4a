"""Generic soft-symbol frame correlator with rotated syncword replicas.

Reference behavior: src-core/common/codings/generic_correlator.{h,cpp} —
modulate the syncword bits to +/-1 softs, build one replica per
constellation ambiguity (BPSK: 0/180; QPSK: 0/90/180/270; OQPSK: 4 variants
incl. a Q-delay alternative), then at RX find (position, replica) maximizing
the dot product of the replica against the soft stream, and map the winning
replica to a (phase, iq_swap) correction.

Counterpart of satdump_tpu/ops/fec/correlator.py: the replicas are built on
the host in NumPy, and every offset of every replica is correlated in one
batched FFT cross-correlation (torch.fft) on the correlator's device.
torch.fft and the JAX package's FFT differ in the last bits, so the
correlation values agree within rounding and the positions, phases and swaps
are the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.fec.rotation import (PHASE_0, PHASE_90, PHASE_180,
                                                PHASE_270)
from satdump_tpu_torch.utils.device import resolve_device


def _modulate(bits: np.ndarray) -> np.ndarray:
    """bit -> +/-1 float soft (ref modulate_soft)."""
    return np.where(np.asarray(bits) > 0, 1.0, -1.0).astype(np.float32)


def _rotate_pairs(buf: np.ndarray, deg: float) -> np.ndarray:
    """Rotate interleaved (I,Q) float pairs by deg (ref rotate_float_buf)."""
    c = buf[0::2] + 1j * buf[1::2]
    c = c * np.exp(1j * np.radians(deg))
    out = np.empty_like(buf)
    out[0::2] = c.real
    out[1::2] = c.imag
    return out.astype(np.float32)


def build_replicas(syncword_bits: np.ndarray, modulation: str) -> np.ndarray:
    """(R, L) float32 replicas per the reference's constructor."""
    bits = np.asarray(syncword_bits, np.uint8)
    base = _modulate(bits)
    L = len(base)
    if modulation == "bpsk":
        return np.stack([base, -base])
    if modulation == "qpsk":
        return np.stack([_rotate_pairs(base, d) for d in (0, 90, 180, 270)])
    if modulation == "oqpsk":
        # alternative replica with the Q bits delayed by one symbol
        alt_bits = bits.copy()
        last_q = 0
        for i in range(L // 2):
            alt_bits[i * 2 + 1], last_q = last_q, alt_bits[i * 2 + 1]
        alt = _modulate(alt_bits)
        return np.stack([
            _rotate_pairs(base, 90),
            _rotate_pairs(base, 270),
            alt,
            _rotate_pairs(alt, 180),
        ])
    raise ValueError(f"unsupported correlator modulation '{modulation}'")


# replica index -> (phase, iq_swap), per generic_correlator.cpp:233-261
_PHASE_MAP = {
    "bpsk": [(PHASE_0, False), (PHASE_180, False)],
    "qpsk": [(PHASE_0, False), (PHASE_90, False),
             (PHASE_180, False), (PHASE_270, False)],
    "oqpsk": [(PHASE_90, False), (PHASE_270, False),
              (PHASE_0, True), (PHASE_180, True)],
}


def corr_all(x: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """Cross-correlation of every replica against x at every offset.
    x: (N,) f32. reps: (R, L) f32, on x's device. Returns (R, N-L+1)."""
    N = x.shape[0]
    L = reps.shape[1]
    nfft = 1 << int(np.ceil(np.log2(N + L)))
    X = torch.fft.rfft(x, nfft)
    Rf = torch.fft.rfft(reps, nfft, dim=-1)
    full = torch.fft.irfft(X[None] * torch.conj(Rf), nfft, dim=-1)
    return full[:, : N - L + 1]


class CorrelatorGeneric:
    """Find the best syncword position + constellation ambiguity in a block
    of signed int8 soft symbols, correlating on `device` (default cuda)."""

    def __init__(self, modulation: str, syncword_bits: np.ndarray,
                 device: str | torch.device | None = None):
        self.modulation = modulation
        self.replicas = build_replicas(syncword_bits, modulation)
        self.syncword_length = self.replicas.shape[1]
        self.device = resolve_device(device)
        self._reps_dev = torch.from_numpy(self.replicas).to(self.device)

    def correlate(self, soft: np.ndarray) -> Tuple[int, int, bool, float]:
        """soft: (N,) int8. Returns (position, phase, iq_swap, corr) where
        corr is normalized to [0, 1] (1 = perfect replica match)."""
        x = torch.from_numpy(np.asarray(soft, np.float32) / 63.5)
        c = corr_all(x.to(self.device), self._reps_dev)
        flat = int(torch.argmax(c))
        M = int(np.asarray(soft).size - self.syncword_length + 1)
        best_r, pos = divmod(flat, M)
        cor = float(c.reshape(-1)[flat])
        phase, swap = _PHASE_MAP[self.modulation][best_r]
        # normalize: max possible = L * (127/63.5) * 1.0
        cor_norm = cor / (self.syncword_length * 2.0)
        return pos, phase, swap, cor_norm

    def corr_at(self, soft: np.ndarray, pos: int, phase: int,
                swap: bool) -> float:
        """The normalized correlation of the replica of (phase, swap) with
        soft[pos: pos + L], on the host."""
        r = _PHASE_MAP[self.modulation].index((phase, swap))
        L = self.syncword_length
        x = np.asarray(soft[pos: pos + L], np.float32) / 63.5
        return float(np.dot(x, self.replicas[r])) / (L * 2.0)

    def earliest(self, soft: np.ndarray, pos: int, period: int, phase: int,
                 swap: bool, threshold: float) -> int:
        """The first of pos, pos - period, pos - 2 period, ... (within
        soft) from which every syncword up to pos correlates at
        `threshold` or more: the start of the run of frames that ends at
        the best match. (The correlator reports only the best position of
        a block; the frames ahead of it are decoded from here.)"""
        while pos >= period and self.corr_at(soft, pos - period, phase,
                                             swap) >= threshold:
            pos -= period
        return pos
