"""DVB-S2 soft demapping + bit (de)interleaving — port of
satdump_tpu/ops/dvbs2/demap.py.

Reference behavior: dvbs2/dvbs2_bb_to_soft.cpp (per-symbol LUT soft demap +
deinterleave) and codings/dvb-s2/s2_deinterleaver.cpp (column interleaver,
8PSK 3/5 column swap). The demap is exact max-log over all constellation
points, one (n_sym, n_states) distance matrix per frame, in torch ops on
the device of its input; the deinterleaver is a reshape/transpose that
takes a NumPy array or a tensor alike.

LLR convention: positive = bit 1 ("soft symbol" convention, like the
reference's int8 softs). Negate before feeding ops/fec/ldpc (positive=0).
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.ops.dvbs2.defs import MOD_BITS, constellation
from satdump_tpu_torch.utils.device import resolve_device, to_numpy


def _scaled_abs(d: torch.Tensor) -> torch.Tensor:
    """|d| of complex64 d as XLA's CPU code forms it: max(|re|, |im|) *
    sqrt(1 + (min / max)^2), the 1 + q^2 fused into one rounding (an FMA,
    emulated exactly in float64), 0 where d is 0. Every step is a
    correctly rounded float32 operation, so the card gives the CPU's
    bits."""
    ar, ai = d.real.abs(), d.imag.abs()
    mx, mn = torch.maximum(ar, ai), torch.minimum(ar, ai)
    q = (mn / mx).double()
    r = mx * torch.sqrt((q * q + 1).float())
    return torch.where(mx == 0, torch.zeros_like(r), r)


def _maxlog_llr(y: torch.Tensor, points: torch.Tensor, m: int,
                noise_var: float) -> torch.Tensor:
    """y (..., n) complex64, points (2^m,) -> LLRs (..., n, m) float32.
    LLR_k = (min dist over bit_k=0) - (min dist over bit_k=1): positive
    means bit 1 more likely.

    The squared distance is |y - p| ** 2 as the JAX package forms it: the
    complex magnitude (XLA's scaled form, `_scaled_abs`) then squared, not
    re² + im²."""
    r = _scaled_abs(y[..., None] - points)             # (..., n, 2^m)
    d2 = r * r
    idx = np.arange(points.shape[0])
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    llrs = []
    for k in range(m):
        bit = torch.as_tensor((idx >> (m - 1 - k)) & 1, device=d2.device)
        d0 = torch.where(bit == 0, d2, inf).amin(-1)
        d1 = torch.where(bit == 1, d2, inf).amin(-1)
        llrs.append(d0 - d1)
    den = torch.tensor(max(np.float32(noise_var), np.float32(1e-6)),
                       dtype=d2.dtype, device=d2.device)
    return torch.stack(llrs, dim=-1) / den


def soft_demap_tensor(y: torch.Tensor, kind: str, g1: float = 0.0,
                      g2: float = 0.0, noise_var: float = 0.5
                      ) -> torch.Tensor:
    """symbols (..., n) complex64 tensor -> (..., n*m) float32 soft bits on
    its device (positive = 1), bit-serial order (MSB of each symbol
    first)."""
    m = MOD_BITS[kind]
    pts = torch.from_numpy(np.asarray(constellation(kind, g1, g2),
                                      np.complex64)).to(y.device)
    llr = _maxlog_llr(y, pts, m, noise_var)
    return llr.reshape(llr.shape[:-2] + (-1,))


def soft_demap(symbols: np.ndarray, kind: str, g1: float = 0.0,
               g2: float = 0.0, noise_var: float = 0.5,
               device: str | torch.device | None = None) -> np.ndarray:
    """symbols (..., n) complex -> (..., n*m) float32 soft bits
    (positive = 1), bit-serial order (MSB of each symbol first), demapped
    on `device` (default cuda)."""
    y = torch.from_numpy(np.ascontiguousarray(symbols, np.complex64))
    out = soft_demap_tensor(y.to(resolve_device(device)), kind, g1, g2,
                            noise_var)
    return to_numpy(out).astype(np.float32)


def modulate(bits: np.ndarray, kind: str, g1: float = 0.0,
             g2: float = 0.0) -> np.ndarray:
    """TX fixture: bit-serial (..., n*m) -> symbols (..., n)."""
    m = MOD_BITS[kind]
    pts = constellation(kind, g1, g2)
    b = np.asarray(bits, np.int64).reshape(bits.shape[:-1] + (-1, m))
    idx = np.zeros(b.shape[:-1], np.int64)
    for k in range(m):
        idx = (idx << 1) | b[..., k]
    return pts[idx]


# ---------------------------------------------------------------------------
# Column (de)interleaver (EN 302 307-1 §5.3.3)
# ---------------------------------------------------------------------------
def _geometry(kind: str, n_ldpc: int, rate: str):
    m = MOD_BITS[kind]
    rows = n_ldpc // m
    # 8PSK 3/5: column read order 2,1,0 instead of 0,1,2
    if kind == "8psk" and rate == "3/5":
        order = [2, 1, 0]
    else:
        order = list(range(m))
    return m, rows, order


def interleave(bits: np.ndarray, kind: str, rate: str) -> np.ndarray:
    """Serial LDPC codeword bits (..., N) -> symbol-serial bits (..., N).
    Writes the codeword column-wise into m columns, reads row-wise."""
    m, rows, order = _geometry(kind, bits.shape[-1], rate)
    if m == 2:
        return bits  # QPSK: no interleaving
    cols = bits.reshape(bits.shape[:-1] + (m, rows))
    cols = cols[..., np.argsort(order), :]     # place column c at order[c]
    return np.swapaxes(cols, -1, -2).reshape(bits.shape)


def deinterleave(soft, kind: str, rate: str):
    """Symbol-serial soft bits (..., N) -> LDPC codeword order (..., N); a
    NumPy array or a tensor (on its device)."""
    m, rows, order = _geometry(kind, soft.shape[-1], rate)
    if m == 2:
        return soft
    rowsarr = soft.reshape(tuple(soft.shape[:-1]) + (rows, m))
    cols = rowsarr.swapaxes(-1, -2)            # (..., m, rows)
    return cols[..., order, :].reshape(soft.shape)
