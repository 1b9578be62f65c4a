"""Headless bit-stream analyzer ("BitView").

The reference ships a BitView app for eyeballing unknown bit streams:
render the stream as a raster at an adjustable bit period plus a toolbox
of transforms (ref plugins/bitview_app/{bitview.h,bit_container.h,
tools/**}: soft2hard, diff decode, reverse bits, deinterleave,
take/skip, deframer, CCSDS VCID splitter/APID demux). This is the
GUI-free equivalent: the same transforms as NumPy passes, a raster
renderer, and — new territory the GUI leaves to the user's eye — an
automatic bit-period estimator (periodic frame structure shows up as
peaks in the bit-stream autocorrelation; the estimator returns the lag
with the strongest fold alignment).

    from satdump_tpu_torch.utils import bitview
    bits = bitview.load_bits("capture.bin", soft=True)
    period = bitview.estimate_period(bits)
    img = bitview.render_raster(bits, period)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger


# ------------------------------------------------------------- transforms
def load_bits(path: str, soft: bool = False) -> np.ndarray:
    """File -> 0/1 bit array. soft=True treats bytes as signed soft
    symbols (>0 = 1, ref tools/soft2hard); else bytes unpack MSB-first."""
    raw = np.fromfile(path, np.uint8)
    if soft:
        return (raw.view(np.int8) > 0).astype(np.uint8)
    return np.unpackbits(raw)


def soft_to_hard(soft: np.ndarray) -> np.ndarray:
    return (np.asarray(soft).view(np.int8) > 0).astype(np.uint8)


def diff_decode(bits: np.ndarray) -> np.ndarray:
    """NRZ-M style differential decode (ref tools/diff_decode)."""
    b = np.asarray(bits, np.uint8)
    prev = np.concatenate([[0], b[:-1]])
    return (b ^ prev).astype(np.uint8)


def reverse_bits(bits: np.ndarray) -> np.ndarray:
    """Reverse bit order within each byte (ref tools/reverse_bits)."""
    b = np.asarray(bits, np.uint8)
    n = len(b) // 8 * 8
    return b[:n].reshape(-1, 8)[:, ::-1].reshape(-1)


def deinterleave(bits: np.ndarray, n: int) -> np.ndarray:
    """Undo an n-way bit interleave (ref tools/deinterleave)."""
    b = np.asarray(bits, np.uint8)
    m = len(b) // n * n
    return b[:m].reshape(-1, n).T.reshape(-1)


def take_skip(bits: np.ndarray, take: int, skip: int,
              offset: int = 0) -> np.ndarray:
    """Keep `take` bits then drop `skip`, repeating (ref tools/take_skip)."""
    b = np.asarray(bits, np.uint8)[offset:]
    period = take + skip
    m = len(b) // period * period
    return b[:m].reshape(-1, period)[:, :take].reshape(-1)


# ---------------------------------------------------------------- analysis
def estimate_period(bits: np.ndarray, min_period: int = 64,
                    max_period: int = 1 << 16,
                    candidates: int = 5) -> List[int]:
    """Estimate the frame bit-period of an unknown stream.

    FFT autocorrelation of the ±1 stream; periodic structure (syncwords,
    headers) produces peaks at multiples of the frame length. Returns the
    top candidate lags, best first, fundamental preferred over harmonics."""
    b = np.asarray(bits, np.float32) * 2.0 - 1.0
    n = min(len(b), 1 << 22)
    b = b[:n] - b[:n].mean()
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    X = np.fft.rfft(b, nfft)
    ac = np.fft.irfft(X * np.conj(X))[: n // 2]
    ac[: min_period] = 0
    hi = min(max_period, len(ac))
    ac = ac[:hi]
    order = np.argsort(ac)[::-1]
    picks: List[int] = []
    for lag in order:
        lag = int(lag)
        if ac[lag] <= 0:
            break
        # a harmonic k·L can out-peak the fundamental L on noisy
        # payloads: fold each candidate down to its strongest divisor
        for k in range(8, 1, -1):
            d = int(round(lag / k))
            if d >= min_period and abs(d * k - lag) <= 2 \
                    and ac[d] >= 0.5 * ac[lag]:
                lag = d
                break
        if any(abs(lag - p) <= 2 for p in picks) or \
                any(abs(lag - round(lag / p) * p) <= 2 and lag >= 2 * p - 2
                    for p in picks):
            continue
        picks.append(lag)
        if len(picks) >= candidates:
            break
    return picks


def render_raster(bits: np.ndarray, period: int,
                  max_rows: int = 4096) -> np.ndarray:
    """Bits -> uint8 raster image, one row per period (the BitView
    display, bit_container_render.cpp)."""
    b = np.asarray(bits, np.uint8)
    rows = min(len(b) // period, max_rows)
    return (b[: rows * period].reshape(rows, period) * 255).astype(np.uint8)


def vcid_split(cadus: np.ndarray, cadu_size: int = 1024
               ) -> Dict[int, np.ndarray]:
    """CCSDS CADU stream -> per-VCID frame stacks
    (ref tools/ccsds_vcid_splitter)."""
    data = np.asarray(cadus, np.uint8)
    n = len(data) // cadu_size
    frames = data[: n * cadu_size].reshape(n, cadu_size)
    # VCDU primary header follows the 4-byte ASM: version(2) scid(8) vcid(6)
    vcids = frames[:, 5].astype(int) & 0x3F
    out: Dict[int, np.ndarray] = {}
    for v in np.unique(vcids):
        out[int(v)] = frames[vcids == v]
    return out


def apid_demux(space_packets: List[bytes]) -> Dict[int, List[bytes]]:
    """CCSDS space packets -> per-APID lists (ref tools/ccsds_apid_demux)."""
    out: Dict[int, List[bytes]] = {}
    for p in space_packets:
        if len(p) < 6:
            continue
        apid = ((p[0] << 8) | p[1]) & 0x7FF
        out.setdefault(apid, []).append(p)
    return out


def run_bitview(path: str, out_png: str, period: Optional[int] = None,
                soft: bool = False, diff: bool = False,
                reverse: bool = False) -> dict:
    """CLI entry: load, transform, (auto-)fold, render. Returns info."""
    from satdump_tpu_torch.image.io import save_img
    bits = load_bits(path, soft=soft)
    if diff:
        bits = diff_decode(bits)
    if reverse:
        bits = reverse_bits(bits)
    cands = estimate_period(bits) if period is None else [period]
    use = cands[0] if cands else 2048
    img = render_raster(bits, use)
    save_img(img, out_png)
    info = {"bits": int(len(bits)), "period": int(use),
            "candidates": [int(c) for c in cands],
            "rows": int(img.shape[0]), "output": out_png}
    logger.info(f"bitview: {info}")
    return info
