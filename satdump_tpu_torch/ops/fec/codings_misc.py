"""Misc codings: Manchester, generic LFSR, generic bit deframer, HDLC.

Reference behavior: src-core/common/codings/manchester.{h,cpp} (G.E.Thomas
decoder), codings/lfsr.h (GNU-Radio-style Fibonacci LFSR),
common/simple_deframer.h (arbitrary-syncword bit deframer with hamming
threshold), codings/deframing/hdlc_def.cpp (flag-delimited bit-destuffed
AX.25 frames with CRC-CCITT FCS). All bit-level scans here are vectorized
(correlate-everywhere / run-length masks), not per-bit loops.

Counterpart of satdump_tpu/ops/fec/codings_misc.py (host NumPy, copied)."""

from __future__ import annotations

from typing import List

import numpy as np

from satdump_tpu_torch.ops.fec.crc import crc_ccitt
from satdump_tpu_torch.ops.fec.deframer import correlate_bits


# ---------------------------------------------------------------------------
# Manchester (G. E. Thomas: '10' = 1, '01' = 0)
# ---------------------------------------------------------------------------
def manchester_encode(bits: np.ndarray) -> np.ndarray:
    """bits (..., N) -> (..., 2N) half-bit chips."""
    bits = np.asarray(bits, np.uint8)
    out = np.empty(bits.shape[:-1] + (2 * bits.shape[-1],), np.uint8)
    out[..., 0::2] = bits
    out[..., 1::2] = 1 - bits
    return out


def manchester_decode(chips: np.ndarray, offset: int = 0) -> np.ndarray:
    """chips (..., 2N) -> (..., N) bits; `offset` selects the half-bit
    phase (the decoder ambiguity the reference resolves upstream)."""
    chips = np.asarray(chips, np.uint8)[..., offset:]
    n = chips.shape[-1] // 2
    return chips[..., : 2 * n: 2]


def manchester_phase(chips: np.ndarray) -> int:
    """Pick the half-bit phase: valid Manchester has every pair unequal."""
    chips = np.asarray(chips, np.uint8)
    n = (chips.shape[-1] - 1) // 2
    v0 = int((chips[0: 2 * n: 2] != chips[1: 2 * n: 2]).sum())
    v1 = int((chips[1: 2 * n + 1: 2] != chips[2: 2 * n + 1: 2]).sum())
    return 0 if v0 >= v1 else 1


# ---------------------------------------------------------------------------
# Fibonacci LFSR (GNU-Radio semantics: lfsr.h)
# ---------------------------------------------------------------------------
class LFSR:
    """mask = feedback tap polynomial, seed = initial register,
    reg_len = register length. next_bit() emits the low bit then shifts
    the xor of the masked taps into the top (lfsr.h next_bit())."""

    def __init__(self, mask: int, seed: int, reg_len: int):
        self.mask = mask
        self.seed = seed
        self.reg_len = reg_len
        self.reg = seed

    def reset(self) -> None:
        self.reg = self.seed

    def next_bit(self) -> int:
        out = self.reg & 1
        fb = bin(self.reg & self.mask).count("1") & 1
        self.reg = (self.reg >> 1) | (fb << (self.reg_len - 1))
        return out

    def sequence(self, n: int) -> np.ndarray:
        """n output bits (host precompute; sequences are periodic and get
        tiled/XORed vectorized downstream)."""
        out = np.empty(n, np.uint8)
        for i in range(n):
            out[i] = self.next_bit()
        return out


# ---------------------------------------------------------------------------
# Generic bit-level deframer (simple_deframer.h)
# ---------------------------------------------------------------------------
class SimpleDeframer:
    """Arbitrary syncword (<= 64 bits) + fixed frame length (bits),
    hamming threshold. Correlates every offset of the block at once, then
    walks candidate hits (the reference walks bit-by-bit)."""

    def __init__(self, syncword: int, syncword_length: int,
                 frame_length_bits: int, threshold: int = 0,
                 soft_bits_in: bool = False):
        self.pattern = ((syncword >> np.arange(syncword_length - 1, -1, -1))
                        & 1).astype(np.uint8)
        self.sw_len = syncword_length
        self.frame_bits = frame_length_bits
        self.threshold = threshold
        self.soft = soft_bits_in
        self._tail = np.zeros(0, np.uint8)

    def work(self, data: np.ndarray) -> List[np.ndarray]:
        """data: hard bits (or int8 softs with soft_bits_in). Returns a
        list of frame byte arrays (frame_length_bits/8 each)."""
        bits = (np.asarray(data) >= (0 if self.soft else 1)).astype(np.uint8) \
            if self.soft else np.asarray(data, np.uint8)
        stream = np.concatenate([self._tail, bits])
        if len(stream) < self.sw_len:
            self._tail = stream
            return []
        dist = correlate_bits(stream, self.pattern)
        hits = np.flatnonzero(dist <= self.threshold)
        frames = []
        pos = 0
        for h in hits:
            if h < pos:
                continue
            if h + self.frame_bits <= len(stream):
                frames.append(np.packbits(stream[h: h + self.frame_bits]))
                pos = h + self.frame_bits
            else:
                pos = h
                break
        keep = max(len(stream) - max(pos, len(stream) - self.frame_bits), 0)
        self._tail = stream[len(stream) - keep:] if keep else \
            np.zeros(0, np.uint8)
        return frames


# ---------------------------------------------------------------------------
# HDLC deframer (hdlc_def.cpp)
# ---------------------------------------------------------------------------
def _destuff(bits: np.ndarray) -> np.ndarray:
    """Remove a 0 following five consecutive 1s (vectorized run-length)."""
    b = np.asarray(bits, np.uint8)
    idx = np.arange(len(b))
    last_zero = np.where(b == 0, idx, -1)
    last_zero = np.maximum.accumulate(last_zero)
    prev_last_zero = np.concatenate([[-1], last_zero[:-1]])
    ones_before = idx - 1 - prev_last_zero
    stuffed = (b == 0) & (ones_before == 5)
    return b[~stuffed]


class HDLCDeframer:
    def __init__(self, length_min: int = 10, length_max: int = 1024):
        self.len_min = length_min
        self.len_max = length_max
        self._tail = np.zeros(0, np.uint8)

    def work(self, bits: np.ndarray) -> List[np.ndarray]:
        stream = np.concatenate([self._tail,
                                 np.asarray(bits, np.uint8)])
        flag = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)
        dist = correlate_bits(stream, flag)
        flags = np.flatnonzero(dist == 0)
        frames = []
        for a, b in zip(flags[:-1], flags[1:]):
            seg = stream[a + 8: b]
            if len(seg) < 8:
                continue
            payload_bits = _destuff(seg)
            nbytes = len(payload_bits) // 8
            if not (self.len_min <= nbytes <= self.len_max) or nbytes < 3:
                continue
            pb = payload_bits[: nbytes * 8].reshape(nbytes, 8)[:, ::-1]
            pkt = np.packbits(pb, axis=-1, bitorder="big").reshape(-1)
            # FCS: little-endian CRC-CCITT of the body (hdlc_def.cpp:45-50)
            want = (int(pkt[-1]) << 8) | int(pkt[-2])
            if crc_ccitt.compute(pkt[:-2]) == want:
                frames.append(pkt[:-2])
        self._tail = stream[flags[-1]:] if len(flags) else \
            stream[-self.len_max * 8 - 16:]
        return frames
