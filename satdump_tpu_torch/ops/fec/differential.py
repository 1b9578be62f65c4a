"""Differential codecs (ref src-core/common/codings/differential/).

Bit-level NRZ-M and QPSK differential decode, vectorized. Streaming state is
a single carried bit/symbol.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def nrzm_encode(bits: np.ndarray, last: int = 0) -> Tuple[np.ndarray, int]:
    """NRZ-M: output toggles when input bit is 1 (out[i] = out[i-1] ^ in[i])."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.bitwise_xor.accumulate(bits) ^ last
    return out.astype(np.uint8), int(out[-1]) if len(out) else last


def nrzm_decode(bits: np.ndarray, last: int = 0) -> Tuple[np.ndarray, int]:
    """Inverse: in[i] = out[i] ^ out[i-1] (ref differential/nrzm.cpp)."""
    bits = np.asarray(bits, dtype=np.uint8)
    prev = np.concatenate([[last], bits[:-1]])
    return (bits ^ prev).astype(np.uint8), int(bits[-1]) if len(bits) else last


class QPSKDiff:
    """Differential decode of 2-bit QPSK symbols, faithful to the reference
    diff::QPSKDiff (codings/differential/qpsk_diff.cpp) including its startup
    behavior (the first two samples prime the window and emit nothing) and
    the conditional axis swap. Vectorized over the block.

    work(symbols) -> interleaved output bits, 2 per emitted symbol."""

    def __init__(self, swap: bool = True):
        self.swap = swap
        self._prev: int | None = None
        self._dropped_first = False  # the reference never uses sample 0

    def work(self, symbols: np.ndarray) -> np.ndarray:
        symbols = np.asarray(symbols, dtype=np.uint8)
        if not self._dropped_first and len(symbols):
            symbols = symbols[1:]
            self._dropped_first = True
        if len(symbols) == 0:
            return np.zeros(0, np.uint8)
        if self._prev is None:
            self._prev = int(symbols[0])
            symbols = symbols[1:]
            if len(symbols) == 0:
                return np.zeros(0, np.uint8)
        prev = np.concatenate([[self._prev], symbols[:-1]]).astype(np.uint8)
        cur = symbols
        self._prev = int(cur[-1])
        xin_1, yin_1 = prev & 2, prev & 1
        xin, yin = cur & 2, cur & 1
        cond = ((xin >> 1) ^ yin) == 1
        ou = np.where(cond,
                      ((yin_1 ^ yin) << 1) + ((xin_1 ^ xin) >> 1),
                      (xin_1 ^ xin) + (yin_1 ^ yin)).astype(np.uint8)
        out = np.empty(2 * len(ou), np.uint8)
        if self.swap:
            out[0::2] = ou & 1
            out[1::2] = ou >> 1
        else:
            out[0::2] = ou >> 1
            out[1::2] = ou & 1
        return out


def nrzi_encode(bits: np.ndarray, last: int = 0) -> Tuple[np.ndarray, int]:
    """NRZ-I: transition encodes a 0 (ref codings/differential/nrzi.h) —
    the complement convention of NRZ-M."""
    bits = np.asarray(bits, np.uint8)
    out = (np.cumsum(1 - bits) + last) & 1
    return out.astype(np.uint8), int(out[-1]) if len(out) else last


def nrzi_decode(bits: np.ndarray, last: int = 0) -> Tuple[np.ndarray, int]:
    bits = np.asarray(bits, np.uint8)
    prev = np.concatenate([[last], bits[:-1]])
    return (1 - (bits ^ prev)).astype(np.uint8), \
        int(bits[-1]) if len(bits) else last


def nrzs_encode(bits: np.ndarray, last: int = 0) -> Tuple[np.ndarray, int]:
    """NRZ-S: transition encodes a 1? No — NRZ-S holds level for a 1 and
    transitions for a 0's complement; it is NRZ-M of the inverted stream
    (ref codings/differential/ nrzs variant)."""
    return nrzm_encode(1 - np.asarray(bits, np.uint8), last)


def nrzs_decode(bits: np.ndarray, last: int = 0) -> Tuple[np.ndarray, int]:
    out, st = nrzm_decode(bits, last)
    return (1 - out).astype(np.uint8), st
