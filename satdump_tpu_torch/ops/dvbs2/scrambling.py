"""DVB-S2 scramblers: physical-layer Gold-code symbol scrambler and the
BBFrame bit scrambler.

Reference behavior: codings/dvb-s2/s2_scrambling.cpp (X/Y LFSR Gold
sequence, 2-bit Rn, j^Rn symbol rotation) and bbframe_descramble.cpp:121-142
(x^15+x^14+1 PRBS, init 0x4A80, byte-wise XOR). Here both sequences are
generated once, cached, and applied as vectorized array ops.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

PL_SEQ_LEN = 131072          # covers any PLFRAME payload (max ~33k symbols)
FRAME_SIZE_NORMAL = 64800


@lru_cache(maxsize=None)
def pl_scramble_rn(codenum: int = 0) -> np.ndarray:
    """(PL_SEQ_LEN,) uint8 2-bit scrambling integers Rn (Gold code of the
    x^18 X/Y LFSRs, EN 302 307-1 §5.5.4)."""
    def lfsr_x(x):
        bit = ((x >> 7) ^ x) & 1
        return ((bit << 18) | x) >> 1

    def lfsr_y(y):
        bit = ((y >> 10) ^ (y >> 7) ^ (y >> 5) ^ y) & 1
        return ((bit << 18) | y) >> 1

    stx, sty = 0x00001, 0x3FFFF
    for _ in range(codenum):
        stx = lfsr_x(stx)
    rn = np.zeros(PL_SEQ_LEN, np.uint8)
    for i in range(PL_SEQ_LEN):
        rn[i] = (stx ^ sty) & 1
        stx, sty = lfsr_x(stx), lfsr_y(sty)
    for i in range(PL_SEQ_LEN):
        rn[i] |= ((stx ^ sty) & 1) << 1
        stx, sty = lfsr_x(stx), lfsr_y(sty)
    return rn


@lru_cache(maxsize=None)
def _pl_rot(codenum: int = 0) -> np.ndarray:
    """j^Rn rotation factors for the scramble direction."""
    return np.asarray([1, 1j, -1, -1j], np.complex64)[pl_scramble_rn(codenum)]


def pl_scramble(symbols: np.ndarray, codenum: int = 0) -> np.ndarray:
    """Scramble a PLFRAME payload (position 0 = first post-header symbol)."""
    rot = _pl_rot(codenum)[: symbols.shape[-1]]
    return symbols * rot


def pl_descramble(symbols: np.ndarray, codenum: int = 0) -> np.ndarray:
    rot = _pl_rot(codenum)[: symbols.shape[-1]]
    return symbols * np.conj(rot)


@lru_cache(maxsize=1)
def bb_scramble_bytes() -> np.ndarray:
    """(FRAME_SIZE_NORMAL/8,) uint8 BBFrame scrambler sequence."""
    out = np.zeros(FRAME_SIZE_NORMAL // 8, np.uint8)
    sr = 0x4A80
    for i in range(FRAME_SIZE_NORMAL):
        b = (sr ^ (sr >> 1)) & 1
        out[i // 8] |= b << (7 - (i % 8))
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


def bb_derandomize(frames: np.ndarray) -> np.ndarray:
    """XOR kbch/8-byte BBFrames (B, kbch/8) with the scrambler sequence
    (involution — same op scrambles on TX)."""
    frames = np.asarray(frames, np.uint8)
    return frames ^ bb_scramble_bytes()[: frames.shape[-1]]
