"""CCSDS pseudo-noise derandomization (ref src-core/common/codings/randomization.cpp).

The PN sequence is generated from the CCSDS polynomial x^8+x^7+x^5+x^3+1
(all-ones seed) rather than copied; the first bytes are verified against the
published sequence (0xFF 0x48 0x0E 0xC0 ...) in tests.
"""

from __future__ import annotations

import numpy as np


def _gen_ccsds_pn(nbytes: int = 255) -> np.ndarray:
    """Generate the CCSDS synchronization-channel PN byte sequence."""
    reg = 0xFF
    out = np.zeros(nbytes, dtype=np.uint8)
    for i in range(nbytes * 8):
        bit = (reg >> 7) & 1
        out[i // 8] = (out[i // 8] << 1) | bit
        # x^8 + x^7 + x^5 + x^3 + 1 feedback (taps 7,4,2,0 in this orientation)
        fb = ((reg >> 7) ^ (reg >> 4) ^ (reg >> 2) ^ (reg >> 0)) & 1
        reg = ((reg << 1) | fb) & 0xFF
    return out


CCSDS_PN = _gen_ccsds_pn()
_PN_BITS = np.unpackbits(CCSDS_PN)


def derand_ccsds(data: np.ndarray) -> np.ndarray:
    """XOR frame bytes with the CCSDS PN, restarting each frame
    (ref randomization.cpp derand_ccsds: data[i] ^= pn[i % 255])."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[-1]
    reps = -(-n // 255)
    pn = np.tile(CCSDS_PN, reps)[:n]
    return data ^ pn


def derand_ccsds_soft(soft: np.ndarray) -> np.ndarray:
    """Invert int8 soft symbols where the PN bit is set (ref
    randomization.cpp derand_ccsds_soft: data[i] = ~data[i]; the 255-bit
    LFSR period makes byte-domain tiling equivalent). Involution."""
    soft = np.asarray(soft, np.int8)
    n = soft.shape[-1]
    reps = -(-n // len(_PN_BITS))
    pn = np.tile(_PN_BITS, reps)[:n]
    return np.where(pn == 1, np.invert(soft), soft)


def derand_ccsds_soft_bits(bits: np.ndarray) -> np.ndarray:
    """Bit-level variant for pre-packing streams (ref ccsds_soft_pn)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    reps = -(-n // (255 * 8))
    pn = np.tile(_PN_BITS, reps)[:n]
    return bits ^ pn
