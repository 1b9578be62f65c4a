"""Soft-symbol phase rotation / IQ swap (ref src-core/common/codings/rotation.cpp).

Operates on interleaved signed int8 soft symbols [I,Q,I,Q,...]. Vectorized
NumPy (host side — these run on small soft buffers during lock search).
"""

from __future__ import annotations

import numpy as np

PHASE_0, PHASE_90, PHASE_180, PHASE_270 = 0, 1, 2, 3


def rotate_soft(soft: np.ndarray, phase: int, iq_swap: bool = False) -> np.ndarray:
    """Rotate interleaved IQ soft symbols by phase*90deg, optional IQ swap.
    Matches rotation.cpp:5-63 (including the -128 -> -127 clamp)."""
    s = soft.astype(np.int8).copy()
    np.clip(s, -127, 127, out=s)
    i, q = s[0::2].copy(), s[1::2].copy()
    if iq_swap:
        i, q = q, i
    if phase == PHASE_0:
        pass
    elif phase == PHASE_90:
        # (i,q) -> (q, -i)
        i, q = q, (-i).astype(np.int8)
    elif phase == PHASE_180:
        i, q = (-i).astype(np.int8), (-q).astype(np.int8)
    elif phase == PHASE_270:
        i, q = (-q).astype(np.int8), i
    else:
        raise ValueError(phase)
    out = np.empty_like(s)
    out[0::2], out[1::2] = i, q
    return out
