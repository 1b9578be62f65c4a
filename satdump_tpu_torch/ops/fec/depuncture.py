"""Depuncturing for punctured convolutional rates 2/3, 3/4, 5/6, 7/8.

Reference behavior: src-core/common/codings/viterbi/depunc.h (Depunc23/34/
56/78) — each class expands the punctured soft stream back to the rate-1/2
pair stream by inserting 128-erasures in a fixed per-period pattern, with a
"shift" hypothesis (pattern rotation, plus a pair-parity flip for shifts
>= period) searched during lock, and continuous operation that holds back a
trailing odd value so the output stays pair-aligned.

TPU-native formulation: the per-sample if/else chain becomes two constant
per-period tables (emit-length and in-group offset); a block depuncture is
then one cumsum + one scatter, vectorized over the whole block. The same
tables drive `puncture()` (the TX/test inverse).

Soft convention matches the reference Viterbi path: uint8, 0/255 confident,
128 = erasure.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

ERASE = 128

# per-pattern-index emission: (group length, offset of the input value within
# the group); remaining group slots are erasures. Derived from depunc.h
# depunc_static case chains.
_PATTERNS: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "2/3": ((1, 0), (2, 0), (1, 0)),
    "3/4": ((1, 0), (2, 0), (1, 0), (2, 0)),
    "5/6": ((1, 0), (2, 0), (1, 0), (2, 0), (2, 1), (2, 0)),
    "7/8": ((1, 0), (2, 0), (2, 0), (2, 0), (1, 0), (2, 0), (2, 1), (2, 0)),
}

# re-encode BER scale per rate (depunc.h get_berscale)
BER_SCALE = {"1/2": 2.5, "2/3": 3.5, "3/4": 5.0, "5/6": 8.0, "7/8": 10.0}


class Depuncturer:
    """One puncturing rate; holds the continuous-mode carry state."""

    def __init__(self, rate: str):
        if rate not in _PATTERNS:
            raise ValueError(f"unsupported puncturing rate '{rate}' "
                             f"(have {sorted(_PATTERNS)})")
        self.rate = rate
        pat = _PATTERNS[rate]
        self.period = len(pat)
        self.lens = np.asarray([l for l, _ in pat], np.int64)
        self.offs = np.asarray([o for _, o in pat], np.int64)
        self.berscale = BER_SCALE[rate]
        # continuous state (ref depunc.h set_shift/depunc_cont)
        self.changing_shift = 0
        self.pending = False
        self.buf = np.uint8(ERASE)

    @property
    def numstates(self) -> int:
        return self.period

    # -- one-shot (lock search) ----------------------------------------------
    def depunc_static(self, soft: np.ndarray, shift: int) -> np.ndarray:
        """Depuncture with a fixed shift hypothesis. shift in [0, 2*period):
        shift % period rotates the pattern; shift >= period also prepends one
        erasure (flips the output pair parity)."""
        soft = np.asarray(soft, np.uint8)
        n = len(soft)
        actual = shift % self.period
        pre = 1 if shift > self.period - 1 else 0
        pidx = (np.arange(n) + actual) % self.period
        lens = self.lens[pidx]
        starts = pre + np.cumsum(lens) - lens
        out = np.full(pre + int(lens.sum()), ERASE, np.uint8)
        out[starts + self.offs[pidx]] = soft
        return out

    # -- continuous ------------------------------------------------------------
    def set_shift(self, shift: int) -> None:
        self.changing_shift = shift
        self.pending = shift > self.period - 1
        self.buf = np.uint8(ERASE)

    def depunc_cont(self, soft: np.ndarray) -> np.ndarray:
        """Streaming depuncture; output length is always even (a trailing odd
        value is carried to the next call, ref depunc_cont tail handling)."""
        soft = np.asarray(soft, np.uint8)
        n = len(soft)
        pidx = (self.changing_shift % self.period
                + np.arange(n)) % self.period
        lens = self.lens[pidx]
        pre = 1 if self.pending else 0
        starts = pre + np.cumsum(lens) - lens
        total = pre + int(lens.sum())
        out = np.full(total, ERASE, np.uint8)
        if pre:
            out[0] = self.buf
        out[starts + self.offs[pidx]] = soft
        self.changing_shift = (self.changing_shift + n) % self.period
        self.pending = False
        if total % 2 == 1:
            self.buf = out[-1]
            out = out[:-1]
            self.pending = True
        return out


def puncture(stream: np.ndarray, rate: str, shift: int = 0) -> np.ndarray:
    """TX-side inverse of depunc_static (test fixture): select from a full
    rate-1/2 pair stream the symbols that survive puncturing. The selected
    stream, depunctured with the same shift, reproduces `stream` with
    erasures at the dropped positions."""
    if rate == "1/2":
        return np.asarray(stream)
    d = Depuncturer(rate)
    stream = np.asarray(stream)
    pre = 1 if shift > d.period - 1 else 0
    actual = shift % d.period
    n_max = len(stream)  # lens >= 1, so n <= len(stream)
    pidx = (np.arange(n_max) + actual) % d.period
    lens = d.lens[pidx]
    ends = pre + np.cumsum(lens)
    n = int(np.searchsorted(ends, len(stream), side="right"))
    starts = ends[:n] - lens[:n]
    return stream[starts + d.offs[pidx[:n]]]
