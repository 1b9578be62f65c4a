"""DVB-S2 outer BCH codec (EN 302 307-1 §5.3.1).

Reference behavior: plugins/dvb_support/codings/dvb-s2/bbframe_bch.h:37-88
(per-framesize GF(2^16)/GF(2^15)/GF(2^14) decoders, t = 8/10/12) and the
kbch/nbch table of bbframe_bch.cpp:39-150. This implementation is
clean-room from the standard: the generator polynomial is computed as the
product of minimal polynomials of alpha^1..alpha^2t (instead of hardcoding
the standard's factor list), encoding is a byte-table LFSR vectorized over
frames, and decoding is syndromes -> Berlekamp-Massey -> Chien search with
the per-position work vectorized in NumPy.

BCH here is a host-side codec by design: after LDPC convergence the
expected error count is ~0, so the hot path is the all-syndromes-zero
early-out; the full corrector only runs on the rare residual-error frame.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

# GF(2^m) primitive polynomials used by the standard's BCH codes
_GF_POLY = {16: 0b10000000000101101, 15: 0b1000000000101101,
            14: 0b100000000101011}

# (frame, rate) -> (kbch, nbch, t); EN 302 307-1 tables 5a/5b
PARAMS = {
    ("normal", "1/4"): (16008, 16200, 12), ("normal", "1/3"): (21408, 21600, 12),
    ("normal", "2/5"): (25728, 25920, 12), ("normal", "1/2"): (32208, 32400, 12),
    ("normal", "3/5"): (38688, 38880, 12), ("normal", "2/3"): (43040, 43200, 10),
    ("normal", "3/4"): (48408, 48600, 12), ("normal", "4/5"): (51648, 51840, 12),
    ("normal", "5/6"): (53840, 54000, 10), ("normal", "8/9"): (57472, 57600, 8),
    ("normal", "9/10"): (58192, 58320, 8),
    ("short", "1/4"): (3072, 3240, 12), ("short", "1/3"): (5232, 5400, 12),
    ("short", "2/5"): (6312, 6480, 12), ("short", "1/2"): (7032, 7200, 12),
    ("short", "3/5"): (9552, 9720, 12), ("short", "2/3"): (10632, 10800, 12),
    ("short", "3/4"): (11712, 11880, 12), ("short", "4/5"): (12432, 12600, 12),
    ("short", "5/6"): (13152, 13320, 12), ("short", "8/9"): (14232, 14400, 12),
}


class GF2m:
    """GF(2^m) log/antilog tables."""

    def __init__(self, m: int):
        self.m = m
        self.q = (1 << m) - 1
        poly = _GF_POLY[m]
        exp = np.zeros(2 * self.q, np.int64)
        log = np.zeros(self.q + 1, np.int64)
        x = 1
        for i in range(self.q):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x >> m:
                x ^= poly
        exp[self.q:] = exp[: self.q]
        self.exp, self.log = exp, log

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def inv(self, a: int) -> int:
        return int(self.exp[self.q - self.log[a]])


def _minimal_poly(gf: GF2m, e: int) -> Tuple[int, ...]:
    """Minimal polynomial of alpha^e as a GF(2) coefficient tuple
    (degree..0 order), via prod over the conjugacy coset of (x - alpha^j)."""
    coset = []
    c = e
    while c not in coset:
        coset.append(c)
        c = (c * 2) % gf.q
    # multiply (x + alpha^j) factors over GF(2^m)
    poly = [1]
    for j in coset:
        root = int(gf.exp[j])
        nxt = [0] * (len(poly) + 1)
        for i, coef in enumerate(poly):
            nxt[i] ^= coef                     # * x
            nxt[i + 1] ^= gf.mul(coef, root)   # * alpha^j
        poly = nxt
    assert all(v in (0, 1) for v in poly), "minimal poly not binary"
    return tuple(poly)


@lru_cache(maxsize=None)
def _generator(m: int, t: int) -> int:
    """BCH generator polynomial (as a Python int, bit deg..0) for a code
    correcting t errors over GF(2^m)."""
    gf = GF2m(m)
    seen = set()
    g = 1  # polynomial "1"
    for e in range(1, 2 * t + 1):
        mp = _minimal_poly(gf, e)
        if mp in seen:
            continue
        seen.add(mp)
        # multiply g by mp over GF(2)
        mp_int = 0
        for coef in mp:
            mp_int = (mp_int << 1) | coef
        acc = 0
        gg = g
        shift = 0
        while gg:
            if gg & 1:
                acc ^= mp_int << shift
            gg >>= 1
            shift += 1
        g = acc
    return g


class BCH:
    """Batched binary BCH codec for one DVB-S2 (frame, rate) config."""

    def __init__(self, frame: str, rate: str):
        self.kbch, self.nbch, self.t = PARAMS[(frame, rate)]
        self.m = {"normal": 16, "short": 14}[frame]
        self.gf = GF2m(self.m)
        self.deg = self.nbch - self.kbch
        assert self.deg % 8 == 0
        g = _generator(self.m, self.t)
        assert g.bit_length() - 1 == self.deg, (g.bit_length(), self.deg)
        self._words = self.deg // 64 if self.deg % 64 == 0 else self.deg // 64 + 1
        self._table = self._byte_table(g)

    # -- encode ------------------------------------------------------------
    def _byte_table(self, g: int) -> np.ndarray:
        """256-entry byte-step LFSR table as (256, W) uint64 words, with the
        deg-bit register left-aligned to the top of the W*64-bit array (word
        0 = most significant) so the byte-shift pipeline is uniform for any
        deg."""
        deg = self.deg
        mask = (1 << deg) - 1
        pad = self._words * 64 - deg
        tbl = np.zeros((256, self._words), np.uint64)
        for v in range(256):
            r = v << (deg - 8)
            for _ in range(8):
                r <<= 1
                if r >> deg:
                    r ^= g
            r = (r & mask) << pad
            for w in range(self._words):
                shift = (self._words - 1 - w) * 64
                tbl[v, w] = (r >> shift) & 0xFFFFFFFFFFFFFFFF
        return tbl

    def encode(self, msg_bits: np.ndarray) -> np.ndarray:
        """msg (B, kbch) bits -> codeword (B, nbch) = [msg | parity]."""
        msg_bits = np.asarray(msg_bits, np.uint8)
        B = msg_bits.shape[0]
        msg_bytes = np.packbits(msg_bits, axis=-1)
        W = self._words
        state = np.zeros((B, W), np.uint64)
        tbl = self._table
        for i in range(msg_bytes.shape[1]):
            top = (state[:, 0] >> np.uint64(56)).astype(np.uint8) ^ msg_bytes[:, i]
            # state <<= 8 (across words)
            state = (state << np.uint64(8)) | np.concatenate(
                [state[:, 1:] >> np.uint64(56),
                 np.zeros((B, 1), np.uint64)], axis=1)
            state ^= tbl[top]
        # unpack parity words to bits
        pbytes = state.view(np.uint8).reshape(B, W, 8)[:, :, ::-1].reshape(B, W * 8)
        parity = np.unpackbits(pbytes, axis=-1)[:, : self.deg]
        return np.concatenate([msg_bits, parity.astype(np.uint8)], axis=-1)

    # -- decode ------------------------------------------------------------
    def _syndromes(self, bits: np.ndarray) -> np.ndarray:
        """bits (nbch,) -> syndromes S_1..S_2t (ints)."""
        pos = np.nonzero(bits)[0]
        d = (self.nbch - 1 - pos).astype(np.int64)       # term degrees
        i = np.arange(1, 2 * self.t + 1, dtype=np.int64)[:, None]
        idx = (i * d[None, :]) % self.gf.q
        vals = self.gf.exp[idx]
        return np.bitwise_xor.reduce(vals, axis=1) if pos.size else \
            np.zeros(2 * self.t, np.int64)

    def _berlekamp_massey(self, S: np.ndarray) -> list:
        """Binary-BCH BM: returns error-locator coefficients [1, l1, ...]."""
        gf = self.gf
        C, B = [1], [1]
        L, mshift, b = 0, 1, 1
        for n in range(2 * self.t):
            d = int(S[n])
            for i in range(1, L + 1):
                if i < len(C) and C[i] and n - i >= 0:
                    d ^= gf.mul(C[i], int(S[n - i]))
            if d == 0:
                mshift += 1
            elif 2 * L <= n:
                T = C[:]
                coef = gf.mul(d, gf.inv(b))
                ext = [0] * mshift + [gf.mul(coef, x) for x in B]
                while len(C) < len(ext):
                    C.append(0)
                for i, v in enumerate(ext):
                    C[i] ^= v
                L, B, b, mshift = n + 1 - L, T, d, 1
            else:
                coef = gf.mul(d, gf.inv(b))
                ext = [0] * mshift + [gf.mul(coef, x) for x in B]
                while len(C) < len(ext):
                    C.append(0)
                for i, v in enumerate(ext):
                    C[i] ^= v
                mshift += 1
        return C[: L + 1]

    def _chien(self, C: list) -> np.ndarray:
        """Error positions (bit indices into the nbch frame)."""
        gf = self.gf
        j = np.arange(self.nbch, dtype=np.int64)
        d = self.nbch - 1 - j                            # degree of position j
        acc = np.full(self.nbch, C[0], np.int64)
        for k in range(1, len(C)):
            if C[k] == 0:
                continue
            lk = int(gf.log[C[k]])
            idx = (lk + (gf.q - (d * k) % gf.q)) % gf.q  # C_k * alpha^{-dk}
            acc ^= gf.exp[idx]
        return j[acc == 0]

    def decode(self, bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """bits (B, nbch) -> (corrected (B, nbch), n_corrected (B,); -1 =
        uncorrectable)."""
        bits = np.asarray(bits, np.uint8).copy()
        B = bits.shape[0]
        ncorr = np.zeros(B, np.int32)
        for fi in range(B):
            S = self._syndromes(bits[fi])
            if not S.any():
                continue
            C = self._berlekamp_massey(S)
            if len(C) - 1 > self.t:
                ncorr[fi] = -1
                continue
            errs = self._chien(C)
            if errs.size != len(C) - 1:
                ncorr[fi] = -1
                continue
            bits[fi, errs] ^= 1
            if self._syndromes(bits[fi]).any():
                ncorr[fi] = -1
            else:
                ncorr[fi] = errs.size
        return bits, ncorr


@lru_cache(maxsize=None)
def get_bch(frame: str, rate: str) -> BCH:
    return BCH(frame, rate)
