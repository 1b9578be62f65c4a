"""Reed-Solomon RS(255,223)/RS(255,239) CCSDS codec, batch-vectorized.

Reference: src-core/common/codings/reedsolomon/reedsolomon.cpp (which wraps
libcorrect with poly 0x187, fcr=112, root gap 11, 32/16 roots, plus CCSDS
dual-basis conversion and depth-4/5 interleaving).

This implementation is from scratch: GF(256) arithmetic via log/antilog
tables, syndromes -> Berlekamp-Massey -> Chien search -> Forney, all
vectorized over a batch of codewords (the lane-parallel formulation that maps
to TPU; the NumPy version is the portable reference and fast enough for
CADU-rate streams). Dual-basis tables are generated from the standard `tal`
basis images (Berlekamp dual basis of the CCSDS field) and checked against
the reference's tables in tests.

Conventions: codeword bytes [m_0 .. m_{k-1}, p_0 .. p_{2t-1}] where byte i is
the coefficient of x^(254-i) (highest degree transmitted first, per CCSDS).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PRIM_POLY = 0x187  # x^8 + x^7 + x^2 + x + 1 (CCSDS)


def _build_gf_tables(poly: int = PRIM_POLY) -> Tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= poly
    exp[255:510] = exp[0:255]
    log[0] = -255 * 4  # sentinel: any product involving 0 stays "very negative"
    return exp, log


GF_EXP, GF_LOG = _build_gf_tables()

_TABLE_CACHE = {}


def gf_tables(poly: int):
    """(exp, log, mul) tables for an arbitrary degree-8 primitive poly
    (CCSDS 0x187 default; DVB uses 0x11D)."""
    if poly not in _TABLE_CACHE:
        exp, log = _build_gf_tables(poly)
        la = log[np.arange(256)][:, None]
        lb = log[np.arange(256)][None, :]
        ss = la + lb
        mul = np.where(ss >= 0, exp[np.clip(ss, 0, 509) % 255], 0)
        mul[0, :] = 0
        mul[:, 0] = 0
        _TABLE_CACHE[poly] = (exp, log, mul.astype(np.uint8))
    return _TABLE_CACHE[poly]


def _build_mul_table() -> np.ndarray:
    """Full 256x256 GF(256) product table (64 KB): one fancy-index gather
    per vectorized multiply instead of two log lookups + add/mod/exp."""
    a = np.arange(256)
    la, lb = GF_LOG[a][:, None], GF_LOG[a][None, :]
    s = la + lb
    out = np.where(s >= 0, GF_EXP[np.clip(s, 0, 509) % 255], 0)
    out[0, :] = 0
    out[:, 0] = 0
    return out.astype(np.uint8)


GF_MUL = _build_mul_table()


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) product, elementwise-broadcast; one table gather, dtype uint8.
    (Products are GF elements <= 255, so no caller needs a wider dtype.)"""
    return GF_MUL[a, b]


def gf_inv(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.int32)
    return np.where(a == 0, 0, GF_EXP[(255 - GF_LOG[np.maximum(a, 1)] % 255) % 255]).astype(np.int32)


def gf_pow(base_log: int, e: np.ndarray) -> np.ndarray:
    """alpha^(base_log * e) for integer exponent arrays."""
    return GF_EXP[np.mod(base_log * np.asarray(e, np.int64), 255)].astype(np.int32)


# ---------------------------------------------------------------------------
# Dual-basis conversion (Berlekamp representation used on the CCSDS channel)
# ---------------------------------------------------------------------------
_TAL = np.array([0x8D, 0xEF, 0xEC, 0x86, 0xFA, 0x99, 0xAF, 0x7B], dtype=np.uint8)


def _build_dual_tables() -> Tuple[np.ndarray, np.ndarray]:
    to_dual = np.zeros(256, dtype=np.uint8)
    for i in range(256):
        v = 0
        for k in range(8):
            if i & (1 << k):
                v ^= int(_TAL[7 - k])
        to_dual[i] = v
    from_dual = np.zeros(256, dtype=np.uint8)
    from_dual[to_dual] = np.arange(256, dtype=np.uint8)
    return to_dual, from_dual


TO_DUAL, FROM_DUAL = _build_dual_tables()


class ReedSolomon:
    """CCSDS RS codec. type 223 -> RS(255,223) t=16; 239 -> RS(255,239) t=8."""

    def __init__(self, k: int = 223, fcr: int | None = None, prim: int = 11,
                 fill: int = 0, poly: int = PRIM_POLY):
        self.n = 255
        self.k = k
        if fcr is None:
            fcr = 112 if k == 223 else 120  # ref reedsolomon.cpp:48,55
        self.nroots = self.n - k
        self.fcr = fcr
        self.prim = prim
        self.fill = fill  # virtual fill (shortened code), ref fill_bytes
        self._exp, self._log, self._mul = gf_tables(poly)

        def _imul(a, b):
            return self._mul[a, b]
        self.gf_mul = _imul

        exp_, log_ = self._exp, self._log

        def _iinv(a):
            a = np.asarray(a, np.int32)
            return np.where(a == 0, 0,
                            exp_[(255 - log_[np.maximum(a, 1)] % 255) % 255]
                            ).astype(np.int32)
        self.gf_inv = _iinv
        # iprim: multiplicative inverse of prim mod 255, for locator conversion
        self.iprim = pow(prim, -1, 255)
        # generator polynomial g(x) = prod_j (x - alpha^(prim*(fcr+j)))
        g = np.zeros(self.nroots + 1, dtype=np.int32)
        g[0] = 1
        for j in range(self.nroots):
            root = self._exp[(self.prim * (self.fcr + j)) % 255]
            # multiply g by (x - root): new_g[i] = g[i-1] + root*g[i]
            ng = np.zeros_like(g)
            ng[1:] = g[:-1]
            ng ^= self.gf_mul(g, root)
            g = ng
        self.genpoly = g  # ascending order: g[i] = coeff of x^i, g[nroots]=1

    # -- encode -------------------------------------------------------------
    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg: (..., k) uint8 -> (..., 255) systematic codewords."""
        msg = np.atleast_2d(np.asarray(msg, np.uint8))
        B = msg.shape[0]
        nroots = self.nroots
        # LFSR division: parity = remainder of msg(x)*x^nroots mod g(x)
        par = np.zeros((B, nroots), dtype=np.int32)
        g = self.genpoly[:nroots][::-1]  # (g_{nroots-1} .. g_0), leading 1 dropped
        for i in range(self.k):
            fb = msg[:, i].astype(np.int32) ^ par[:, 0]
            par = np.roll(par, -1, axis=1)
            par[:, -1] = 0
            par ^= self.gf_mul(fb[:, None], g[None, :])
        out = np.concatenate([msg, par.astype(np.uint8)], axis=1)
        return out

    # -- decode -------------------------------------------------------------
    def _syndrome_table(self) -> np.ndarray:
        """C[i, v, :] = v * P[i, :] — the contribution of byte value v at
        position i to every syndrome. One row-gather per byte instead of a
        per-(byte, root) scalar gather (8x fewer index ops)."""
        if getattr(self, "_syn_tab", None) is None:
            deg = (254 - np.arange(255))
            j = np.arange(self.nroots)
            expo = np.mod(deg[:, None].astype(np.int64)
                          * self.prim * (self.fcr + j)[None, :], 255)
            P = self._exp[expo].astype(np.uint8)       # (255, nroots)
            self._syn_tab = self._mul[np.arange(256)[None, :, None],
                                   P[:, None, :]]      # (255, 256, nroots)
        return self._syn_tab

    def syndromes(self, cw: np.ndarray) -> np.ndarray:
        """cw: (B, 255). S_j = c(alpha^(prim*(fcr+j))), c with byte i as the
        coefficient of x^(254-i). Returns (B, nroots) uint8."""
        C = self._syndrome_table()
        terms = C[np.arange(255)[None, :], cw]         # (B, 255, nroots)
        return np.bitwise_xor.reduce(terms, axis=1)

    def _syndrome_bitmatrix(self) -> np.ndarray:
        """GF(2) bit-sliced syndrome operator M (2040, nroots*8) f32:
        S_bits = cw_bits @ M mod 2. GF(256) is a GF(2) vector space and
        multiplication by the constant P[i,j] is linear, so the whole
        syndrome map is one binary matmul — BLAS on host, MXU-shaped on
        TPU (SURVEY §7's 'GF math on lanes', done properly as matmul)."""
        if getattr(self, "_syn_M", None) is None:
            deg = (254 - np.arange(255))
            j = np.arange(self.nroots)
            expo = np.mod(deg[:, None].astype(np.int64)
                          * self.prim * (self.fcr + j)[None, :], 255)
            P = self._exp[expo].astype(np.uint8)           # (255, nroots)
            basis = (1 << (7 - np.arange(8))).astype(np.uint8)
            # prod[i, k, j] = mul(2^(7-k), P[i, j])
            prod = self._mul[basis[None, :, None], P[:, None, :]]
            bits = np.unpackbits(prod[..., None], axis=-1, count=8)
            M = bits.reshape(255 * 8, self.nroots * 8)
            self._syn_M = M.astype(np.float32)
        return self._syn_M

    def check(self, cw: np.ndarray) -> np.ndarray:
        """Fast parity check: True where the codeword is already valid.
        One (B, 2040) x (2040, nroots*8) matmul (exact in f32: row sums
        <= 2040 << 2^24)."""
        cw = np.atleast_2d(np.asarray(cw, np.uint8))
        bits = np.unpackbits(cw, axis=-1).astype(np.float32)
        s = bits @ self._syndrome_bitmatrix()
        return ~(s.astype(np.int64) & 1).any(axis=-1)

    def decode(self, cw: np.ndarray, _all_bad: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        """cw: (..., 255) uint8. Returns (corrected (..., 255), nerrors (...,))
        with nerrors = -1 for uncorrectable codewords (left unmodified)."""
        single = cw.ndim == 1
        cw = np.atleast_2d(np.asarray(cw, np.uint8)).copy()
        B = cw.shape[0]
        nroots = self.nroots
        t = nroots // 2
        if not _all_bad:
            clean = self.check(cw)
            if clean.all():
                # fast path: every codeword checks out — skip BM/Chien/
                # Forney entirely (the common case for post-Viterbi streams)
                nerrors = np.zeros(B, np.int32)
                if single:
                    return cw[0], nerrors[0]
                return cw, nerrors
            if clean.any():
                # decode only the erroneous lanes, merge back
                bad = ~clean
                fixed, nerr_bad = self.decode(cw[bad], _all_bad=True)
                out = cw.copy()
                out[bad] = fixed
                nerrors = np.zeros(B, np.int32)
                nerrors[bad] = nerr_bad
                if single:
                    return out[0], nerrors[0]
                return out, nerrors
        S = self.syndromes(cw)
        no_errors = ~S.any(axis=1)

        # Berlekamp-Massey, vectorized over batch:
        #   d==0       -> m += 1
        #   d!=0, 2L<=r-> Lambda -= (d/b) x^m B ; B <- old Lambda ; L <- r+1-L ;
        #                 b <- d ; m <- 1
        #   d!=0, 2L>r -> Lambda -= (d/b) x^m B ; m += 1
        Lambda = np.zeros((B, nroots + 1), dtype=np.int32)
        Bpoly = np.zeros((B, nroots + 1), dtype=np.int32)
        Lambda[:, 0] = 1
        Bpoly[:, 0] = 1
        L = np.zeros(B, dtype=np.int32)
        m = np.ones(B, dtype=np.int32)
        b = np.ones(B, dtype=np.int32)
        i = np.arange(nroots + 1)
        for r in range(nroots):
            Sidx = r - i
            Svals = np.where((Sidx >= 0)[None, :], S[:, np.clip(Sidx, 0, nroots - 1)], 0)
            d = np.bitwise_xor.reduce(self.gf_mul(Lambda, Svals), axis=1)
            d_zero = d == 0
            grow = (~d_zero) & (2 * L <= r)

            coef = self.gf_mul(d, self.gf_inv(b))
            idx = i[None, :] - m[:, None]  # x^m shift of B, per-lane m
            shiftedB = np.where(idx >= 0,
                                np.take_along_axis(Bpoly, np.clip(idx, 0, nroots), axis=1), 0)
            Lnew = Lambda ^ self.gf_mul(coef[:, None], shiftedB)

            Bpoly = np.where(grow[:, None], Lambda, Bpoly)
            b = np.where(grow, d, b)
            L = np.where(grow, r + 1 - L, L)
            m = np.where(grow, 1, m + 1)
            Lambda = np.where(d_zero[:, None], Lambda, Lnew)

        # Chien search: find roots of Lambda -> error positions
        # Lambda(alpha^(-prim*l)) == 0 at error location l (byte index 254-l deg l)
        lpow = np.arange(255)
        i = np.arange(nroots + 1)
        expo = np.mod(-self.prim * np.outer(lpow, i).astype(np.int64), 255)
        Z = self._exp[expo]  # (255, nroots+1): alpha^(-prim*l*i)
        vals = np.zeros((B, 255), dtype=np.int32)
        for ii in range(nroots + 1):
            vals ^= self.gf_mul(Lambda[:, ii][:, None], Z[None, :, ii])
        is_root = vals == 0  # (B, 255) — l indexes locator X = alpha^(prim*l)
        nerr = is_root.sum(axis=1)

        # Forney: error magnitude at each root
        # Omega(x) = [S(x) * Lambda(x)] mod x^nroots
        Om = np.zeros((B, nroots), dtype=np.int32)
        for ii in range(nroots):
            # Omega_ii = sum_{j<=ii} S_j * Lambda_{ii-j}
            j = np.arange(ii + 1)
            Om[:, ii] = np.bitwise_xor.reduce(
                self.gf_mul(S[:, j], Lambda[:, ii - j]), axis=1)
        # evaluate Omega and Lambda' at X^{-1} = alpha^{-prim*l}
        expo_om = np.mod(-self.prim * np.outer(lpow, np.arange(nroots)).astype(np.int64), 255)
        Zom = self._exp[expo_om]
        om_val = np.zeros((B, 255), dtype=np.int32)
        for ii in range(nroots):
            om_val ^= self.gf_mul(Om[:, ii][:, None], Zom[None, :, ii])
        # Lambda'(x): derivative = sum over odd i of Lambda_i x^(i-1)
        lam_d = np.zeros((B, 255), dtype=np.int32)
        for ii in range(1, nroots + 1, 2):
            expo_d = np.mod(-self.prim * (ii - 1) * lpow.astype(np.int64), 255)
            lam_d ^= self.gf_mul(Lambda[:, ii][:, None], self._exp[expo_d][None, :])
        # error value e_l = X^{1-fcr} * Omega(X^{-1}) / Lambda'(X^{-1})
        # with X = alpha^(prim*l): X^(1-fcr) = alpha^(prim*l*(1-fcr))
        xpow = self._exp[np.mod(self.prim * lpow.astype(np.int64) * (1 - self.fcr), 255)]
        mag = self.gf_mul(self.gf_mul(xpow[None, :], om_val), self.gf_inv(lam_d))
        mag = np.where(is_root, mag, 0)

        # apply corrections: an error of magnitude m at polynomial degree D
        # contributes S_j = m * Y^(fcr+j) with Y = beta^D (beta = alpha^prim),
        # so the locator lives in the beta domain: Lambda has a root at
        # x = beta^(-D). We searched x = beta^(-l), hence D = l directly.
        byte_idx = 254 - lpow  # byte index in the codeword
        corr = np.zeros_like(cw, dtype=np.int32)
        corr[:, byte_idx] ^= mag
        corrected = (cw.astype(np.int32) ^ corr).astype(np.uint8)

        # validate: recompute syndromes; failures flagged -1
        S2 = self.syndromes(corrected)
        ok = ~S2.any(axis=1)
        too_many = L > t
        good = ok & ~too_many | no_errors
        nerrors = np.where(no_errors, 0, np.where(good, nerr, -1)).astype(np.int32)
        out = np.where(good[:, None], corrected, cw)
        if single:
            return out[0], nerrors[0]
        return out, nerrors

    # -- dual basis + interleave (CADU-level helpers) ------------------------
    @staticmethod
    def to_dual(data: np.ndarray) -> np.ndarray:
        return TO_DUAL[np.asarray(data, np.uint8)]

    @staticmethod
    def from_dual(data: np.ndarray) -> np.ndarray:
        return FROM_DUAL[np.asarray(data, np.uint8)]

    def decode_interleaved(self, data: np.ndarray, ccsds_dual: bool, depth: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """data: (..., 255*depth) byte-interleaved block (CADU payload).
        Returns (corrected, errors (..., depth)). Mirrors
        reedsolomon.cpp decode_interlaved: codeword b = data[b::depth]."""
        single = data.ndim == 1
        data = np.atleast_2d(np.asarray(data, np.uint8))
        B = data.shape[0]
        cws = data.reshape(B, 255, depth).transpose(0, 2, 1).reshape(B * depth, 255)
        if ccsds_dual:
            cws = self.from_dual(cws)
        corrected, nerr = self.decode(cws)
        if ccsds_dual:
            corrected = self.to_dual(corrected)
        out = corrected.reshape(B, depth, 255).transpose(0, 2, 1).reshape(B, 255 * depth)
        nerr = nerr.reshape(B, depth)
        if single:
            return out[0], nerr[0]
        return out, nerr

    def encode_interleaved(self, msgs: np.ndarray, ccsds_dual: bool, depth: int
                           ) -> np.ndarray:
        """msgs: (..., k*depth) -> (..., 255*depth) interleaved codewords."""
        single = msgs.ndim == 1
        msgs = np.atleast_2d(np.asarray(msgs, np.uint8))
        B = msgs.shape[0]
        ms = msgs.reshape(B, self.k, depth).transpose(0, 2, 1).reshape(B * depth, self.k)
        if ccsds_dual:
            ms = self.from_dual(ms)
        cw = self.encode(ms)
        if ccsds_dual:
            cw = self.to_dual(cw)
        out = cw.reshape(B, depth, 255).transpose(0, 2, 1).reshape(B, 255 * depth)
        return out[0] if single else out
