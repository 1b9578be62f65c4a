"""DVB-S2 physical-layer definitions: SOF/PLS codes, pi/2-BPSK header
symbols, MODCOD table, PLFRAME geometry, constellations.

Reference behavior: plugins/dvb_support/dvbs2/s2_defs.h (SOF 0x18D2E82,
RM(64,7) PLS codewords with scrambling constant 0x719D83C953422DFA),
codings/dvb-s2/modcod_to_cfg.h (MODCOD -> slots/constellation/rate), and
src-core/common/dsp/demod/constellation.cpp (DVB-S2 bit mappings). All
numeric constants are from EN 302 307-1.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np

SOF_VALUE = 0x18D2E82
SOF_LEN = 26
PLS_LEN = 64
PLS_SCRAMBLE = 0x719D83C953422DFA
HDR_LEN = SOF_LEN + PLS_LEN          # 90
SLOT = 90
PILOT_LEN = 36
PILOT_PERIOD_SLOTS = 16


# ---------------------------------------------------------------------------
# Header symbols (pi/2-BPSK)
# ---------------------------------------------------------------------------
def _pi2bpsk(bits: np.ndarray) -> np.ndarray:
    """bits (L,) -> pi/2-BPSK symbols: angle pi/4 + (2*bit + (i&1)) * pi/2."""
    i = np.arange(len(bits))
    ang = np.pi / 4 + (2 * bits + (i & 1)) * (np.pi / 2)
    return np.exp(1j * ang).astype(np.complex64)


@lru_cache(maxsize=1)
def sof_symbols() -> np.ndarray:
    bits = np.array([(SOF_VALUE >> (SOF_LEN - 1 - i)) & 1
                     for i in range(SOF_LEN)], np.int64)
    return _pi2bpsk(bits)


@lru_cache(maxsize=1)
def pls_codewords() -> np.ndarray:
    """(128, 64) bit array: Reed-Muller (64,7) PLS codewords, scrambled.
    Index = MODCOD[4:0] << 2 | SHORTFRAME << 1 | PILOTS."""
    G = np.array([0x55555555, 0x33333333, 0x0F0F0F0F,
                  0x00FF00FF, 0x0000FFFF, 0xFFFFFFFF], np.uint64)
    out = np.zeros((128, PLS_LEN), np.uint8)
    for index in range(128):
        y = np.uint64(0)
        for row in range(6):
            if (index >> (6 - row)) & 1:
                y ^= G[row]
        code = 0
        for bit in range(31, -1, -1):
            yi = (int(y) >> bit) & 1
            if index & 1:
                code = (code << 2) | (yi << 1) | (yi ^ 1)
            else:
                code = (code << 2) | (yi << 1) | yi
        code ^= PLS_SCRAMBLE
        out[index] = [(code >> (PLS_LEN - 1 - i)) & 1 for i in range(PLS_LEN)]
    return out


@lru_cache(maxsize=1)
def pls_symbols() -> np.ndarray:
    """(128, 64) complex64 pi/2-BPSK symbols for every PLS codeword."""
    cws = pls_codewords()
    return np.stack([_pi2bpsk(cw) for cw in cws])


@lru_cache(maxsize=1)
def header_diff_refs():
    """Expected differential sequences for the batched PL-header search:
    (e_sof (25,), e_pls (32,)) where e_sof[i] = conj(s_i) s_{i+1} over the
    SOF and e_pls[k] = conj(p_2k) p_{2k+1} over a pilots-off PLS codeword
    (the within-pair differential depends only on the index LSB, so one
    reference covers all pilots-off codewords and its negation pilots-on —
    dvbs2_pl_sync.cpp:88-91 exploits the same symmetry)."""
    s = sof_symbols()
    e_sof = (np.conj(s[:-1]) * s[1:]).astype(np.complex64)
    p = pls_symbols()[0]                      # any even index (pilots off)
    e_pls = (np.conj(p[0::2]) * p[1::2]).astype(np.complex64)
    return e_sof, e_pls


# ---------------------------------------------------------------------------
# MODCOD table (modcod_to_cfg.h)
# ---------------------------------------------------------------------------
class ModcodCfg(NamedTuple):
    modcod: int
    constellation: str     # qpsk / 8psk / 16apsk / 32apsk
    rate: str
    frame: str             # normal / short
    slots: int             # payload slots (90 symbols each)
    pilots: bool
    g1: float
    g2: float


_QPSK_RATES = {1: "1/4", 2: "1/3", 3: "2/5", 4: "1/2", 5: "3/5", 6: "2/3",
               7: "3/4", 8: "4/5", 9: "5/6", 10: "8/9", 11: "9/10"}
_8PSK_RATES = {12: "3/5", 13: "2/3", 14: "3/4", 15: "5/6", 16: "8/9",
               17: "9/10"}
_16APSK = {18: ("2/3", 3.15), 19: ("3/4", 2.85), 20: ("4/5", 2.75),
           21: ("5/6", 2.70), 22: ("8/9", 2.60), 23: ("9/10", 2.57)}
_32APSK = {24: ("3/4", 2.84, 5.27), 25: ("4/5", 2.72, 4.87),
           26: ("5/6", 2.64, 4.64), 27: ("8/9", 2.54, 4.33),
           28: ("9/10", 2.53, 4.30)}


def get_modcod_cfg(modcod: int, shortframes: bool, pilots: bool) -> ModcodCfg:
    frame = "short" if shortframes else "normal"
    if modcod in _QPSK_RATES:
        return ModcodCfg(modcod, "qpsk", _QPSK_RATES[modcod], frame,
                         90 if shortframes else 360, pilots, 0.0, 0.0)
    if modcod in _8PSK_RATES:
        return ModcodCfg(modcod, "8psk", _8PSK_RATES[modcod], frame,
                         60 if shortframes else 240, pilots, 0.0, 0.0)
    if modcod in _16APSK:
        rate, g1 = _16APSK[modcod]
        return ModcodCfg(modcod, "16apsk", rate, frame,
                         45 if shortframes else 180, pilots, g1, 0.0)
    if modcod in _32APSK:
        rate, g1, g2 = _32APSK[modcod]
        return ModcodCfg(modcod, "32apsk", rate, frame,
                         36 if shortframes else 144, pilots, g1, g2)
    raise ValueError(f"unsupported MODCOD {modcod}")


def pls_index(cfg: ModcodCfg) -> int:
    return cfg.modcod << 2 | (cfg.frame == "short") << 1 | cfg.pilots


def pilot_count(slots: int, pilots: bool) -> int:
    """Pilot blocks in a PLFRAME: one after each 16 payload slots, none at
    the frame end (dvbs2_pl_sync.cpp:16-27 geometry)."""
    if not pilots:
        return 0
    full, rem = divmod(slots, PILOT_PERIOD_SLOTS)
    return full if rem > 0 else full - 1 if full > 0 else 0


def plframe_len(cfg: ModcodCfg) -> int:
    return HDR_LEN + cfg.slots * SLOT + pilot_count(cfg.slots, cfg.pilots) * PILOT_LEN


def payload_data_mask(cfg: ModcodCfg) -> np.ndarray:
    """Bool mask over the post-header payload: True = data symbol, False =
    pilot symbol."""
    n_pay = cfg.slots * SLOT + pilot_count(cfg.slots, cfg.pilots) * PILOT_LEN
    mask = np.ones(n_pay, bool)
    if cfg.pilots:
        stride = PILOT_PERIOD_SLOTS * SLOT
        pos = stride
        while pos + PILOT_LEN <= n_pay:
            mask[pos: pos + PILOT_LEN] = False
            pos += stride + PILOT_LEN
    return mask


# ---------------------------------------------------------------------------
# Constellations (bit-mapping tables; index = bits MSB-first)
# ---------------------------------------------------------------------------
def _polar(r: float, n: int, i: float) -> complex:
    a = i * 2 * np.pi / n
    return complex(r * np.cos(a), r * np.sin(a))


@lru_cache(maxsize=None)
def constellation(kind: str, g1: float = 0.0, g2: float = 0.0) -> np.ndarray:
    """(2^m,) complex64 unit-power constellation, index = symbol bits
    MSB-first (DVB-S2 mappings, constellation.cpp:22-166)."""
    s = 1 / np.sqrt(2)
    if kind == "qpsk":
        pts = [(-s - s * 1j), (s - s * 1j), (-s + s * 1j), (s + s * 1j)]
    elif kind == "8psk":
        pts = [(-1j), (-s + s * 1j), (s - s * 1j), (1j),
               (-s - s * 1j), (-1.0 + 0j), (1.0 + 0j), (s + s * 1j)]
    elif kind == "16apsk":
        gamma = g1 or 2.57
        r1 = np.sqrt(4 / (1 + 3 * gamma * gamma))
        r2 = gamma * r1
        r1, r2 = r1 / 2, r2 / 2
        ring = {15: 1.5, 14: 10.5, 13: 4.5, 12: 7.5, 11: 0.5, 10: 11.5,
                9: 5.5, 8: 6.5, 7: 2.5, 6: 9.5, 5: 3.5, 4: 8.5}
        inner = {3: 0.5, 2: 3.5, 1: 1.5, 0: 2.5}
        pts = [0j] * 16
        for k, i in ring.items():
            pts[k] = _polar(r2, 12, i)
        for k, i in inner.items():
            pts[k] = _polar(r1, 4, i)
    elif kind == "32apsk":
        gamma1, gamma2 = g1 or 2.53, g2 or 4.30
        r1 = np.sqrt(8 / (1 + 3 * gamma1 ** 2 + 4 * gamma2 ** 2))
        r2, r3 = gamma1 * r1, gamma2 * r1
        r1, r2, r3 = r1 / 2, r2 / 2, r3 / 2
        mid = {31: 1.5, 30: 2.5, 29: 10.5, 28: 9.5, 27: 4.5, 26: 3.5,
               25: 7.5, 24: 8.5, 15: 0.5, 13: 11.5, 11: 5.5, 9: 6.5}
        outer = {23: 1, 22: 3, 21: 14, 20: 12, 19: 6, 18: 4, 17: 9, 16: 11,
                 7: 0, 6: 2, 5: 15, 4: 13, 3: 7, 2: 5, 1: 8, 0: 10}
        inner = {14: 0.5, 12: 3.5, 10: 1.5, 8: 2.5}
        pts = [0j] * 32
        for k, i in mid.items():
            pts[k] = _polar(r2, 12, i)
        for k, i in outer.items():
            pts[k] = _polar(r3, 16, i)
        for k, i in inner.items():
            pts[k] = _polar(r1, 4, i)
    else:
        raise ValueError(f"unknown constellation {kind}")
    arr = np.asarray(pts, np.complex64)
    # normalize to unit average power
    return (arr / np.sqrt(np.mean(np.abs(arr) ** 2))).astype(np.complex64)


MOD_BITS = {"qpsk": 2, "8psk": 3, "16apsk": 4, "32apsk": 5}
