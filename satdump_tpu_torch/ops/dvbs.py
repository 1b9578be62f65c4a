"""DVB-S legacy chain (EN 300 421): punctured Viterbi -> convolutional
deinterleave -> TS framing sync -> RS(204,188) -> energy-dispersal
derandomize -> MPEG-TS.

Reference behavior: plugins/dvb_support/dvbs/ (viterbi_all punctured rates,
dvbs_interleaving.h Forney I=12/M=17 deinterleaver, dvbs_reedsolomon
RS(204,188) over GF(0x11D), dvbs_defra TS deframer with the 1-in-8
inverted sync byte, dvbs_scrambling energy dispersal PRBS 1+x^14+x^15).
Here RS runs batched over all 8-packet groups of a chunk and the PRBS is a
precomputed vectorized XOR mask."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon

TS_SIZE = 188
RS_SIZE = 204
SYNC = 0x47
SYNC_INV = 0xB8
I_DEPTH = 12     # Forney interleaver branches
M_CELL = 17      # cell size per branch


# ---------------------------------------------------------------------------
# Energy dispersal PRBS (1 + x^14 + x^15, seed 100101010000000), applied to
# every byte except the sync bytes; reset every 8 packets; the first packet
# of a group carries the INVERTED sync byte.
# ---------------------------------------------------------------------------
def _prbs_sequence() -> np.ndarray:
    reg = 0b100101010000000
    out = np.empty(8 * TS_SIZE, np.uint8)
    for i in range(8 * TS_SIZE):
        b = 0
        for _ in range(8):
            fb = ((reg >> 14) ^ (reg >> 13)) & 1
            reg = ((reg << 1) | fb) & 0x7FFF
            b = (b << 1) | fb
        out[i] = b
    return out


_PRBS = _prbs_sequence()


def energy_dispersal(group: np.ndarray, derandomize: bool = True
                     ) -> np.ndarray:
    """One 8-packet group (8, 188): XOR all non-sync bytes with the PRBS
    (the PRBS also advances over the skipped sync positions, EN 300 421
    §4.1.1). Involution, so the same op randomizes."""
    g = np.asarray(group, np.uint8).reshape(8, TS_SIZE).copy()
    # PRBS byte 0 applies to the byte AFTER the inverted sync; the register
    # keeps advancing over the later sync bytes with output disabled
    mask = np.concatenate(
        [[np.uint8(0)], _PRBS[: 8 * TS_SIZE - 1]]).reshape(8, TS_SIZE).copy()
    mask[:, 0] = 0                       # sync bytes are never randomized
    g ^= mask
    return g


# ---------------------------------------------------------------------------
# Forney convolutional (de)interleaver, I=12 branches, cell M=17
# ---------------------------------------------------------------------------
class ConvDeinterleaver:
    """Byte-stream deinterleaver: branch j delays by (I-1-j)*M bytes
    (dvbs_interleaving.h). Streaming with carried FIFO state."""

    def __init__(self, I: int = I_DEPTH, M: int = M_CELL):
        self.I, self.M = I, M
        self._fifos = [np.zeros((I - 1 - j) * M, np.uint8)
                       for j in range(I)]

    def work(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.uint8)
        n = len(data) // self.I * self.I
        cols = data[:n].reshape(-1, self.I)        # row per interleaver step
        out = np.empty_like(cols)
        for j in range(self.I):
            fifo = self._fifos[j]
            stream = np.concatenate([fifo, cols[:, j]])
            out[:, j] = stream[: len(cols)]
            self._fifos[j] = stream[len(cols):]
        return out.reshape(-1)


class ConvInterleaver:
    """TX counterpart: branch j delays by j*M bytes."""

    def __init__(self, I: int = I_DEPTH, M: int = M_CELL):
        self.I, self.M = I, M
        self._fifos = [np.zeros(j * M, np.uint8) for j in range(I)]

    def work(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.uint8)
        n = len(data) // self.I * self.I
        cols = data[:n].reshape(-1, self.I)
        out = np.empty_like(cols)
        for j in range(self.I):
            fifo = self._fifos[j]
            stream = np.concatenate([fifo, cols[:, j]])
            out[:, j] = stream[: len(cols)]
            self._fifos[j] = stream[len(cols):]
        return out.reshape(-1)


# ---------------------------------------------------------------------------
# RS(204,188): RS(255,239) over GF(0x11D), fcr=0, prim=1, 51 bytes of
# virtual fill (dvbs_reedsolomon.h)
# ---------------------------------------------------------------------------
class DVBSReedSolomon:
    def __init__(self):
        self.rs = ReedSolomon(k=239, fcr=0, prim=1, poly=0x11D)
        self.fill = 255 - RS_SIZE   # 51

    def encode(self, pkts: np.ndarray) -> np.ndarray:
        """(B, 188) TS packets -> (B, 204) RS codewords."""
        pkts = np.atleast_2d(np.asarray(pkts, np.uint8))
        B = pkts.shape[0]
        msgs = np.concatenate(
            [np.zeros((B, self.fill), np.uint8), pkts], axis=1)
        cw = self.rs.encode(msgs)
        return cw[:, self.fill:]

    def decode(self, cws: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, 204) -> ((B, 188) packets, errors (B,) with -1 = bad)."""
        cws = np.atleast_2d(np.asarray(cws, np.uint8))
        B = cws.shape[0]
        full = np.concatenate(
            [np.zeros((B, self.fill), np.uint8), cws], axis=1)
        corr, nerr = self.rs.decode(full)
        return corr[:, self.fill: self.fill + TS_SIZE], nerr


# ---------------------------------------------------------------------------
# TS framing sync (dvbs_defra): find the 0x47/0xB8 comb on the
# deinterleaver-aligned byte stream
# ---------------------------------------------------------------------------
def find_ts_sync(data: np.ndarray, n_check: int = 8) -> Optional[int]:
    """Offset of the first RS-packet boundary such that data[off + k*204]
    is SYNC (or SYNC_INV once per 8). Vectorized comb search."""
    data = np.asarray(data, np.uint8)
    limit = len(data) - n_check * RS_SIZE
    if limit <= 0:
        return None
    offs = np.arange(min(RS_SIZE * 8, limit))
    idx = offs[:, None] + np.arange(n_check)[None, :] * RS_SIZE
    vals = data[idx]
    good = ((vals == SYNC) | (vals == SYNC_INV)).all(axis=1)
    inv_count = (vals == SYNC_INV).sum(axis=1)
    ok = good & (inv_count <= (n_check + 7) // 8)
    hits = np.flatnonzero(ok)
    return int(hits[0]) if len(hits) else None
