"""DVB-S2 baseband frames: BBHeader parse/build, CRC-8, TS extraction and
the TX-side TS->BBFrame packer.

Reference behavior: src-core/common/codings/dvb-s2/bbframe_ts_parser.h/.cpp
(BBHeader fields; header CRC-8 with poly 0xAB over the 80-bit header
checking to zero; data-field stream of 188-byte units [crc_prev][187
payload] where each packet's sync byte is replaced by the CRC-8 of the
previous packet's 187 bytes; SYNCD = bit offset of the first crc slot;
TEI flag set on CRC mismatch).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np

TS_SIZE = 188
TS_SYNC = 0x47
TS_ERROR_INDICATOR = 0x80

_CRC_POLY = 0xAB    # bit-serial LSB-feedback form (check_crc8)
_CRC_POLYR = 0xD5   # MSB-first reflected form (packet crc table)


@lru_cache(maxsize=1)
def _crc_table() -> np.ndarray:
    """MSB-first CRC-8 table, poly 0xD5 (bbframe_ts_parser.cpp:53-72).
    Usage: crc = tbl[byte ^ crc]."""
    tbl = np.zeros(256, np.uint8)
    for v in range(256):
        crc = v
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC_POLYR) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
        tbl[v] = crc
    return tbl


def crc8_bytes(data: np.ndarray, init: int = 0) -> int:
    """Byte-stream CRC-8 (packet payloads)."""
    tbl = _crc_table()
    crc = init
    for byte in np.asarray(data, np.uint8):
        crc = int(tbl[int(byte) ^ crc])
    return crc


def _crc8_bitserial(data: np.ndarray, nbits: int) -> int:
    """Bit-serial CRC-8 with LSB feedback over the first nbits MSB-first
    bits (check_crc8 semantics, used on the 80-bit BBHeader)."""
    crc = 0
    d = np.asarray(data, np.uint8)
    for n in range(nbits):
        b = ((int(d[n // 8]) >> (7 - n % 8)) & 1) ^ (crc & 1)
        crc >>= 1
        if b:
            crc ^= _CRC_POLY
    return crc


def header_crc(hdr9: np.ndarray) -> int:
    """CRC byte X such that the check over the full 80 bits yields 0
    (the recurrence is bijective in the appended byte, so X exists and is
    unique; found by direct search)."""
    buf = np.zeros(10, np.uint8)
    buf[:9] = np.asarray(hdr9, np.uint8)
    for x in range(256):
        buf[9] = x
        if _crc8_bitserial(buf, 80) == 0:
            return x
    raise AssertionError("no CRC byte found")


def header_crc_ok(bbf: np.ndarray) -> bool:
    return _crc8_bitserial(bbf, 80) == 0


@dataclass
class BBHeader:
    ts_gs: int = 0b11        # 11 = MPEG-TS
    sis_mis: bool = True     # single input stream
    ccm_acm: bool = True     # CCM
    issyi: bool = False
    npd: bool = False
    ro: int = 0
    isi: int = 0
    upl: int = TS_SIZE * 8
    dfl: int = 0
    sync: int = TS_SYNC
    syncd: int = 0

    @classmethod
    def parse(cls, bbf: np.ndarray) -> "BBHeader":
        b = np.asarray(bbf, np.uint8)
        return cls(
            ts_gs=int(b[0] >> 6), sis_mis=bool((b[0] >> 5) & 1),
            ccm_acm=bool((b[0] >> 4) & 1), issyi=bool((b[0] >> 3) & 1),
            npd=bool((b[0] >> 2) & 1), ro=int(b[0] & 3),
            isi=int(b[1]) if not ((b[0] >> 5) & 1) else 0,
            upl=int(b[2]) << 8 | int(b[3]), dfl=int(b[4]) << 8 | int(b[5]),
            sync=int(b[6]), syncd=int(b[7]) << 8 | int(b[8]))

    def build(self) -> np.ndarray:
        b = np.zeros(10, np.uint8)
        b[0] = (self.ts_gs << 6 | self.sis_mis << 5 | self.ccm_acm << 4
                | self.issyi << 3 | self.npd << 2 | self.ro)
        b[1] = self.isi
        b[2], b[3] = self.upl >> 8, self.upl & 0xFF
        b[4], b[5] = self.dfl >> 8, self.dfl & 0xFF
        b[6] = self.sync
        b[7], b[8] = self.syncd >> 8, self.syncd & 0xFF
        b[9] = header_crc(b[:9])
        return b


class BBFrameTSParser:
    """Streaming BBFrame -> MPEG-TS extractor (stateful across calls).
    Mirrors BBFrameTSParser::work (bbframe_ts_parser.cpp:98-245)."""

    def __init__(self, kbch: int):
        self.kbch = kbch
        self.max_dfl = kbch - 80
        self.synched = False
        self._unit = np.zeros(0, np.uint8)   # carry of the current 188 unit
        self.header_errors = 0
        self.packet_crc_errors = 0

    def work(self, bbframes: np.ndarray) -> np.ndarray:
        """bbframes (B, kbch/8) uint8 (descrambled) -> 188-byte TS packets.
        After sync the data-field stream is repeating 188-byte units
        [187 payload][crc]; units may span frame boundaries."""
        out: List[np.ndarray] = []
        tbl = _crc_table()
        for bbf in np.asarray(bbframes, np.uint8).reshape(-1, self.kbch // 8):
            if not header_crc_ok(bbf[:10]):
                self.header_errors += 1
                self.synched = False
                continue
            hdr = BBHeader.parse(bbf)
            if hdr.dfl > self.max_dfl or hdr.dfl % 8 != 0:
                self.synched = False
                continue
            df = bbf[10: 10 + hdr.dfl // 8]
            pos = 0
            if self.synched and hdr.syncd != 0xFFFF:
                # verify SYNCD against the walking unit position: a dropped
                # frame upstream desynchronizes the unit stream silently
                # (the bbframe_ts_parser.cpp:195-199 distance check)
                expected = (TS_SIZE - 1 - len(self._unit)) % TS_SIZE
                if hdr.syncd // 8 != expected:
                    self.synched = False
            if not self.synched:
                if hdr.syncd == 0xFFFF or hdr.syncd // 8 + 1 >= len(df):
                    continue
                pos = hdr.syncd // 8 + 1        # first payload byte
                self._unit = np.zeros(0, np.uint8)
                self.synched = True
            stream = np.concatenate([self._unit, df[pos:]])
            n_units = len(stream) // TS_SIZE
            for u in range(n_units):
                unit = stream[u * TS_SIZE: (u + 1) * TS_SIZE]
                self._flush(out, unit[: TS_SIZE - 1], int(unit[TS_SIZE - 1]), tbl)
            self._unit = stream[n_units * TS_SIZE:].copy()
        return np.concatenate(out) if out else np.zeros(0, np.uint8)

    def _flush(self, out, payload, crc_byte, tbl):
        crc = 0
        for b in payload:
            crc = int(tbl[int(b) ^ crc])
        pkt = np.empty(TS_SIZE, np.uint8)
        pkt[0] = TS_SYNC
        pkt[1:] = payload
        if crc != crc_byte:
            self.packet_crc_errors += 1
            pkt[1] |= TS_ERROR_INDICATOR
        out.append(pkt)


def ts_to_bbframes(ts: np.ndarray, kbch: int) -> np.ndarray:
    """TX fixture: 188-byte TS packets -> (B, kbch/8) BBFrames
    (unscrambled). The data-field stream is 188-byte units
    [crc_of_previous_packet][187 payload]; SYNCD = bit offset of the first
    crc slot in each frame."""
    ts = np.asarray(ts, np.uint8).reshape(-1, TS_SIZE)
    tbl = _crc_table()
    stream = np.zeros(len(ts) * TS_SIZE, np.uint8)
    crc_prev = 0
    for i, pkt in enumerate(ts):
        assert pkt[0] == TS_SYNC
        stream[i * TS_SIZE] = crc_prev
        stream[i * TS_SIZE + 1: (i + 1) * TS_SIZE] = pkt[1:]
        crc_prev = 0
        for b in pkt[1:]:
            crc_prev = int(tbl[int(b) ^ crc_prev])
    dfl_bytes = (kbch - 80) // 8
    n_frames = int(np.ceil(len(stream) / dfl_bytes))
    frames = np.zeros((n_frames, kbch // 8), np.uint8)
    for fi in range(n_frames):
        chunk = stream[fi * dfl_bytes: (fi + 1) * dfl_bytes]
        used = len(chunk)
        first_crc_slot = (-(fi * dfl_bytes)) % TS_SIZE
        syncd = first_crc_slot * 8 if first_crc_slot + 1 < used else 0xFFFF
        hdr = BBHeader(dfl=used * 8, syncd=syncd)
        frames[fi, :10] = hdr.build()
        frames[fi, 10: 10 + used] = chunk
    return frames
