"""CCSDS framing layer: Space Packets, AOS VCDU/M-PDU parsing, demuxer.

Behavioral equivalent of src-core/common/ccsds/ (ccsds.h:17-60, ccsds_aos/
{vcdu,mpdu,demuxer}.{h,cpp}): CADUs -> per-VCID M-PDU streams -> reassembled
Space Packets. This is host-side control-plane code (byte shuffling at frame
rate, ~KB/s after FEC), so plain NumPy/Python is the right tool — the card
owns the sample-rate stages upstream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

HEADER_LENGTH = 6


@dataclass
class CCSDSHeader:
    """Space Packet primary header (ref ccsds.h:17, 6 bytes big-endian)."""
    version: int = 0
    type: bool = False
    secondary_header_flag: bool = False
    apid: int = 0
    sequence_flag: int = 0
    packet_sequence_count: int = 0
    packet_length: int = 0
    raw: bytes = b"\x00" * 6

    @classmethod
    def parse(cls, h) -> "CCSDSHeader":
        h = bytes(h[:6])
        return cls(
            version=h[0] >> 5,
            type=bool((h[0] >> 4) & 1),
            secondary_header_flag=bool((h[0] >> 3) & 1),
            apid=(h[0] & 0b111) << 8 | h[1],
            sequence_flag=h[2] >> 6,
            packet_sequence_count=(h[2] & 0b111111) << 8 | h[3],
            packet_length=h[4] << 8 | h[5],
            raw=h,
        )

    def encode(self) -> bytes:
        return bytes([
            (self.version << 5) | (int(self.type) << 4)
            | (int(self.secondary_header_flag) << 3) | (self.apid >> 8),
            self.apid & 0xFF,
            (self.sequence_flag << 6) | (self.packet_sequence_count >> 8),
            self.packet_sequence_count & 0xFF,
            self.packet_length >> 8,
            self.packet_length & 0xFF,
        ])


@dataclass
class CCSDSPacket:
    header: CCSDSHeader = field(default_factory=CCSDSHeader)
    payload: bytearray = field(default_factory=bytearray)


@dataclass
class VCDU:
    """AOS transfer-frame header fields (ref ccsds_aos/vcdu.cpp)."""
    version: int
    spacecraft_id: int
    vcid: int
    vcdu_counter: int
    replay_flag: bool


def parse_vcdu(cadu) -> VCDU:
    """Parse the VCDU header following the 4-byte ASM (ref vcdu.cpp:10-19)."""
    c = np.frombuffer(bytes(cadu[:10]), np.uint8)
    return VCDU(
        version=int(c[4] >> 6),
        spacecraft_id=int((c[4] & 0b111111) << 2 | c[5] >> 6),
        vcid=int(c[5] & 0b111111),
        vcdu_counter=int(c[6]) << 16 | int(c[7]) << 8 | int(c[8]),
        replay_flag=bool(c[9] >> 7),
    )


def parse_mpdu(cadu, has_insert_zone: bool = False, insert_zone_size: int = 2):
    """Return (first_header_pointer, data view) (ref mpdu.cpp:10-15)."""
    off = 10 + (insert_zone_size if has_insert_zone else 0)
    fhp = (cadu[off] & 0b111) << 8 | cadu[off + 1]
    return fhp, cadu[off + 2:]


class Demuxer:
    """Reassemble Space Packets from per-VCID M-PDU payloads
    (behavioral port of ccsds_aos/demuxer.cpp:12-199, incl. headers split
    across CADUs and multiple packets per M-PDU). VCID filtering is the
    caller's job, as in the reference."""

    def __init__(self, mpdu_data_size: int = 884, has_insert_zone: bool = False,
                 insert_zone_size: int = 2, secondary_header_extends_pkt: bool = False):
        self.mpdu_data_size = mpdu_data_size
        self.has_insert_zone = has_insert_zone
        self.insert_zone_size = insert_zone_size
        self.sec_hdr_extends = secondary_header_extends_pkt
        self._working = False
        self._in_header = False
        self._hdr_buf = bytearray()
        self._pkt = CCSDSPacket()
        self._remaining = 0
        self._total_len = 0
        self._payload_len = 0

    # -- internals mirroring the reference state machine ---------------------
    def _read_packet(self, h) -> None:
        self._working = True
        self._pkt = CCSDSPacket(header=CCSDSHeader.parse(h))
        extra = 8 if (self.sec_hdr_extends
                      and self._pkt.header.secondary_header_flag) else 0
        self._payload_len = self._pkt.header.packet_length + 1 + extra
        self._total_len = self._payload_len + HEADER_LENGTH
        self._remaining = self._payload_len

    def _push(self, out: List[CCSDSPacket]) -> None:
        out.append(self._pkt)
        self._pkt = CCSDSPacket()
        self._remaining = 0
        self._working = False

    def _abort(self) -> None:
        self._working = False
        self._pkt = CCSDSPacket()
        self._remaining = 0

    def work(self, cadu) -> List[CCSDSPacket]:
        """Process one CADU; returns completed packets."""
        out: List[CCSDSPacket] = []
        cadu = bytes(cadu)
        fhp, data = parse_mpdu(cadu, self.has_insert_zone, self.insert_zone_size)
        M = self.mpdu_data_size
        data = data[:M]

        if fhp < 2047 and fhp >= M:  # corrupt pointer
            return out

        offset = 0
        if self._in_header:
            self._in_header = False
            need = HEADER_LENGTH - len(self._hdr_buf)
            self._hdr_buf += data[:need]
            offset = need
            self._read_packet(self._hdr_buf)

        if self._remaining > 0 and self._working:
            if fhp < 2047:
                to_write = min(fhp + 1 - offset, self._remaining) \
                    if self._remaining + offset > fhp + 1 else self._remaining
                self._pkt.payload += data[offset: offset + max(to_write, 0)]
                self._remaining = 0
            else:
                to_write = min(M - offset, self._remaining)
                self._pkt.payload += data[offset: offset + to_write]
                self._remaining -= to_write

        if self._remaining == 0 and self._working:
            self._push(out)

        if fhp < 2047:
            if fhp + HEADER_LENGTH < M:
                self._read_packet(data[fhp: fhp + HEADER_LENGTH])
                if M > fhp + self._total_len:
                    # first packet ends inside this M-PDU; walk the chain
                    self._pkt.payload += data[fhp + 6: fhp + 6 + self._payload_len]
                    self._remaining = 0
                    self._push(out)
                    nxt = fhp + self._total_len
                    while nxt < M:
                        if nxt + HEADER_LENGTH < M:
                            self._read_packet(data[nxt: nxt + HEADER_LENGTH])
                            to_write = min(self._remaining, M - (nxt + 6))
                            self._pkt.payload += data[nxt + 6: nxt + 6 + to_write]
                            self._remaining -= to_write
                        else:
                            self._in_header = True
                            self._hdr_buf = bytearray(data[nxt:M])
                            break
                        if self._remaining == 0 and self._working:
                            self._push(out)
                        nxt = nxt + self._total_len
                else:
                    if self._working:
                        to_write = min(self._remaining, M - (fhp + 6))
                        self._pkt.payload += data[fhp + 6: fhp + 6 + to_write]
                        self._remaining -= to_write
            elif fhp < M:
                self._in_header = True
                self._hdr_buf = bytearray(data[fhp:M])

        return out


# ---------------------------------------------------------------------------
# Timecode parsing (ref ccsds_time.cpp — CDS segmented day/ms/us format)
# ---------------------------------------------------------------------------
def parse_ccsds_time_full_raw(data, offset_s: int = 0, ms_scale: int = 1000,
                              us_of_ms_scale: int = 1000000) -> float:
    """CDS: 16-bit days + 32-bit milliseconds-of-day + 16-bit sub-ms.
    Returns Unix seconds (days since epoch + offset_s). The sub-ms field
    adds ``us / us_of_ms_scale`` seconds, matching the reference
    parseCCSDSTimeFullRaw (ccsds_time.cpp:22-29)."""
    d = bytes(data[:8])
    days = d[0] << 8 | d[1]
    ms = d[2] << 24 | d[3] << 16 | d[4] << 8 | d[5]
    us = d[6] << 8 | d[7]
    return (days * 86400.0 + ms / float(ms_scale)
            + us / float(us_of_ms_scale) + offset_s)


def parse_ccsds_time(pkt: CCSDSPacket, offset_s: int = 0,
                     ms_scale: int = 1000) -> float:
    """Timestamp from a packet's secondary header (first 8 payload bytes)."""
    return parse_ccsds_time_full_raw(pkt.payload, offset_s, ms_scale)


# epoch helper: TAI/day-segmented times commonly offset from 1958 or 2000
EPOCH_1958_TO_UNIX = -378691200  # seconds from 1958-01-01 to 1970-01-01
EPOCH_2000_TO_UNIX = 946684800   # seconds from 1970-01-01 to 2000-01-01


def crc_check_vertical_parity(pkt: CCSDSPacket) -> bool:
    """16-bit XOR vertical parity over header+payload vs the trailing word
    (ref ccsds.cpp:135-150, used by MetOp ASCAT/IASI timestamp gating)."""
    p = bytes(pkt.payload)
    if len(p) < 2:
        return False
    sent = p[-2] << 8 | p[-1]
    buf = bytes(pkt.header.raw[:6]) + p[:-2]
    words = np.frombuffer(buf[: len(buf) // 2 * 2], ">u2")
    checksum = int(np.bitwise_xor.reduce(words)) if len(words) else 0
    return checksum == sent
