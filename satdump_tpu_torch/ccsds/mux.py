"""CCSDS mux (TX side): Space Packets -> M-PDUs -> CADUs.

The inverse of the Demuxer, used by the loopback test fixtures (SURVEY.md §4:
the reference has no TX mux; we need one to make the demux/instrument readers
testable without recorded downlinks) and by any future TX path.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from satdump_tpu_torch.ccsds import CCSDSPacket


def serialize_packet(pkt: CCSDSPacket) -> bytes:
    hdr = pkt.header
    hdr.packet_length = len(pkt.payload) - 1
    return hdr.encode() + bytes(pkt.payload)


def mux_packets(packets: Iterable[CCSDSPacket], mpdu_data_size: int = 884,
                fill: int = 0x00) -> List[Tuple[int, bytes]]:
    """Pack packets back-to-back into M-PDU data zones.

    Returns a list of (first_header_pointer, data_zone) tuples; the tail is
    padded with an idle filler. FHP semantics follow mpdu.cpp: byte offset of
    the first packet header starting in this zone, 2047 if none.
    """
    stream = bytearray()
    starts = []
    for p in packets:
        starts.append(len(stream))
        stream += serialize_packet(p)

    M = mpdu_data_size
    n_zones = (len(stream) + M - 1) // M
    stream += bytes([fill]) * (n_zones * M - len(stream))

    zones = []
    si = 0
    for z in range(n_zones):
        lo, hi = z * M, (z + 1) * M
        while si < len(starts) and starts[si] < lo:
            si += 1
        fhp = starts[si] - lo if si < len(starts) and starts[si] < hi else 2047
        zones.append((fhp, bytes(stream[lo:hi])))
    return zones


def make_cadus_for_vcid(packets: Iterable[CCSDSPacket], vcid: int,
                        scid: int = 0x0C, mpdu_data_size: int = 884,
                        has_insert_zone: bool = False,
                        insert_zone_size: int = 2,
                        total_size: int = 0) -> np.ndarray:
    """Build plain (unrandomized, no RS parity) CADUs: ASM + VCDU header +
    [insert zone +] M-PDU header + data zone. Shape (n, 12 + iz +
    mpdu_data_size) uint8, zero-padded to ``total_size`` if given (e.g.
    1024 to leave room where the RS check symbols would sit)."""
    zones = mux_packets(packets, mpdu_data_size)
    iz = insert_zone_size if has_insert_zone else 0
    width = max(12 + iz + mpdu_data_size, total_size)
    out = np.zeros((len(zones), width), np.uint8)
    for i, (fhp, data) in enumerate(zones):
        out[i, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
        out[i, 4] = (1 << 6) | ((scid >> 2) & 0b111111)
        out[i, 5] = ((scid & 0b11) << 6) | (vcid & 0b111111)
        out[i, 6:9] = [(i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF]
        out[i, 9] = 0
        out[i, 10 + iz] = (fhp >> 8) & 0b111
        out[i, 11 + iz] = fhp & 0xFF
        out[i, 12 + iz: 12 + iz + mpdu_data_size] = \
            np.frombuffer(data, np.uint8)
    return out
