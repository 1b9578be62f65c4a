"""Generic table-driven CRC (ref src-core/common/codings/crc/crc_generic.cpp,
common/ccsds/ccsds.h:60 CRC-CCITT)."""

from __future__ import annotations

import numpy as np


def _make_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & top) else (crc << 1)
        table[byte] = crc & mask
    return table


class CRC:
    def __init__(self, poly: int, width: int = 16, init: int = 0xFFFF,
                 xorout: int = 0):
        self.width = width
        self.init = init
        self.xorout = xorout
        self.mask = (1 << width) - 1
        self.table = _make_table(poly, width)

    def compute(self, data: bytes | np.ndarray) -> int:
        data = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
        crc = self.init
        for b in data:
            crc = ((crc << 8) ^ int(self.table[((crc >> (self.width - 8)) ^ b) & 0xFF])) & self.mask
        return crc ^ self.xorout


# CRC-CCITT FALSE, used for CCSDS packet CRC (ccsds.h:60)
crc_ccitt = CRC(poly=0x1021, width=16, init=0xFFFF)
