"""AMSU-A reader of the NOAA/MetOp instruments.

Reference: plugins/noaa_metop_support/noaa/instruments/amsu/amsu_reader.cpp.
Only the MetOp AHRPT path is carried here (packets of APID 39 = A1 and 40 =
A2, `work_metop`); the NOAA TIP/AIP path (`work_noaa`, its 24-bit
re-framing) and the HIRS and SEM readers come with the NOAA HRPT slice.
"""

from __future__ import annotations

from typing import List

import numpy as np

from satdump_tpu_torch.ccsds import crc_check_vertical_parity, parse_ccsds_time


class AMSUReader:
    """amsu_reader.cpp work_metop/work_A1/work_A2: 13+2 channels, 30 FOV."""

    def __init__(self):
        self.linesA1 = 0
        self.linesA2 = 0
        self.channels_a1: List[np.ndarray] = []
        self.channels_a2: List[np.ndarray] = []
        self.timestamps_a1: List[float] = []
        self.timestamps_a2: List[float] = []

    def work_metop(self, pkt) -> None:
        """MetOp AHRPT AMSU packets (amsu_reader.cpp:108-147): APID 39 (A1)
        / 40 (A2); 16-bit words at payload[14..] (skipping the 13-byte
        header, offset by one as the reference reads [i+1],[i+2]) filtered
        for the idle word 0x0001, then the standard line parsers."""
        p = bytes(pkt.payload)
        want = 2096 if pkt.header.apid == 39 else 1136
        if pkt.header.apid not in (39, 40) or len(p) != want:
            return
        filtered = bytearray()
        for i in range(13, len(p) - 2, 2):
            word = (p[i + 1] << 8) | p[i + 2]
            if word != 1:
                filtered.append(word >> 8)
                filtered.append(word & 0xFF)
        f = np.frombuffer(bytes(filtered), np.uint8)
        ts = parse_ccsds_time(pkt, 10957 * 86400) \
            if crc_check_vertical_parity(pkt) else -1.0
        if pkt.header.apid == 39:
            if len(f) < 1040:
                return
            self.channels_a1.append(self._work_a1(f))
            self.timestamps_a1.append(ts)
            self.linesA1 += 1
        else:
            if len(f) < 256:
                return
            self.channels_a2.append(self._work_a2(f))
            self.timestamps_a2.append(ts)
            self.linesA2 += 1

    @staticmethod
    def _work_a1(f: np.ndarray) -> np.ndarray:
        """(13, 30) counts (amsu_reader.cpp:22-37)."""
        w = f.astype(np.uint16)
        out = np.zeros((13, 30), np.uint16)
        idx = np.arange(0, 1020, 34)
        for j in range(13):
            out[j] = (w[idx + 16 + 2 * j] << 8) | w[idx + 16 + 2 * j + 1]
        return out

    @staticmethod
    def _work_a2(f: np.ndarray) -> np.ndarray:
        """(2, 30) counts (amsu_reader.cpp:39-45; the reference's ch-2 low
        byte reads buffer[14+i] twice — an evident typo, we take 15+i)."""
        w = f.astype(np.uint16)
        idx = np.arange(0, 240, 8)
        return np.stack([(w[idx + 12] << 8) | w[idx + 13],
                         (w[idx + 14] << 8) | w[idx + 15]])

    def get_channel_a1(self, ch: int) -> np.ndarray:
        if not self.channels_a1:
            return np.zeros((0, 30), np.uint16)
        return np.stack([c[ch] for c in self.channels_a1])

    def get_channel_a2(self, ch: int) -> np.ndarray:
        if not self.channels_a2:
            return np.zeros((0, 30), np.uint16)
        return np.stack([c[ch] for c in self.channels_a2])
