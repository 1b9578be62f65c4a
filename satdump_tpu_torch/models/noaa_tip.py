"""NOAA POES TIP/AIP instrument readers: HIRS, AMSU-A, SEM.

Reference: plugins/noaa_metop_support/noaa/instruments/ — TIP frames are
104 bytes (16-bit sync 0xEDE2), 10 per second; HIRS element words live at
fixed byte positions and repack to 20 13-bit channel words per element
(hirs_reader.cpp:26-157); AMSU-A words are filtered byte pairs re-framed on
a 24-bit 0xFFFFFF sync into A1 (1240-byte) / A2 (312-byte) science frames
(amsu_reader.cpp:55-106); SEM demuxes 62 MEPED/TED counters by minor-frame
number (sem_reader.cpp:27-125). Radiometric calibration sequences (HIRS
space/blackbody, AMSU PRT polynomials) are not ported — counts are emitted
raw with the shared calibration framework left to presets.

Counterpart of satdump_tpu/models/noaa_tip.py (host NumPy, copied): the
NOAA TIP path and the MetOp AHRPT path (`AMSUReader.work_metop`) alike.
"""

from __future__ import annotations

import calendar
import time
from typing import List

import numpy as np

from satdump_tpu_torch.ccsds import crc_check_vertical_parity, parse_ccsds_time
from satdump_tpu_torch.ops.fec.codings_misc import SimpleDeframer

TIP_FRAME_SIZE = 104
TIP_ASM = 0xEDE2

# hirs_reader.h:49-51
HIRS_POSITIONS = np.array([16, 17, 22, 23, 26, 27, 30, 31, 34, 35, 38, 39,
                           42, 43, 54, 55, 58, 59, 62, 63, 66, 67, 70, 71,
                           74, 75, 78, 79, 82, 83, 84, 85, 88, 89, 92, 93])
HIRS_CHANNELS = np.array([0, 16, 1, 2, 12, 3, 17, 10, 18, 6, 7, 19, 9, 13,
                          5, 4, 14, 11, 15, 8])


class TIPTimeParser:
    """tip_time_parser.h — day-of-year clock against a year epoch."""

    def __init__(self, year_override: int = -1):
        year = year_override if year_override != -1 else time.gmtime().tm_year
        self.epoch = calendar.timegm((year, 1, 1, 0, 0, 0))

    def get(self, doy: int, millisec: int) -> float:
        return self.epoch + (doy - 1) * 86400 + millisec / 1000.0


def tip_timestamp(frame: np.ndarray, ttp: TIPTimeParser) -> float | None:
    """Day/milliseconds from minor frame 0 (hirs_reader.cpp:29-35)."""
    mf = ((int(frame[4]) & 1) << 8) | int(frame[5])
    if mf != 0:
        return None
    days = (int(frame[8]) << 1) | (int(frame[9]) >> 7)
    ms = ((int(frame[9]) & 7) << 24) | (int(frame[10]) << 16) \
        | (int(frame[11]) << 8) | int(frame[12])
    return ttp.get(days, ms)


class HIRSReader:
    """hirs_reader.cpp imaging path: 20 channels x 56 elements/line."""

    def __init__(self, year: int = -1):
        self.ttp = TIPTimeParser(year)
        self.last_timestamp = -1.0
        self.timestamps: List[float] = []
        self.line = 0
        self._rows: List[np.ndarray] = []
        self._wip = np.zeros((20, 56), np.uint16)
        self._aux = 0

    def work(self, frame: np.ndarray) -> None:
        mf = ((int(frame[4]) & 1) << 8) | int(frame[5])
        ts = tip_timestamp(frame, self.ttp)
        if ts is not None:
            self.last_timestamp = ts
        d = frame[HIRS_POSITIONS]
        elnum = ((int(d[2]) & 0x1F) << 1) | (int(d[3]) >> 7)
        encoder = int(d[0])
        if elnum < 56 and (int(d[35]) >> 1) & 1:
            self._aux += 1
            # 20x 13-bit words from bytes 3..35, skipping 2 leading bits
            bits = np.unpackbits(d[3:36].astype(np.uint8))
            w13 = np.asarray(
                bits[2: 2 + 260].reshape(20, 13)
                @ (1 << np.arange(12, -1, -1)), np.uint16)
            self._wip[HIRS_CHANNELS, 55 - elnum] = w13
            if encoder < 57 or encoder in (68, 156, 59, 99):
                # sign-magnitude decode (hirs_reader.cpp:67-81)
                v = self._wip[:, 55 - elnum].astype(np.int32)
                dec = np.where(v >> 12 == 1, (v & 0xFFF) + 4095,
                               np.abs(4096 - (v & 0xFFF)))
                self._wip[:, 55 - elnum] = dec.astype(np.uint16)
            current = ((int(frame[22]) & 0x1F) << 1) | (int(frame[23]) >> 7)
            if current == 55 or (encoder == 0 and self._aux > 10):
                self._rows.append(self._wip.copy())
                self.line += 1
                self._aux = 0
                t = self.last_timestamp + (mf // 64) * \
                    (6.4 if self.last_timestamp != -1 else 0)
                self.timestamps.append(-1 if t in self.timestamps else t)

    def get_channel(self, ch: int) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, 56), np.uint16)
        return np.stack([r[ch] for r in self._rows])


class AMSUReader:
    """amsu_reader.cpp work_noaa/work_A1/work_A2: 13+2 channels, 30 FOV."""

    def __init__(self):
        self.a1_def = SimpleDeframer(0xFFFFFF, 24, 9920, 0)
        self.a2_def = SimpleDeframer(0xFFFFFF, 24, 2496, 0)
        self.linesA1 = 0
        self.linesA2 = 0
        self.channels_a1: List[np.ndarray] = []
        self.channels_a2: List[np.ndarray] = []
        self.timestamps_a1: List[float] = []
        self.timestamps_a2: List[float] = []
        self.last_TIP_timestamp = -1.0

    @staticmethod
    def _filter_words(frame: np.ndarray, start: int, count: int
                      ) -> np.ndarray:
        out = []
        for j in range(0, count, 2):
            b0, b1 = int(frame[start + j]), int(frame[start + j + 1])
            if (b1 % 2 != 1) or b0 == 0xFF or b1 == 0xFF:
                out += [b0, b1]
        return np.array(out, np.uint8)

    def work_noaa(self, frame: np.ndarray) -> None:
        lines_since = int(frame[5]) & 3
        a2w = self._filter_words(frame, 34, 14)
        a1w = self._filter_words(frame, 8, 26)
        ts = self.last_TIP_timestamp \
            + (8 * lines_since if self.last_TIP_timestamp != -1 else 0)
        for f in self.a2_def.work(np.unpackbits(a2w)):
            self.channels_a2.append(self._work_a2(f))
            self.timestamps_a2.append(
                -1 if ts in self.timestamps_a2 else ts)
            self.linesA2 += 1
        for f in self.a1_def.work(np.unpackbits(a1w)):
            self.channels_a1.append(self._work_a1(f))
            self.timestamps_a1.append(
                -1 if ts in self.timestamps_a1 else ts)
            self.linesA1 += 1

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


class SEMReader:
    """sem_reader.cpp — 62 punctiform counter channels demuxed by minor
    frame number; values are complemented (0xFF / 0x0F for the 4-bit
    channels 46-49)."""

    def __init__(self, year: int = -1):
        self.ttp = TIPTimeParser(year)
        self.last_ts = -1.0
        self.channels: List[List[int]] = [[] for _ in range(62)]
        self.timestamps: List[List[float]] = [[] for _ in range(62)]

    def _push(self, ch: int, data: int, mf: int) -> None:
        self.channels[ch].append(data ^ (0x0F if 45 < ch < 50 else 0xFF))
        self.timestamps[ch].append(
            self.last_ts + mf / 10.0 if self.last_ts != -1 else -1)

    def work(self, frame: np.ndarray) -> None:
        mf = ((int(frame[4]) & 1) << 8) | int(frame[5])
        if mf > 319:
            return
        ts = tip_timestamp(frame, self.ttp)
        if ts is not None:
            self.last_ts = ts
        mf20 = mf % 20
        w0, w1 = int(frame[20]), int(frame[21])
        if mf20 == 10:                       # MEPED
            self._push(19, w0, mf)
            self._push(20 if (mf + 10) % 40 == 0 else 21, w1, mf)
        elif mf20 == 0:
            self._push(0, w1, mf)
        elif 0 < mf20 < 10:
            self._push(2 * mf20 - 1, w0, mf)
            self._push(2 * mf20, w1, mf)
        elif mf20 in (11, 12) and mf // 20 < 14:    # TED 4-PES
            n = (((mf20 - 11) * 2 + 4 * (mf // 20)) % 16) + 22
            self._push(n, w0, mf)
            self._push(n + 1, w1, mf)
        elif mf20 > 12 and mf < 17:                 # TED flux
            n = 2 * (mf20 - 13) + 38
            self._push(n, w0, mf)
            self._push(n + 1, w1, mf)
        elif mf20 == 17:
            self._push(46, w0 >> 4, mf)
            self._push(48, w0 & 0x0F, mf)
            self._push(50, w1, mf)
        elif mf20 == 18:
            self._push(52, w0, mf)
            self._push(47, w1 >> 4, mf)
            self._push(49, w1 & 0x0F, mf)
        elif mf20 == 19:
            self._push(51, w0, mf)
            self._push(53, w1, mf)
        # TED background (absolute minor-frame slots)
        if mf == 292:
            self._push(54, w0, mf)
            self._push(55, w1, mf)
        elif mf in (311, 312):
            self._push(mf - 255, w1, mf)
        elif mf == 291:
            self._push(58, w0, mf)
            self._push(60, w1, mf)
        elif mf == 280:
            self._push(59, w0, mf)
        elif mf == 300:
            self._push(61, w0, mf)
