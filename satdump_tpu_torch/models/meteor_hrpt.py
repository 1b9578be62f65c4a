"""METEOR-M HRPT chain: .soft (PM demod) -> CADUs -> MSU-MR products.

Reference: plugins/meteor_support/meteor/ — module_meteor_hrpt_decoder
(bit-serial CADU deframer with inversion handling, deframer.cpp) and
module_meteor_instruments HRPT mode: per-CADU byte slices feed SimpleDeframers
for BIS-M telemetry (sync 0x71DE2CD8, 88 bytes), MSU-MR (64-bit sync
0x0218a7a392dd9abf, 11850 bytes) and MTVZA; the MSU-MR reader unpacks 6
channels x 1572 10-bit pixels per line (msumr_reader.cpp:22-61) and
timestamps come from the BIS-M Moscow-day clock + per-line H/M/S bytes.

Deframing is correlate-everywhere (shared SimpleDeframer); the 10-bit
unpack is one unpackbits+matmul over the whole line, all channels at once.

Counterpart of satdump_tpu/models/meteor_hrpt.py (host NumPy, copied).
BIS-M's epoch reads the wall clock's year unless `year_override` is given,
so outputs compare between runs only with it set."""

from __future__ import annotations

import calendar
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.geo.raytrace import load_proj_settings
from satdump_tpu_torch.ops.fec.codings_misc import SimpleDeframer
from satdump_tpu_torch.ops.fec.deframer import CCSDSDeframer
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet

CADU_SIZE = 1024
MSUMR_SYNC = 0x0218A7A392DD9ABF
MSUMR_FRAME = 11850
BISM_SYNC = 0x71DE2CD8
BISM_FRAME = 88
MTVZA_SYNC = 0xFB386A45
MTVZA_FRAME = 248

# per-CADU byte slices (module_meteor_instruments.cpp:64-122, 1-indexed ref)
_BISM_SLICES = [(6, 4), (262, 4), (518, 4), (774, 4)]
_MSUMR_SLICES = [(22, 238), (278, 238), (534, 238), (790, 234)]
_MTVZA_SLICES = [(14, 8), (270, 8), (526, 8), (782, 8)]

SAT_NAMES = {0: "METEOR-M2", 1: "METEOR-M2-1", 2: "METEOR-M2-2",
             3: "METEOR-M2-3", 4: "METEOR-M2-4"}
NORADS = {0: 40069, 1: 0, 2: 44387, 3: 57166, 4: 59051}

# msumr/offsets.h channel-4 x offsets per serial
X_OFFSETS = {3: {3: (-1.6, -1.6)}, 4: {3: (-2.0, 0.0)}}


@register_module
class MeteorHRPTDecoderModule(ProcessingModule):
    """soft -> .cadu (uncoded 1024-byte CADUs, both polarities tried)."""

    id = "meteor_hrpt_decoder"

    def process(self):
        out_path = self.d_output_file_hint + ".cadu"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        nframes = 0
        deframers = [CCSDSDeframer(CADU_SIZE * 8), CCSDSDeframer(CADU_SIZE * 8)]
        with open(out_path, "wb") as f:
            frames_n = deframers[0].work(bits)
            frames_i = deframers[1].work(1 - bits)
            frames = frames_n if len(frames_n) >= len(frames_i) else frames_i
            for frm in frames:
                f.write(frm.tobytes())
                nframes += 1
        self.stats = {"frame_count": nframes,
                      "deframer_state": "SYNCED" if nframes else "NOSYNC"}
        logger.info(f"METEOR HRPT: {nframes} CADUs")


def _unpack_10bit(data: np.ndarray) -> np.ndarray:
    """5-byte groups -> 4x 10-bit words, vectorized."""
    bits = np.unpackbits(np.asarray(data, np.uint8))
    n = (len(bits) // 10)
    w = (np.int64(2) ** np.arange(9, -1, -1)).astype(np.int64)
    return (bits[: n * 10].reshape(n, 10) @ w).astype(np.uint16)


class MSUMRHRPTReader:
    """msumr_reader.cpp:22-61 — 6 channels, 1572 px/line, values << 6."""

    def __init__(self):
        self.lines = 0
        self._rows = []
        self.calibration = []
        self.telemetry_calib: List[Optional[dict]] = []

    def work(self, frame: np.ndarray) -> None:
        data = frame[50: 50 + 393 * 30].reshape(393, 30)
        row = np.empty((6, 1572), np.uint16)
        for ch in range(6):
            row[ch] = _unpack_10bit(data[:, ch * 5: (ch + 1) * 5]
                                    .reshape(-1)) << 6
        self._rows.append(row)
        self.calibration.append(_unpack_10bit(frame[35: 50]))
        self.telemetry_calib.append(parse_msumr_analog_tlm(frame))
        self.lines += 1

    def get_channel(self, ch: int) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, 1572), np.uint16)
        return np.stack([r[ch] for r in self._rows])

    def views(self) -> list:
        """calibration_info shape for meteor_msumr: [ch][2][lines]
        (module_meteor_instruments.cpp:251)."""
        return [[[int(w[ch * 2 + lv]) for w in self.calibration]
                 for lv in range(2)] for ch in range(6)]


def parse_msumr_analog_tlm(frame: np.ndarray) -> Optional[dict]:
    """Analog telemetry line (msumr_tlm.h HRPT mode, frame[13]==0x0F):
    hot/cold body temperatures decoded as -(int8)b * 0.5 + 273.15 with the
    METEOR-M2-2 +40 K patch (mid == 2)."""
    if int(frame[13]) != 0b00001111:
        return None
    mid = int(frame[12]) >> 4
    patch = 40.0 if mid == 2 else 0.0

    def temp(i):                       # bytes 14+i, i in 8..13
        v = int(np.int8(frame[14 + i]))
        return -v * 0.5 + 273.15

    return {"analog_tlm": {
        "cold_temp1": temp(10) + patch, "cold_temp2": temp(9) + patch,
        "cold_temp3": temp(8) + patch,
        "hot_temp1": temp(13), "hot_temp2": temp(12), "hot_temp3": temp(11),
    }}


class BISMReader:
    """bism_reader.cpp — Moscow-clock telemetry. The epoch is Dec 31 before
    the most recent leap year relative to the (overridable) current year."""

    def __init__(self, year_override: int = -1):
        t = time.gmtime()
        year = year_override if year_override != -1 else t.tm_year
        year -= (year % 4) + 1
        self.timestamp_offset = calendar.timegm(
            (year, 12, 31, 0, 0, 0, 0, 0, 0)) - 1
        self.clock_times: List[float] = []

    def work(self, frame: np.ndarray) -> None:
        if int(frame[4]) in (0, 255):
            t = (int(frame[9]) << 24 | int(frame[8]) << 16
                 | int(frame[7]) << 8 | int(frame[6]))
            self.clock_times.append(self.timestamp_offset + t)

    def get_last_day_moscow(self) -> float:
        if not self.clock_times:
            return 0.0
        return self.clock_times[-1] - (self.clock_times[-1] % 86400)


class MTVZAReader:
    """MTVZA-GY microwave sounder (mtvza_reader.cpp): 248-byte frames, scan
    counters 2..26, each frame carrying 8 of 200 scan positions for 30
    channels (5 low-res + 2 full-res + 23 medium-res sample layouts).
    `endian_mode=True` handles the byte-swapped M2-3/M2-4 format."""

    def __init__(self, endian_mode: bool = False):
        self.endian = endian_mode
        self.lines = 0
        self.timestamps: List[float] = []
        self.latest_msumr_timestamp = -1.0
        self._rows: List[np.ndarray] = [np.zeros((30, 100), np.uint16)]

    def _parse(self, data: np.ndarray, ch_start: int, offset: int,
               ch_cnt: int, nsamples: int, counter: int) -> None:
        row = self._rows[-1]
        for ch in range(ch_cnt):
            for i in range(4):
                pos = ch * nsamples + offset
                if nsamples == 2:
                    pos += i // 2
                elif nsamples == 4:
                    pos += i
                hi, lo = (0, 1) if self.endian else (1, 0)
                v1 = (int(data[8 + pos * 2 + hi]) << 8
                      | int(data[8 + pos * 2 + lo]))
                v2 = (int(data[128 + pos * 2 + hi]) << 8
                      | int(data[128 + pos * 2 + lo]))
                col = counter * 8
                if col + i < 100:
                    row[ch_start + ch, col + i] = (v1 - 32768) & 0xFFFF
                if col + 4 + i < 100:
                    row[ch_start + ch, col + 4 + i] = (v2 - 32768) & 0xFFFF

    def work(self, data: np.ndarray) -> None:
        data = np.asarray(data, np.uint8)
        marker = int(data[5] if self.endian else data[4])
        if marker != 255:
            return
        counter = int(data[4] if self.endian else data[5])
        if counter > 26 or counter < 2:
            return
        self._parse(data, 0, 0, 5, 1, counter - 2)
        self._parse(data, 5, 5, 2, 4, counter - 2)
        self._parse(data, 7, 13, 23, 2, counter - 2)
        if counter == 26:
            self.timestamps.append(self.latest_msumr_timestamp)
            self.lines += 1
            self._rows.append(np.zeros((30, 100), np.uint16))

    def get_channel(self, ch: int) -> np.ndarray:
        if self.lines == 0:
            return np.zeros((0, 100), np.uint16)
        return np.stack([r[ch] for r in self._rows[: self.lines]])


@register_module
class MeteorInstrumentsModule(ProcessingModule):
    id = "meteor_instruments"

    def process(self):
        directory = str(Path(self.d_output_file_hint).parent)
        Path(directory).mkdir(parents=True, exist_ok=True)
        self.d_output_file = directory
        year_ov = int(self.param("year_override", -1))

        msumr_def = SimpleDeframer(MSUMR_SYNC, 64, MSUMR_FRAME * 8, 10)
        bism_def = SimpleDeframer(BISM_SYNC, 32, BISM_FRAME * 8, 0)
        mtvza_def = SimpleDeframer(MTVZA_SYNC, 32, MTVZA_FRAME * 8, 0)
        mtvza_def2 = SimpleDeframer(0x38FB456A, 32, MTVZA_FRAME * 8, 0)
        msumr = MSUMRHRPTReader()
        bism = BISMReader(year_ov)
        mtvza = MTVZAReader(endian_mode=False)
        mtvza2 = MTVZAReader(endian_mode=True)
        timestamps: List[float] = []
        ids: List[int] = []

        cadus = np.fromfile(self.d_input_file, np.uint8)
        n = len(cadus) // CADU_SIZE
        for i in range(n):
            cadu = cadus[i * CADU_SIZE: (i + 1) * CADU_SIZE]
            bism_data = np.concatenate(
                [cadu[o: o + ln] for o, ln in _BISM_SLICES])
            for frm in bism_def.work(np.unpackbits(bism_data)):
                bism.work(frm)
            msumr_data = np.concatenate(
                [cadu[o: o + ln] for o, ln in _MSUMR_SLICES])
            for frm in msumr_def.work(np.unpackbits(msumr_data)):
                day = bism.get_last_day_moscow()
                if day:
                    ts = day + int(frm[8]) * 3600 + int(frm[9]) * 60 \
                        + int(frm[10]) + int(frm[11]) / 255.0 - 3 * 3600
                else:
                    ts = -1.0
                timestamps.append(ts)
                mtvza.latest_msumr_timestamp = ts
                mtvza2.latest_msumr_timestamp = ts
                ids.append(int(frm[12]) >> 4)
                msumr.work(frm)
            mtvza_data = np.concatenate(
                [cadu[o: o + ln] for o, ln in _MTVZA_SLICES])
            mtvza_bits = np.unpackbits(mtvza_data)
            for frm in mtvza_def.work(mtvza_bits):
                mtvza.work(frm)
            for frm in mtvza_def2.work(mtvza_bits):
                mtvza2.work(frm)

        serial = int(np.bincount(ids).argmax()) if ids else -1
        sat_name = SAT_NAMES.get(serial, "Unknown Meteor")
        valid_ts = [t for t in timestamps if t > 0]
        dataset = DataSet(satellite_name=sat_name,
                          timestamp=float(np.median(valid_ts))
                          if valid_ts else 0.0)
        logger.info(f"MSU-MR (HRPT) lines: {msumr.lines} sat: {sat_name}")
        if msumr.lines:
            prod = ImageProduct()
            prod.instrument_name = "msu_mr"
            prod.set_product_timestamp(dataset.timestamp)
            prod.set_product_source(sat_name)
            # wavenumbers + per-satellite visible coefficients
            # (resources/calibration/MSU-MR.json, ref :239-260)
            import json as _json
            _res = Path(__file__).resolve().parent.parent.parent / \
                "resources" / "calibration" / "MSU-MR.json"
            try:
                msu_cfg = _json.load(open(_res))
            except Exception:
                msu_cfg = {"wavenumbers": [0.0] * 6, "vis": {}}
            for ch in range(6):
                prod.add_channel(msumr.get_channel(ch), str(ch + 1),
                                 bit_depth=10,
                                 wavenumber=msu_cfg["wavenumbers"][ch])
            calib_cfg = {"vars": {
                "lrpt": False,
                "views": msumr.views(),
                "temps": msumr.telemetry_calib,
            }}
            if sat_name in msu_cfg.get("vis", {}):
                calib_cfg["vars"]["vis"] = msu_cfg["vis"][sat_name]
            prod.set_calibration("meteor_msumr", calib_cfg)
            prod.contents["timestamps"] = timestamps
            prod.contents["norad"] = NORADS.get(serial, 0)
            pdir = str(Path(directory) / "MSU-MR")
            prod.save(pdir)
            dataset.products_list.append("MSU-MR")

        # MTVZA: keep whichever endianness decoded more lines
        # (module_meteor_instruments.cpp:276)
        mreader = mtvza2 if mtvza2.lines > mtvza.lines else mtvza
        if mreader.lines:
            mp = ImageProduct()
            mp.instrument_name = "mtvza"
            mp.set_product_timestamp(dataset.timestamp)
            mp.set_product_source(sat_name)
            for ch in range(30):
                mp.add_channel(mreader.get_channel(ch), str(ch + 1),
                               bit_depth=16)
            mp.contents["timestamps"] = mreader.timestamps
            mp.contents["norad"] = NORADS.get(serial, 0)
            mp.set_proj_cfg_tle_timestamps(
                load_proj_settings("meteor_mtvza",
                                   norad=NORADS.get(serial, 0)),
                {"name": sat_name, "norad": NORADS.get(serial, 0)},
                mreader.timestamps)
            mp.save(str(Path(directory) / "MTVZA"))
            dataset.products_list.append("MTVZA")

        dataset.save(directory)
        self.stats = {"msumr_lines": msumr.lines, "mtvza_lines": mreader.lines,
                      "satellite": sat_name}
