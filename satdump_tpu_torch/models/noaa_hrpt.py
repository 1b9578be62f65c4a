"""NOAA POES HRPT chain: .soft (PM demod) -> minor frames -> AVHRR products.

Reference: plugins/noaa_metop_support/noaa/ — NOAADeframer (60-bit minor
frame sync 0x0A116FD719D83C95, 11090 10-bit words, noaa_deframer.cpp),
module_noaa_hrpt_decoder (soft bits -> uint16 word frames) and
module_noaa_instruments (AVHRR at word 750, timestamp words 8-11,
avhrr_reader.cpp work_noaa). Deframing is correlate-everywhere + batched
10-bit repack instead of the reference's per-bit state machine.

Counterpart of satdump_tpu/models/noaa_hrpt.py (host NumPy, copied): the
demods in front of these modules (`pm_demod`, `psk_demod`) run on the
pipeline's `torch_device`; these modules take none."""

from __future__ import annotations

import calendar
import time
from pathlib import Path
from typing import List

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.models.metop import AVHRR_WAVENUMBERS
from satdump_tpu_torch.models.noaa_tip import AMSUReader, HIRSReader, SEMReader
from satdump_tpu_torch.ops.fec.codings_misc import SimpleDeframer
from satdump_tpu_torch.ops.fec.deframer import CCSDSDeframer, correlate_bits
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.products.punctiform_product import PunctiformProduct

HRPT_SYNC = 0x0A116FD719D83C95
SYNC_BITS = 60
FRAME_WORDS = 11090
FRAME_BITS = FRAME_WORDS * 10
SYNC_WORDS = (0x0284, 0x016F, 0x035C, 0x019D, 0x020F, 0x0095)


def _sync_pattern() -> np.ndarray:
    return ((HRPT_SYNC >> np.arange(SYNC_BITS - 1, -1, -1)) & 1
            ).astype(np.uint8)


class NOAADeframer:
    """Hard-bit HRPT minor-frame deframer, streaming."""

    def __init__(self, threshold: int = 4):
        self.threshold = threshold
        self.pattern = _sync_pattern()
        self._tail = np.zeros(0, np.uint8)
        self.frames = 0

    def work(self, bits: np.ndarray) -> List[np.ndarray]:
        stream = np.concatenate([self._tail, np.asarray(bits, np.uint8)])
        if len(stream) < SYNC_BITS:
            self._tail = stream
            return []
        dist = correlate_bits(stream, self.pattern)
        hits = np.flatnonzero(dist <= self.threshold)
        out: List[np.ndarray] = []
        pos = 0
        for h in hits:
            if h < pos:
                continue
            if h + FRAME_BITS <= len(stream):
                fb = stream[h: h + FRAME_BITS]
                words = (fb.reshape(FRAME_WORDS, 10)
                         << np.arange(9, -1, -1)).sum(axis=1
                                                      ).astype(np.uint16)
                words[:6] = SYNC_WORDS   # nominal sync (ref enter_synced)
                out.append(words)
                pos = h + FRAME_BITS
            else:
                pos = max(pos, h)
                break
        keep = len(stream) - pos
        keep = min(keep, FRAME_BITS + SYNC_BITS)
        self._tail = stream[len(stream) - keep:]
        self.frames += len(out)
        return out


@register_module
class NOAAHRPTDecoderModule(ProcessingModule):
    """soft -> .frm of 11090 uint16 words per minor frame
    (ref module_noaa_hrpt_decoder.cpp)."""

    id = "noaa_hrpt_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.threshold = int(self.param("deframer_thresold", 10))
        self.block = int(self.param("buffer_size", 0) or (1 << 22))

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        deframer = NOAADeframer(self.threshold)
        soft = np.fromfile(self.d_input_file, np.int8)
        n = 0
        with open(out_path, "wb") as f:
            for off in range(0, len(soft), self.block):
                bits = (soft[off: off + self.block] > 0).astype(np.uint8)
                for words in deframer.work(bits):
                    f.write(words.astype("<u2").tobytes())
                    n += 1
        self.stats = {"frames": n}
        logger.info(f"NOAA HRPT: {n} minor frames")


class AVHRRReaderHRPT:
    """AVHRR lines from HRPT/GAC minor frames (avhrr_reader.cpp
    work_noaa/line2image)."""

    WIDTH = 2048

    def __init__(self, gac_mode: bool = False, year: int = 2021):
        self.pos = 1182 if gac_mode else 750
        self.width = 409 if gac_mode else 2048
        self.year = year
        self._lines: List[np.ndarray] = []
        self._ch3a: List[bool] = []
        self.timestamps: List[float] = []

    @property
    def lines(self) -> int:
        return len(self._lines)

    def work_noaa(self, words: np.ndarray) -> None:
        words = np.asarray(words, np.uint16)
        day_of_year = int(words[8]) >> 1
        ms = ((int(words[9]) & 0x7F) << 20) | (int(words[10]) << 10) \
            | int(words[11])
        base = calendar.timegm((self.year, 1, 1, 0, 0, 0))
        self.timestamps.append(base + (day_of_year - 1) * 86400.0
                               + ms / 1000.0)
        img = words[self.pos: self.pos + self.width * 5]
        if len(img) < self.width * 5:
            return
        self._lines.append(img.reshape(self.width, 5).astype(np.uint16))
        self._ch3a.append(bool(int(words[6]) & 1))

    def channels(self) -> List[np.ndarray]:
        n = len(self._lines)
        chans = [np.zeros((n, self.width), np.uint16) for _ in range(6)]
        if n == 0:
            return chans
        img = np.stack(self._lines) << 6
        ch3a = np.asarray(self._ch3a)
        for slot in range(5):
            out_a = slot + (1 if slot > 2 else 0)
            out_b = slot + (1 if slot > 1 else 0)
            if out_a == out_b:
                chans[out_a] = img[:, :, slot]
            else:
                chans[out_a][ch3a] = img[ch3a, :, slot]
                chans[out_b][~ch3a] = img[~ch3a, :, slot]
        return chans


def extract_tip_frames(words: np.ndarray) -> tuple[int, list]:
    """TIP/AIP frames embedded in an HRPT minor frame: frmnum 1 = TIP,
    3 = AIP; 5 frames of 104 10-bit words >> 2 starting at word 103
    (module_noaa_instruments.cpp:52-77)."""
    frmnum = (int(words[6]) >> 7) & 3
    if frmnum not in (1, 3):
        return frmnum, []
    block = (words[103: 103 + 5 * 104] >> 2).astype(np.uint8)
    return frmnum, [block[i * 104: (i + 1) * 104] for i in range(5)]


@register_module
class NOAAInstrumentsDecoderModule(ProcessingModule):
    """HRPT minor frames -> AVHRR/HIRS/AMSU/SEM products + DataSet
    (ref module_noaa_instruments.cpp). dsb_mode consumes raw 104-byte TIP
    frames (the DSB downlink) and emits the TIP instruments only."""

    id = "noaa_instruments"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.gac = bool(self.param("gac_mode", False))
        self.dsb = bool(self.param("dsb_mode", False))
        # -1 (the NOAA pipelines' own default) is this year, as the TIP
        # readers take it; the JAX module passes it on as year -1, which
        # the AVHRR reader's calendar.timegm refuses
        self.year = int(self.param("year_override", 2021))
        if self.year == -1:
            self.year = time.gmtime().tm_year
        self.sat_name = str(self.param("satellite", "NOAA"))

    def process(self):
        reader = AVHRRReaderHRPT(self.gac, self.year)
        hirs = HIRSReader(self.year)
        sem = SEMReader(self.year)
        amsu = AMSUReader()
        if self.dsb:
            tips = np.fromfile(self.d_input_file, np.uint8)
            for i in range(len(tips) // 104):
                tip = tips[i * 104: (i + 1) * 104]
                hirs.work(tip)
                sem.work(tip)
        elif self.gac:
            # GAC frames: 4159 bytes -> 3327 10-bit words; TIP subframes
            # 1-5, AIP 6-10 (module_noaa_instruments.cpp:85-108)
            raw = np.fromfile(self.d_input_file, np.uint8)
            nfr = len(raw) // 4159
            for i in range(nfr):
                fb = np.unpackbits(raw[i * 4159: (i + 1) * 4159])
                nw = len(fb) // 10
                words = (fb[: nw * 10].reshape(nw, 10)
                         << np.arange(9, -1, -1)).sum(axis=1) \
                    .astype(np.uint16)
                reader.work_noaa(words)
                block = (words[103: 103 + 10 * 104] >> 2).astype(np.uint8)
                for k in range(5):
                    tip = block[k * 104: (k + 1) * 104]
                    hirs.work(tip)
                    sem.work(tip)
                    amsu.last_TIP_timestamp = hirs.last_timestamp
                for k in range(5, 10):
                    amsu.work_noaa(block[k * 104: (k + 1) * 104])
        else:
            raw = np.fromfile(self.d_input_file, "<u2")
            nfr = len(raw) // FRAME_WORDS
            for i in range(nfr):
                words = raw[i * FRAME_WORDS:(i + 1) * FRAME_WORDS]
                reader.work_noaa(words)
                frmnum, tipfrm = extract_tip_frames(words)
                for tip in tipfrm:
                    if frmnum == 1:
                        hirs.work(tip)
                        sem.work(tip)
                        amsu.last_TIP_timestamp = hirs.last_timestamp
                    else:
                        amsu.work_noaa(tip)
        logger.info(f"NOAA instruments: AVHRR {reader.lines} lines, "
                    f"HIRS {hirs.line}, AMSU {amsu.linesA1}/{amsu.linesA2}")

        out_dir = Path(self.d_output_file_hint).parent
        out_dir.mkdir(parents=True, exist_ok=True)
        all_ts = reader.timestamps or [t for t in hirs.timestamps if t > 0]
        ds = DataSet(self.sat_name, float(np.median(all_ts))
                     if all_ts else -1.0)
        if reader.lines:
            p = ImageProduct()
            p.instrument_name = "avhrr_3"
            names = ["1", "2", "3a", "3b", "4", "5"]
            for i, ch in enumerate(reader.channels()):
                p.add_channel(ch, names[i], bit_depth=16,
                              wavenumber=AVHRR_WAVENUMBERS[i])
            calib = self.param("avhrr_calib")
            if calib:
                p.set_calibration("noaa_avhrr3", dict(calib))
            p.save(str(out_dir / "AVHRR"))
            ds.products_list.append("AVHRR")
        if hirs.line:
            p = ImageProduct()
            p.instrument_name = "hirs"
            for ch in range(20):
                p.add_channel(hirs.get_channel(ch), str(ch + 1),
                              bit_depth=13)
            p.contents["timestamps"] = hirs.timestamps
            p.save(str(out_dir / "HIRS"))
            ds.products_list.append("HIRS")
        if amsu.linesA1 or amsu.linesA2:
            p = ImageProduct()
            p.instrument_name = "amsu_a"
            for ch in range(2):
                p.add_channel(amsu.get_channel_a2(ch), str(ch + 1),
                              bit_depth=16)
            for ch in range(13):
                p.add_channel(amsu.get_channel_a1(ch), str(ch + 3),
                              bit_depth=16)
            p.contents["timestamps_a1"] = amsu.timestamps_a1
            p.contents["timestamps_a2"] = amsu.timestamps_a2
            p.save(str(out_dir / "AMSU"))
            ds.products_list.append("AMSU")
        if any(sem.channels):
            p = PunctiformProduct()
            p.instrument_name = "sem"
            for ch in range(62):
                if sem.channels[ch]:
                    p.add_channel(str(ch), sem.timestamps[ch],
                                  [(0.0, 0.0)] * len(sem.channels[ch]),
                                  sem.channels[ch])
            p.save(str(out_dir / "SEM"))
            ds.products_list.append("SEM")
        self.d_output_file = ds.save(str(out_dir))
        self.stats = {"avhrr_lines": reader.lines, "hirs_lines": hirs.line,
                      "amsu_lines": amsu.linesA1}


@register_module
class NOAADSBDecoderModule(ProcessingModule):
    """soft (PM demod) -> .tip 104-byte frames (ref
    module_noaa_dsb_decoder.cpp + dsb_deframer.cpp: 16-bit ASM 0xEDE2,
    frames include the sync, both polarities searched)."""

    id = "noaa_dsb_decoder"

    def process(self):
        out_path = self.d_output_file_hint + ".tip"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        f_n = SimpleDeframer(0xEDE2, 16, 104 * 8, 0).work(bits)
        f_i = SimpleDeframer(0xEDE2, 16, 104 * 8, 0).work(1 - bits)
        frames = f_n if len(f_n) >= len(f_i) else f_i
        with open(out_path, "wb") as f:
            for frm in frames:
                f.write(frm.tobytes())
        self.stats = {"frame_count": len(frames),
                      "deframer_state": "SYNCED" if frames else "NOSYNC"}
        logger.info(f"NOAA DSB: {len(frames)} TIP frames")


def gac_pn_sequence() -> np.ndarray:
    """The 1023-bit GAC randomizer PN (ref gac_pn.h): the complement of the
    m-sequence c[n] = c[n-5]^c[n-8]^c[n-9]^c[n-10] seeded 1111100010
    (verified bit-exact against the reference table)."""
    c = np.zeros(1023, np.uint8)
    c[:10] = [1, 1, 1, 1, 1, 0, 0, 0, 1, 0]
    for i in range(10, 1023):
        c[i] = c[i - 5] ^ c[i - 8] ^ c[i - 9] ^ c[i - 10]
    return 1 - c


def gac_pn_bytes() -> np.ndarray:
    """PN as 4159 bytes, skipping the 60 sync bits
    (module_noaa_gac_decoder.cpp:55-62)."""
    pn = gac_pn_sequence()
    nbits = 4159 * 8
    bits = np.zeros(nbits, np.uint8)
    idx = np.arange(nbits - 60)
    bits[idx + 60] = pn[idx % 1023]
    return np.packbits(bits)


GAC_FRAME_BITS = 33270
GAC_FRAME_BYTES = 4159
GAC_ASM = 0xA116FD71
GAC_ASM_BACKWARD = 0x33C3E4A6


@register_module
class NOAAGACDecoderModule(ProcessingModule):
    """soft -> .frm of derandomized 4159-byte GAC frames
    (ref module_noaa_gac_decoder.cpp; backward reverses tape playback)."""

    id = "noaa_gac_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.backward = bool(self.param("backward", False))

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        asm = GAC_ASM_BACKWARD if self.backward else GAC_ASM
        deframer = CCSDSDeframer(GAC_FRAME_BITS, asm)
        pn = gac_pn_bytes()
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        n = 0
        frames = deframer.work(bits)
        with open(out_path, "wb") as f:
            for frm in frames:
                if self.backward:
                    fb = np.unpackbits(frm)[:GAC_FRAME_BITS][::-1]
                    frm = np.packbits(fb)
                f.write((frm ^ pn).tobytes())
                n += 1
        self.stats = {"frame_count": n,
                      "deframer_state": "SYNCED" if n else "NOSYNC"}
        logger.info(f"NOAA GAC: {n} frames")
