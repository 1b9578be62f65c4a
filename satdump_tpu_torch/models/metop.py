"""MetOp instruments decoder: .cadu -> per-instrument products.

Reference: plugins/noaa_metop_support/metop/module_metop_instruments.cpp
(VCID demux wiring :42-138, products assembly :163-240) and
instruments/avhrr/avhrr_reader.cpp. Round-1 scope: AVHRR/3 (the headline
imager); the reader model generalizes to MHS/AMSU/IASI in later passes.

Shape: packets are *collected* per instrument during the (host,
frame-rate) demux pass, then each reader converts all lines in one batched
NumPy pass (bit repack + deinterleave over the whole pass at once) — no
per-pixel loops. The module is host code; its products are rendered by the
products processor on the pipeline's `torch_device`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from satdump_tpu_torch.ccsds import CCSDSPacket, Demuxer, parse_ccsds_time, parse_vcdu
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.geo.raytrace import load_proj_settings
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.calibration import (ImageCalibrator,
                                              calibrator_registry)
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.utils.repack import repack_10bit, repack_12bit

METOP_SCIDS = {12: ("MetOp-A", 29499), 11: ("MetOp-B", 38771),
               13: ("MetOp-C", 43689)}

AVHRR_WAVENUMBERS = [0.0, 0.0, 2669.12, 928.81, 831.53, 0.0]  # ch 3b,4,5 IR


class NoaaAVHRR3Calibrator(ImageCalibrator):
    """AVHRR/3 radiometric calibrator, vectorized over whole channels
    (ref plugins/noaa_metop_support/instruments/avhrr/avhrr_calibrator.h):

    * visible channels (abs 0..2): dual-slope counts->reflectance (split at
      the lo/hi crossover), then reflectance -> radiance via F/pi;
    * IR channels (abs 3..5): space/blackbody two-point linear radiance
      (Ns + (Nbb-Ns)(Spc-c)/(Spc-Blb)) + quadratic non-linearity correction
      b0 + b1*Nlin + b2*Nlin^2, per line when `perLine_perChannel` telemetry
      averages are present, else from the per-channel constants.
    """

    RADIANCE_FACTORS = [1.0345143074006786, 1.2401744729666442,
                        1.3026239067055392]

    def __init__(self, product, cfg):
        super().__init__(product, cfg)
        v = cfg.get("vars", {})
        self.per_channel = v.get("perChannel", [])
        self.per_line = v.get("perLine_perChannel")
        imgs = getattr(product, "images", None)
        self.factor = 2 ** (10 - imgs[0].bit_depth) if imgs else 1

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        from satdump_tpu_torch.products.calibration import CALIBRATION_INVALID_VALUE
        c = np.asarray(counts, np.float64)
        out = np.full(c.shape, CALIBRATION_INVALID_VALUE)
        if channel_idx > 5 or channel_idx >= len(self.per_channel):
            return out
        pc = self.per_channel[channel_idx]
        if channel_idx < 3:
            if "slope_lo" not in pc or "F" not in pc:
                return out
            crossover = (pc["int_hi"] - pc["int_lo"]) / \
                (pc["slope_lo"] - pc["slope_hi"])
            px = c * self.factor
            refl = np.where(px <= crossover,
                            pc["slope_lo"] * px + pc["int_lo"],
                            pc["slope_hi"] * px + pc["int_hi"]) / 100.0
            rad = (pc["F"] / np.pi) * refl \
                * self.RADIANCE_FACTORS[channel_idx]
            return np.where(c == 0, CALIBRATION_INVALID_VALUE, rad)
        if self.per_line is not None:
            rows = np.asarray([
                [ln[channel_idx][k] for k in ("Ns", "Nbb", "Spc", "Blb")]
                for ln in self.per_line])                    # (lines, 4)
            Ns, Nbb, Spc, Blb = (rows[:, i][:, None] for i in range(4))
        else:
            Ns, Nbb, Spc, Blb = (pc[k] for k in ("Ns", "Nbb", "Spc", "Blb"))
        nlin = Ns + (Nbb - Ns) * (Spc - c) / (Spc - Blb)
        b = pc["b"]
        rad = nlin + b[0] + b[1] * nlin + b[2] * nlin * nlin
        return np.where(c == 0, CALIBRATION_INVALID_VALUE, rad)


calibrator_registry.register("noaa_avhrr3", NoaaAVHRR3Calibrator)


class MHSReader:
    """MHS scanline reader (ref plugins/noaa_metop_support/instruments/mhs/
    mhs_reader.cpp work_metop/work): MetOp MHS packets (VCID 12, APID 34)
    carry one SCI packet at payload offset 14; the 90-FOV image zone sits at
    byte 49, 12 bytes per FOV, channels 1..5 as big-endian u16 at byte
    offsets 2..10."""

    WIDTH = 90
    OFFSET = 49

    def __init__(self):
        self._lines: List[np.ndarray] = []
        self.timestamps: List[float] = []

    @property
    def lines(self) -> int:
        return len(self._lines)

    def work_metop(self, pkt: CCSDSPacket) -> None:
        if len(pkt.payload) < 1302:
            return
        self.timestamps.append(parse_ccsds_time(pkt, 10957 * 86400))
        sci = np.frombuffer(bytes(pkt.payload[14:14 + 1286]), np.uint8)
        zone = sci[self.OFFSET: self.OFFSET + self.WIDTH * 12]
        fovs = zone.reshape(self.WIDTH, 12)
        line = ((fovs[:, 2:12:2].astype(np.uint16) << 8)
                | fovs[:, 3:12:2]).astype(np.uint16)       # (90, 5)
        self._lines.append(line)

    def channels(self) -> List[np.ndarray]:
        if not self._lines:
            return [np.zeros((0, self.WIDTH), np.uint16) for _ in range(5)]
        img = np.stack(self._lines)                         # (n, 90, 5)
        return [img[:, :, c] for c in range(5)]


class AVHRRReader:
    """AVHRR/3 HRPT line reader (ref avhrr_reader.cpp work_metop/line2image):
    MetOp AVHRR packets (APID 103 = ch3a, 104 = ch3b) carry one 2048-pixel
    scanline of 5 interleaved 10-bit channels at word offset 55 after a
    14-byte header. 6 output channels (1, 2, 3a, 3b, 4, 5)."""

    WIDTH = 2048

    def __init__(self):
        self._payloads: List[bytes] = []
        self._is_ch3a: List[bool] = []
        self.timestamps: List[float] = []

    def work(self, pkt: CCSDSPacket) -> None:
        if len(pkt.payload) < 12960:
            return
        self._payloads.append(bytes(pkt.payload[:12960]))
        self._is_ch3a.append(pkt.header.apid == 103)
        # CDS time, epoch days since 1970 offset by 10957 (avhrr_reader.cpp:31)
        self.timestamps.append(parse_ccsds_time(pkt, 10957 * 86400))

    @property
    def lines(self) -> int:
        return len(self._payloads)

    def channels(self) -> List[np.ndarray]:
        """Batched decode of all collected lines -> 6 (lines, 2048) uint16."""
        n = len(self._payloads)
        chans = [np.zeros((n, self.WIDTH), np.uint16) for _ in range(6)]
        if n == 0:
            return chans
        raw = np.frombuffer(b"".join(self._payloads), np.uint8).reshape(n, 12960)
        words = repack_10bit(raw[:, 14: 14 + 12944])      # (n, 10355)
        ch3a = np.asarray(self._is_ch3a)
        # image zone: words[55 : 55+2048*5], pixel-interleaved 5 channels
        img = words[:, 55: 55 + self.WIDTH * 5].reshape(n, self.WIDTH, 5) << 6
        # physical channel slot -> output index (1,2 fixed; 3rd slot is
        # 3a or 3b; remaining shift by one) — avhrr_reader.cpp line2image
        for slot in range(5):
            out_a = slot + (1 if slot > 2 else 0)   # ch3a lines
            out_b = slot + (1 if slot > 1 else 0)   # ch3b lines
            if out_a == out_b:
                chans[out_a] = img[:, :, slot].astype(np.uint16)
            else:
                chans[out_a][ch3a] = img[ch3a, :, slot]
                chans[out_b][~ch3a] = img[~ch3a, :, slot]
        return chans


class IASIIMGReader:
    """IASI integrated imager (iasi_imaging_reader.cpp): 64x64-px IFOVs at
    12 bits, 36 per scan (first 6 are calibration views), counts normalized
    per scan against the cold (views 0-1) / warm (views 3-4) references."""

    def __init__(self):
        self.lines = 0
        self._scans: List[np.ndarray] = []   # (64, 36*64) uint16 per scan
        self.timestamps: List[float] = []
        self._cur = np.zeros((64, 36 * 64), np.uint16)
        self._cur_ts: List[float] = []
        self.calib: List[dict] = []          # per-scan {bbt, cold, warm}
        self._last_bbt = 0.0

    def work(self, pkt: CCSDSPacket) -> None:
        p = bytes(pkt.payload)
        if len(p) < 6196:
            return
        counter = p[16]
        if 0 < counter <= 36:
            words = repack_12bit(np.frombuffer(p[50: 50 + 6144], np.uint8))
            blk = words[: 64 * 64].reshape(64, 64)   # blk[y, i]
            # ir_channel[(line i), mirrored ifov column] = w[y, i] << 4
            x0 = (36 * 64 - 1) - ((counter - 1) * 64 + 63)
            self._cur[:, x0: x0 + 64] = (blk.T[:, ::-1] << 4)
            if counter <= 30:
                self._cur_ts.append(parse_ccsds_time(pkt, 10957 * 86400))
        if counter == 36:
            self._scans.append(self._cur)
            self.timestamps.append(np.median(self._cur_ts)
                                   if self._cur_ts else -1.0)
            self.calib.append({"bbt": self._last_bbt})
            self._cur = np.zeros((64, 36 * 64), np.uint16)
            self._cur_ts = []
            self.lines += 1

    def work_calib(self, pkt: CCSDSPacket) -> None:
        """Blackbody temperature from the verification packet (APID 180,
        iasi_imaging_reader.cpp work_calib)."""
        p = bytes(pkt.payload)
        if len(p) < 776:
            return
        w = p[14:]
        bbt = w[8] << 24 | w[9] << 16 | w[10] << 8 | w[11]
        self._last_bbt = bbt / 1e3

    def get_ir_channel(self) -> np.ndarray:
        """Normalize each scan against its cold/warm views and crop the 6
        calibration IFOVs (getIRChannel)."""
        if not self._scans:
            return np.zeros((0, 30 * 64), np.uint16)
        out = []
        for scan in self._scans:
            s = scan.astype(np.float64)
            cold = (s[:, 0 * 64: 1 * 64] + s[:, 1 * 64: 2 * 64]) / 2.0
            warm = (s[:, 3 * 64: 4 * 64] + s[:, 4 * 64: 5 * 64]) / 2.0
            span = warm - cold
            span[span == 0] = 1.0
            ref_lo = cold[0, 31]
            ref_hi = warm[0, 31]
            idx = len(out)
            if idx < len(self.calib):
                self.calib[idx]["cold_counts"] = float(ref_lo)
                self.calib[idx]["warm_counts"] = float(ref_hi)
            img = s.copy()
            for x2 in range(36):
                seg = s[:, x2 * 64: (x2 + 1) * 64]
                norm = (seg - cold) / span
                v = np.round(norm * (ref_hi - ref_lo) + ref_lo)
                v[seg == 0] = 0
                img[:, x2 * 64: (x2 + 1) * 64] = np.clip(v, 0, 65535)
            out.append(img[:, 6 * 64:].astype(np.uint16))
        return np.concatenate(out, axis=0)


def _ieee_halfish_to_float(samples: np.ndarray) -> np.ndarray:
    """ASCAT 16-bit float format (ascat_reader.h parse_uint_to_float):
    1 sign, 8 exponent, 7 mantissa."""
    s = (samples >> 15) & 1
    e = (samples >> 7) & 0xFF
    f = samples & 0x7F
    sign = np.where(s == 1, -1.0, 1.0)
    val = np.where(e == 255, 0.0,
                   np.where(e == 0,
                            np.where(f == 0, 0.0,
                                     sign * (2.0 ** -126) * f / 128.0),
                            sign * 2.0 ** (e.astype(np.float64) - 127)
                            * (f / 128.0 + 1.0)))
    return val


class ASCATReader:
    """ASCAT scatterometer (ascat_reader.cpp): 6 beams (APID 208-213 echo,
    224-229 noise), 256 samples/line stored both raw (image) and as floats
    (backscatter)."""

    def __init__(self):
        self.lines = [0] * 6
        self._img: List[List[np.ndarray]] = [[] for _ in range(6)]
        self._flt: List[List[np.ndarray]] = [[] for _ in range(6)]
        self.timestamps: List[List[float]] = [[] for _ in range(6)]

    def work(self, pkt: CCSDSPacket) -> None:
        p = bytes(pkt.payload)
        if len(p) < 654:
            return
        ch = pkt.header.apid - 208
        if 0 <= ch < 6:
            samples = np.frombuffer(p[140: 140 + 512], ">u2").copy()
            self._img[ch].append(samples)
            self._flt[ch].append(_ieee_halfish_to_float(samples))
            from satdump_tpu_torch.ccsds import crc_check_vertical_parity
            self.timestamps[ch].append(
                parse_ccsds_time(pkt, 10957 * 86400)
                if crc_check_vertical_parity(pkt) else -1.0)
            self.lines[ch] += 1

    def get_channel_img(self, ch: int) -> np.ndarray:
        if not self._img[ch]:
            return np.zeros((0, 256), np.uint16)
        return np.stack(self._img[ch])


class GOMEReader:
    """GOME-2 spectrometer (gome_reader.cpp): each packet carries one of 16
    counters x 2 readouts of 4 detector bands (1024 channels each); 6
    logical bands map onto them with fixed start/end splits. 32 scan
    positions per line, scan-reversed."""

    BAND_CHANNELS = [0, 0, 1, 1, 2, 3]
    BAND_STARTS = [0, 659, 0, 71, 0, 0]
    BAND_ENDS = [658, 1023, 70, 1023, 1023, 1023]

    def __init__(self):
        self.lines = 0
        self.timestamps: List[float] = []
        # per logical band: list of (1024-ish, 32) line blocks
        self._cur = [np.zeros((1024, 32), np.uint16) for _ in range(6)]
        self._rows: List[List[np.ndarray]] = [[] for _ in range(6)]

    def work(self, pkt: CCSDSPacket) -> None:
        p = bytes(pkt.payload)
        if len(p) < 18732:
            return
        hdr = np.frombuffer(p[14:], ">u2")
        counter = int(hdr[6])
        if counter > 15:
            return
        # 2 readouts x 4 detector bands of [index + 1024 samples]
        base = 478 + 680
        bands = hdr[base: base + 2 * 4 * 1025].reshape(2, 4, 1025)
        for band in range(6):
            b0, b1 = self.BAND_STARTS[band], self.BAND_ENDS[band]
            nch = b1 - b0 + 1
            if b0 >= nch:
                continue
            det = self.BAND_CHANNELS[band]
            data0 = bands[0, det, 1 + b0: 1 + b1 + 1]
            data1 = bands[1, det, 1 + b0: 1 + b1 + 1]
            self._cur[band][:nch, 31 - (counter * 2 + 0)] = data0
            self._cur[band][:nch, 31 - (counter * 2 + 1)] = data1
        if counter == 15:
            for band in range(6):
                self._rows[band].append(self._cur[band])
            self._cur = [np.zeros((1024, 32), np.uint16) for _ in range(6)]
            self.lines += 1
            self.timestamps.append(parse_ccsds_time(pkt, 10957 * 86400))

    def get_channel(self, channel: int) -> np.ndarray:
        """Global channel index -> (lines, 32) image (gome_reader.cpp
        getChannel band walk)."""
        band, coff, chan = 0, 0, channel
        while band < 5 and channel > (
                coff + (self.BAND_ENDS[band] - self.BAND_STARTS[band] + 1)):
            chan -= self.BAND_ENDS[band] - self.BAND_STARTS[band] + 1
            coff += self.BAND_ENDS[band] - self.BAND_STARTS[band] + 1
            band += 1
        if not self._rows[band]:
            return np.zeros((0, 32), np.uint16)
        return np.stack([blk[chan] for blk in self._rows[band]])


@register_module
class MetOpInstrumentsDecoderModule(ProcessingModule):
    """cadu -> instrument products (ref module_metop_instruments.cpp)."""

    id = "metop_instruments"

    def process(self):
        avhrr = AVHRRReader()
        mhs = MHSReader()
        iasi_img = IASIIMGReader()
        ascat = ASCATReader()
        gome = GOMEReader()
        from satdump_tpu_torch.models.noaa_tip import AMSUReader
        amsu = AMSUReader()
        demux_vcid3 = Demuxer(mpdu_data_size=882, has_insert_zone=True)
        demux_vcid9 = Demuxer(mpdu_data_size=882, has_insert_zone=True)
        demux_vcid10 = Demuxer(mpdu_data_size=882, has_insert_zone=True)
        demux_vcid12 = Demuxer(mpdu_data_size=882, has_insert_zone=True)
        demux_vcid15 = Demuxer(mpdu_data_size=882, has_insert_zone=True)
        demux_vcid24 = Demuxer(mpdu_data_size=882, has_insert_zone=True)
        scids: List[int] = []

        cadus = np.fromfile(self.d_input_file, np.uint8)
        cadus = cadus[: len(cadus) // 1024 * 1024].reshape(-1, 1024)
        for cadu in cadus:
            vcdu = parse_vcdu(cadu)
            if vcdu.spacecraft_id in METOP_SCIDS:
                scids.append(vcdu.spacecraft_id)
            if vcdu.vcid == 3:  # AMSU
                for pkt in demux_vcid3.work(bytes(cadu)):
                    if pkt.header.apid in (39, 40):
                        amsu.work_metop(pkt)
            elif vcdu.vcid == 9:  # AVHRR/3
                for pkt in demux_vcid9.work(bytes(cadu)):
                    if pkt.header.apid in (103, 104):
                        avhrr.work(pkt)
            elif vcdu.vcid == 10:  # IASI
                for pkt in demux_vcid10.work(bytes(cadu)):
                    if pkt.header.apid == 150:
                        iasi_img.work(pkt)
                    elif pkt.header.apid == 180:
                        iasi_img.work_calib(pkt)
            elif vcdu.vcid == 12:  # MHS
                for pkt in demux_vcid12.work(bytes(cadu)):
                    if pkt.header.apid == 34:
                        mhs.work_metop(pkt)
            elif vcdu.vcid == 15:  # ASCAT
                for pkt in demux_vcid15.work(bytes(cadu)):
                    ascat.work(pkt)
            elif vcdu.vcid == 24:  # GOME
                for pkt in demux_vcid24.work(bytes(cadu)):
                    if pkt.header.apid == 384:
                        gome.work(pkt)

        scid = max(set(scids), key=scids.count) if scids else -1
        sat_name, norad = METOP_SCIDS.get(scid, ("Unknown MetOp", 0))
        logger.info(f"MetOp instruments: {sat_name}, AVHRR lines {avhrr.lines}")

        out_dir = Path(self.d_output_file_hint).parent
        ds = DataSet(sat_name, float(np.median(
            [t for t in avhrr.timestamps if t > 0]) if avhrr.timestamps else -1))

        if avhrr.lines:
            p = ImageProduct()
            p.instrument_name = "avhrr_3"
            names = ["1", "2", "3a", "3b", "4", "5"]
            for i, ch in enumerate(avhrr.channels()):
                p.add_channel(ch, names[i], bit_depth=16,
                              wavenumber=AVHRR_WAVENUMBERS[i])
            # radiometric calibration cfg: per-channel constants from the
            # pipeline params (ref builds them from the NOAA KLM constants
            # resource + PRT telemetry, avhrr_reader.cpp:265-318)
            calib = self.param("avhrr_calib")
            if calib:
                p.set_calibration("noaa_avhrr3", dict(calib))
            p.set_proj_cfg_tle_timestamps(
                load_proj_settings("metop_abc_avhrr", norad=norad),
                {"name": sat_name, "norad": norad},
                avhrr.timestamps)
            p.save(str(out_dir / "AVHRR"))
            ds.products_list.append("AVHRR")

        if mhs.lines:
            pm = ImageProduct()
            pm.instrument_name = "mhs"
            # wavenumbers cm^-1 for 89/157/183x2/190 GHz (freq/c)
            wn = [2.97, 5.24, 6.11, 6.11, 6.35]
            for c, ch in enumerate(mhs.channels()):
                pm.add_channel(ch, str(c + 1), bit_depth=16,
                               wavenumber=wn[c])
            pm.set_proj_cfg_tle_timestamps(
                load_proj_settings("metop_abc_mhs", norad=norad),
                {"name": sat_name, "norad": norad}, mhs.timestamps)
            pm.save(str(out_dir / "MHS"))
            ds.products_list.append("MHS")

        if iasi_img.lines:
            pi = ImageProduct()
            pi.instrument_name = "iasi_img"
            img = iasi_img.get_ir_channel()
            # bowtie per-IFOV scan (module_metop_instruments.cpp:357)
            from satdump_tpu_torch.image.geometry import correct_generic_bowtie
            img = correct_generic_bowtie(img, 64, 1.0 / 2.2, 1.0 - 1.0 / 2.2)
            pi.add_channel(img, "1", bit_depth=16, wavenumber=875.0)
            pi.set_calibration("metop_iasi_img", {"vars": iasi_img.calib})
            pi.set_proj_cfg_tle_timestamps(
                load_proj_settings("metop_abc_iasi_img", norad=norad),
                {"name": sat_name, "norad": norad}, iasi_img.timestamps)
            pi.save(str(out_dir / "IASI-IMG"))
            ds.products_list.append("IASI-IMG")

        if any(ascat.lines):
            for i in range(6):
                if not ascat.lines[i]:
                    continue
                pa = ImageProduct()
                pa.instrument_name = "ascat"
                pa.add_channel(ascat.get_channel_img(i), "1", bit_depth=16)
                pa.set_calibration("metop_ascat", {})
                pa.contents["timestamps"] = ascat.timestamps[i]
                pa.contents["beam"] = i + 1
                pa.save(str(out_dir / "ASCAT" / str(i + 1)))
                ds.products_list.append(f"ASCAT/{i + 1}")

        if amsu.linesA1 or amsu.linesA2:
            pa1 = ImageProduct()
            pa1.instrument_name = "amsu_a"
            for c in range(13):
                pa1.add_channel(amsu.get_channel_a1(c), str(c + 3),
                                bit_depth=16)
            for c in range(2):
                pa1.add_channel(amsu.get_channel_a2(c), str(c + 1),
                                bit_depth=16)
            pa1.contents["timestamps_a1"] = amsu.timestamps_a1
            pa1.contents["timestamps_a2"] = amsu.timestamps_a2
            pa1.set_proj_cfg_tle_timestamps(
                load_proj_settings("metop_abc_amsu", norad=norad),
                {"name": sat_name, "norad": norad},
                amsu.timestamps_a1 or amsu.timestamps_a2)
            pa1.save(str(out_dir / "AMSU"))
            ds.products_list.append("AMSU")

        if gome.lines:
            pg = ImageProduct()
            pg.instrument_name = "gome"
            # save a subset of representative channels as images (the ref
            # writes all ~4k; one per logical band keeps products tractable)
            for ch in (0, 700, 1400, 2200, 3000, 3800):
                pg.add_channel(gome.get_channel(ch), str(ch + 1),
                               bit_depth=16)
            pg.contents["timestamps"] = gome.timestamps
            pg.save(str(out_dir / "GOME"))
            ds.products_list.append("GOME")

        self.d_output_file = ds.save(str(out_dir))
        self.stats = {"avhrr_lines": avhrr.lines, "mhs_lines": mhs.lines,
                      "iasi_img_lines": iasi_img.lines,
                      "ascat_lines": list(ascat.lines),
                      "gome_lines": gome.lines,
                      "amsu_lines": [amsu.linesA1, amsu.linesA2],
                      "satellite": sat_name}
