"""JPSS (Suomi-NPP / NOAA-20 / NOAA-21): VIIRS + ATMS instrument decoding.

Behavioral equivalent of plugins/jpss_support/jpss/:
* VIIRS channel reader (instruments/viirs/channel_reader.cpp): segment
  assembly per APID, per-detector CCSDS-121 (libaec n=15 J=8 rsi=128)
  decompression, oversample averaging, inter-channel differential decoding,
  scan-reversed image recomposition, bowtie correction.
* ATMS reader (instruments/atms/atms_reader.cpp): 96-position scanlines x
  22 channels plus cold/warm calibration views.
* jpss_instruments module (module_jpss_instruments.cpp): CADU -> VCID 1
  (ATMS) / VCID 16 (VIIRS) demux -> readers -> ImageProducts + dataset.

* OMPS nadir/limb readers (instruments/omps/omps_*_reader.cpp): see
  OmpsNadirReader / OmpsLimbReader below.

Counterpart of satdump_tpu/models/jpss.py (host NumPy, copied): the demod
and the CADU decoder in front of it (`npp_hrd`, `jpss_hrd`) run on the
pipeline's `torch_device`; this module takes none.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from satdump_tpu_torch.ccsds import CCSDSPacket, Demuxer, parse_ccsds_time, parse_vcdu
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.geo.raytrace import load_proj_settings
from satdump_tpu_torch.image.geometry import correct_generic_bowtie
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.xrit.rice import rice_decode_stream

JPSS_EPOCH_OFFSET_S = -4383 * 86400   # CDS day 0 = 1958; ref passes -4383 d

SNPP_SCID, JPSS1_SCID, JPSS2_SCID = 157, 159, 177
JPSS_SCIDS = {SNPP_SCID: ("Suomi NPP", 37849),
              JPSS1_SCID: ("NOAA 20 (JPSS-1)", 43013),
              JPSS2_SCID: ("NOAA 21 (JPSS-2)", 54234)}


class VIIRSChannel:
    """Channel geometry (instruments/viirs/channels.h)."""

    def __init__(self, apid, zone_width, zone_height, total_width,
                 oversample, scale):
        self.apid = apid
        self.zone_width = zone_width
        self.zone_height = zone_height
        self.total_width = total_width
        self.oversample = oversample
        self.scale = scale


_M_ZONES = [640, 368, 592, 592, 368, 640]
_I_ZONES = [1280, 736, 1184, 1184, 736, 1280]
_DNB_ZONES = [784, 488, 760, 760, 488, 784]
_M_AGG = [1, 2, 3, 3, 2, 1]
_NO_AGG = [1, 1, 1, 1, 1, 1]

VIIRS_CHANNELS: Dict[str, VIIRSChannel] = {
    # moderate-resolution bands (16 det/scan, 3200 px)
    "M1": VIIRSChannel(804, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M2": VIIRSChannel(803, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M3": VIIRSChannel(802, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M4": VIIRSChannel(800, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M5": VIIRSChannel(801, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M6": VIIRSChannel(805, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M7": VIIRSChannel(806, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M8": VIIRSChannel(809, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M9": VIIRSChannel(807, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M10": VIIRSChannel(808, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M11": VIIRSChannel(810, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M12": VIIRSChannel(812, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M13": VIIRSChannel(811, _M_ZONES, 16, 3200, _M_AGG, 8),
    "M14": VIIRSChannel(816, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M15": VIIRSChannel(815, _M_ZONES, 16, 3200, _NO_AGG, 16),
    "M16": VIIRSChannel(814, _M_ZONES, 16, 3200, _NO_AGG, 16),
    # imaging bands (32 det/scan, 6400 px)
    "I1": VIIRSChannel(818, _I_ZONES, 32, 6400, _NO_AGG, 16),
    "I2": VIIRSChannel(819, _I_ZONES, 32, 6400, _NO_AGG, 16),
    "I3": VIIRSChannel(820, _I_ZONES, 32, 6400, _NO_AGG, 16),
    "I4": VIIRSChannel(813, _I_ZONES, 32, 6400, _NO_AGG, 16),
    "I5": VIIRSChannel(817, _I_ZONES, 32, 6400, _NO_AGG, 16),
    # day-night band
    "DNB": VIIRSChannel(821, _DNB_ZONES, 16, 4064, _NO_AGG, 2),
    "DNBMGS": VIIRSChannel(822, _DNB_ZONES, 16, 4064, _NO_AGG, 2),
    "DNBLGS": VIIRSChannel(823, _DNB_ZONES, 16, 4064, _NO_AGG, 2),
}


class VIIRSSegment:
    def __init__(self, ch: VIIRSChannel):
        self.timestamp = 0.0
        # detector_data[detector][zone] -> int32 array (oversampled width)
        self.detector_data = [
            [np.zeros(ch.zone_width[z] * ch.oversample[z], np.int32)
             for z in range(6)]
            for _ in range(ch.zone_height)]


class VIIRSReader:
    """One channel's segment reader (channel_reader.cpp)."""

    def __init__(self, ch: VIIRSChannel):
        self.ch = ch
        self.segments: List[VIIRSSegment] = []
        self.timestamps: List[float] = []
        self.in_segment = False
        self.end_seq = 0

    def feed(self, pkt: CCSDSPacket) -> None:
        if pkt.header.apid != self.ch.apid:
            return
        if pkt.header.sequence_flag == 1:     # segment header packet
            self.in_segment = True
            seg = VIIRSSegment(self.ch)
            n_pkts = pkt.payload[8]
            seg.timestamp = parse_ccsds_time(pkt, JPSS_EPOCH_OFFSET_S)
            self.segments.append(seg)
            self.end_seq = (pkt.header.packet_sequence_count + n_pkts + 2) \
                & 0x3FFF
            return
        if not self.in_segment or not self.segments:
            return
        p = bytes(pkt.payload)
        if len(p) < 92:
            return
        detector = p[19]
        sync_pattern = int.from_bytes(p[20:24], "big")
        seg = self.segments[-1]
        det_offset = 88
        for det_n in range(6):
            if det_offset >= len(p):
                break
            d = p[det_offset:]
            if len(d) < 4:
                break
            fill_size = d[0]
            checksum_offset = d[2] << 8 | d[3]
            data_payload_size = checksum_offset - 4
            if data_payload_size <= 0 or checksum_offset < 4 \
                    or checksum_offset >= len(d) - 4:
                continue
            sync_word = 0xC000FFEE
            if len(d) > checksum_offset + 8:
                sync_word = int.from_bytes(
                    d[checksum_offset + 4: checksum_offset + 8], "big")
            # bit_slicer_detector (channel_reader.h:44-58): strip fill bits
            length = data_payload_size
            fs = fill_size
            while fs % 8 != 0:
                fs -= 1
            nbytes = length - fs // 8
            if 0 <= nbytes <= length:
                length = nbytes + 1
            if length > 8 and (sync_word == sync_pattern
                               or sync_word == 0xC000FFEE) \
                    and detector < self.ch.zone_height:
                want = self.ch.zone_width[det_n] * self.ch.oversample[det_n]
                dec = rice_decode_stream(d[4: 4 + length - 1], want,
                                         bits_per_pixel=15,
                                         pixels_per_block=8, rsi=128)
                if dec is not None:
                    v = dec.astype(np.int32)
                    agg = self.ch.oversample[det_n]
                    if agg > 1:  # decimate-average oversampled zones
                        v = v[: (len(v) // agg) * agg].reshape(-1, agg)
                        v = (v.sum(axis=1) // agg).astype(np.int32)
                        pad = self.ch.zone_width[det_n] * agg
                        out = np.zeros(pad, np.int32)
                        out[: len(v)] = v
                        seg.detector_data[detector][det_n] = out
                    else:
                        seg.detector_data[detector][det_n] = v
            det_offset += checksum_offset + 8

    def differential_decode(self, source: "VIIRSReader", decimation: int
                            ) -> None:
        """Inter-channel prediction removal (channel_reader.cpp:122-147):
        value = this + source[line/dec][y/dec] - 16383."""
        for seg in self.segments:
            src = next((s for s in source.segments
                        if s.timestamp == seg.timestamp), None)
            if src is None:
                blank = VIIRSSegment(self.ch)
                seg.detector_data = blank.detector_data
                continue
            for line in range(self.ch.zone_height):
                for det_n in range(6):
                    cur = seg.detector_data[line][det_n]
                    ref = src.detector_data[line // decimation][det_n]
                    w = self.ch.zone_width[det_n]
                    idx = np.arange(w) // decimation
                    idx = np.clip(idx, 0, len(ref) - 1)
                    seg.detector_data[line][det_n] = \
                        cur[:w] + ref[idx] - 16383

    def get_image(self) -> np.ndarray:
        """Recompose (getImage): segments stacked, lines reversed within a
        segment, zones concatenated, scaled to 16 bits."""
        ch = self.ch
        h = ch.zone_height * (len(self.segments) + 1)
        img = np.zeros((h, ch.total_width), np.uint16)
        self.timestamps = []
        for sn, seg in enumerate(self.segments):
            for line in range(ch.zone_height):
                row = sn * ch.zone_height + (ch.zone_height - 1 - line)
                off = 0
                for det_n in range(6):
                    w = ch.zone_width[det_n]
                    v = seg.detector_data[line][det_n][:w] * ch.scale
                    img[row, off: off + w] = np.clip(v, 0, 65535)
                    off += w
            self.timestamps.append(seg.timestamp)
        return img


class ATMSReader:
    """ATMS scanline reader (instruments/atms/atms_reader.cpp:27-81):
    96 earth views + 4 cold + 4 warm per scan, 22 channels."""

    def __init__(self):
        self.lines = 0
        self.scan_pos = -1
        self._rows: List[np.ndarray] = []      # (22, 96) per line
        self._cc: List[np.ndarray] = []
        self._wc: List[np.ndarray] = []
        self.timestamps: List[float] = []

    def work(self, pkt: CCSDSPacket) -> None:
        p = bytes(pkt.payload)
        if len(p) < 56:
            return
        if p[10] >> 7:                         # scan sync -> new line
            self.lines += 1
            self.timestamps.append(parse_ccsds_time(pkt, JPSS_EPOCH_OFFSET_S))
            self.scan_pos = 0
            self._rows.append(np.zeros((22, 96), np.uint16))
            self._cc.append(np.zeros((22, 4), np.uint16))
            self._wc.append(np.zeros((22, 4), np.uint16))
        if not self._rows:
            return
        vals = np.frombuffer(p[12: 12 + 44], ">u2").copy() \
            if len(p) >= 56 else None
        sp = self.scan_pos
        if 0 <= sp < 96:
            self._rows[-1][:, 95 - sp] = vals
        elif 0 <= sp - 96 < 4:
            self._cc[-1][:, sp - 96] = vals
        elif 0 <= sp - 100 < 4:
            self._wc[-1][:, sp - 100] = vals
        self.scan_pos += 1

    def get_channel(self, i: int) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, 96), np.uint16)
        return np.stack([r[i] for r in self._rows])


class OMPSReader:
    """OMPS nadir/limb (instruments/omps/omps_{nadir,limb}_reader.cpp):
    multi-packet frames assembled by sequence flag; the science payload
    (after a 149-byte header) is szip-compressed 32-bit big-endian words
    (256 px/scanline, 32 px/block, NN|MSB) holding `nch` channels x `npix`
    samples at a word offset."""

    def __init__(self, nch: int, npix: int, word_off: int):
        self.nch = nch
        self.npix = npix
        self.word_off = word_off
        self.lines = 0
        self._cur = bytearray()
        self._rows: List[np.ndarray] = []
        self.timestamps: List[float] = []

    def _finish(self, pkt: CCSDSPacket) -> None:
        f = bytes(self._cur)
        if len(f) <= 1000:
            return
        end = len(f) - (143 + 6) - (1 if f[141] == 0xEE else 0)
        comp = f[143 + 6: end]
        from satdump_tpu_torch.xrit.rice import rice_decode_stream32
        want = self.word_off + self.nch * self.npix
        dec = rice_decode_stream32(comp, want, 32, 32, 8)
        if dec is None:
            return
        words = dec[self.word_off:].reshape(self.nch, self.npix)
        self._rows.append(np.minimum(words, 65535).astype(np.uint16))
        self.lines += 1
        self.timestamps.append(parse_ccsds_time(pkt, JPSS_EPOCH_OFFSET_S))

    def work(self, pkt: CCSDSPacket) -> None:
        if pkt.header.sequence_flag == 1:
            self._finish(pkt)
            self._cur = bytearray(pkt.payload)
        elif pkt.header.sequence_flag in (0, 2):
            self._cur += pkt.payload

    def get_channel(self, ch: int) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, self.npix), np.uint16)
        return np.stack([r[ch] for r in self._rows])


def omps_nadir_reader() -> OMPSReader:
    return OMPSReader(nch=339, npix=142, word_off=74)


def omps_limb_reader() -> OMPSReader:
    return OMPSReader(nch=135, npix=6, word_off=64)


@register_module
class JPSSInstrumentsDecoderModule(ProcessingModule):
    """cadu -> VIIRS/ATMS products (module_jpss_instruments.cpp)."""

    id = "jpss_instruments"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.npp_mode = bool(self.param("npp_mode", False))

    def process(self):
        mpdu = 884 if self.npp_mode else 1094
        insert = 0 if self.npp_mode else 9
        cadu_size = 1024 if self.npp_mode else 1279
        dem1 = Demuxer(mpdu, has_insert_zone=insert > 0,
                       insert_zone_size=insert)
        dem16 = Demuxer(mpdu, has_insert_zone=insert > 0,
                        insert_zone_size=insert)

        dem11 = Demuxer(mpdu, has_insert_zone=insert > 0,
                        insert_zone_size=insert)
        viirs = {name: VIIRSReader(ch)
                 for name, ch in VIIRS_CHANNELS.items()}
        atms = ATMSReader()
        omps_nadir = omps_nadir_reader()
        omps_limb = omps_limb_reader()
        scids: List[int] = []

        data = np.fromfile(self.d_input_file, np.uint8)
        n = len(data) // cadu_size
        for i in range(n):
            cadu = bytes(data[i * cadu_size: (i + 1) * cadu_size])
            vcdu = parse_vcdu(cadu)
            if vcdu.spacecraft_id in JPSS_SCIDS:
                scids.append(vcdu.spacecraft_id)
            if vcdu.vcid == 1:       # ATMS
                for pkt in dem1.work(cadu):
                    if pkt.header.apid == 528:
                        atms.work(pkt)
            elif vcdu.vcid == 11:    # OMPS
                for pkt in dem11.work(cadu):
                    if pkt.header.apid in (616, 560):
                        omps_nadir.work(pkt)
                    elif pkt.header.apid in (617, 561):
                        omps_limb.work(pkt)
            elif vcdu.vcid == 16:    # VIIRS
                for pkt in dem16.work(cadu):
                    for r in viirs.values():
                        r.feed(pkt)

        scid = max(set(scids), key=scids.count) if scids else -1
        sat_name, norad = JPSS_SCIDS.get(scid, ("Unknown JPSS", 0))

        # differential decoding chains (module_jpss_instruments.cpp:546-581)
        for dst, src, dec in [("M5", "M4", 1), ("M3", "M4", 1),
                              ("M2", "M3", 1), ("M1", "M2", 1),
                              ("M8", "M10", 1), ("M11", "M10", 1),
                              ("M14", "M15", 1), ("I2", "I1", 1),
                              ("I3", "I2", 1), ("I4", "M12", 2),
                              ("I5", "M15", 2)]:
            viirs[dst].differential_decode(viirs[src], dec)

        out_dir = Path(self.d_output_file_hint).parent
        ts_all = [s.timestamp for s in viirs["I1"].segments] \
            or atms.timestamps
        ds = DataSet(sat_name, float(np.median(ts_all)) if ts_all else -1)

        n_viirs = 0
        vp = ImageProduct()
        vp.instrument_name = "viirs"
        alpha = 1.0 / 1.9
        beta = 0.52333
        for name, r in viirs.items():
            if not r.segments:
                continue
            img = r.get_image()
            img = correct_generic_bowtie(img, r.ch.zone_height, alpha, beta)
            vp.add_channel(img, name.lower(), bit_depth=16)
            n_viirs += 1
        if n_viirs:
            ts = viirs["I1"].timestamps or next(
                r.timestamps for r in viirs.values() if r.timestamps)
            vp.set_proj_cfg_tle_timestamps(
                load_proj_settings("jpss_viirs", norad=norad),
                {"name": sat_name, "norad": norad}, ts)
            vp.save(str(out_dir / "VIIRS"))
            ds.products_list.append("VIIRS")

        if atms.lines:
            from satdump_tpu_torch.products.calibrators import ATMS_FREQ_GHZ
            from satdump_tpu_torch.products.calibration import freq_to_wavenumber
            ap = ImageProduct()
            ap.instrument_name = "atms"
            for c in range(22):
                ap.add_channel(
                    atms.get_channel(c), str(c + 1), bit_depth=16,
                    wavenumber=freq_to_wavenumber(ATMS_FREQ_GHZ[c] * 1e9),
                    calibration_type="emissive_radiance")
            # per-scan cold/warm views -> two-point calibration
            # (atms_calibrator.cpp; warm-load temp simplified to 285 K)
            ap.set_calibration("jpss_atms", {"vars": {
                "cold_counts": [r.mean(axis=1).tolist()
                                for r in atms._cc],
                "warm_counts": [r.mean(axis=1).tolist()
                                for r in atms._wc],
                "warm_temp": 285.0}})
            ap.set_proj_cfg_tle_timestamps(
                load_proj_settings("jpss_atms", norad=norad),
                {"name": sat_name, "norad": norad}, atms.timestamps)
            ap.save(str(out_dir / "ATMS"))
            ds.products_list.append("ATMS")

        for nm, rd in (("OMPS-Nadir", omps_nadir), ("OMPS-Limb", omps_limb)):
            if rd.lines:
                from satdump_tpu_torch.image.io import save_img
                d = out_dir / "OMPS" / nm.split("-")[1]
                d.mkdir(parents=True, exist_ok=True)
                for c in range(rd.nch):
                    save_img(rd.get_channel(c), d / f"{nm}-{c + 1}.png")

        self.d_output_file = ds.save(str(out_dir))
        self.stats = {"satellite": sat_name, "atms_lines": atms.lines,
                      "viirs_channels": n_viirs,
                      "omps_nadir_lines": omps_nadir.lines,
                      "omps_limb_lines": omps_limb.lines,
                      "viirs_i1_segments": len(viirs["I1"].segments)}
        logger.info(f"JPSS instruments: {self.stats}")
