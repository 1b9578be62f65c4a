"""EOS (Terra / Aqua) MODIS instrument decoding.

Behavioral equivalent of plugins/eos_support/eos/:
* MODIS reader (instruments/modis/modis_reader.cpp): day packets carry one
  83-word IFOV block per detector-frame (2ch 250 m @4x4, 5ch 500 m @2x2,
  31ch 1000 m), night packets 17 thermal channels; 12-bit science words
  with a sum-shift checksum; 10-line scans assembled from seq-flag 1/2
  packet pairs; engineering packets supply the calibration telemetry.
* eos_instruments module (module_eos_instruments.cpp): Terra VCID 42 /
  Aqua VCID 30, APID 64 -> reader -> MODIS ImageProduct.

Counterpart of satdump_tpu/models/eos.py (host NumPy, copied): the
psk_demod in front of `aqua_db_decoder` runs on the pipeline's
`torch_device`; these modules take none.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from satdump_tpu_torch.ccsds import CCSDSPacket, Demuxer, parse_ccsds_time, parse_vcdu
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.utils.repack import repack_12bit

EOS_EPOCH_OFFSET_S = -4383 * 86400

DAY_GROUP, NIGHT_GROUP, ENG_GROUP_1, ENG_GROUP_2 = 0, 1, 2, 4


class MODISHeader:
    """12-byte MODIS packet secondary header (modis_reader.h:13-35)."""

    def __init__(self, pkt: CCSDSPacket):
        p = bytes(pkt.payload)
        self.packet_type = (p[8] >> 4) & 0b111
        self.scan_count = (p[8] >> 1) & 0b111
        self.mirror_side = p[8] & 1
        self.type_flag = p[9] >> 7
        self.earth_frame_data_count = (p[9] & 0x7F) << 4 | p[10] >> 4
        self.calib_type = (p[9] >> 5) & 0b11
        self.calib_frame_count = ((p[9] >> 1) & 1) << 5 | p[10] >> 3


def _modis_crc(words: np.ndarray) -> int:
    """Sum into 16 bits (overflow ignored), >>4 (modis_reader.cpp:58-66)."""
    return int(np.sum(words.astype(np.uint64)) & 0xFFFF) >> 4


class MODISReader:
    """Day/night packet -> 250/500/1000 m channel images."""

    WIDTH = 1354

    def __init__(self):
        self.lines = 0
        self.day_count = 0
        self.night_count = 0
        self.last_scan_count = -1
        self.timestamps_1000: List[float] = []
        self.timestamps_250: List[float] = []
        self._rows1000: List[np.ndarray] = []   # blocks of (10, 31, 1354)
        self._rows500: List[np.ndarray] = []    # (20, 5, 2708)
        self._rows250: List[np.ndarray] = []    # (40, 2, 5416)
        self.calib: Dict[int, dict] = {}

    def _new_scan(self, pkt: CCSDSPacket) -> None:
        self.lines += 10
        self._rows1000.append(np.zeros((10, 31, self.WIDTH), np.uint16))
        self._rows500.append(np.zeros((20, 5, self.WIDTH * 2), np.uint16))
        self._rows250.append(np.zeros((40, 2, self.WIDTH * 4), np.uint16))
        ts = parse_ccsds_time(pkt, EOS_EPOCH_OFFSET_S)
        self.timestamps_1000 += [ts + i * 0.162 for i in range(-5, 5)]
        self.timestamps_250 += [ts + i * 0.0405 for i in range(-20, 20)]

    def work(self, pkt: CCSDSPacket) -> None:
        if len(pkt.payload) < 10:
            return
        h = MODISHeader(pkt)
        if h.packet_type == DAY_GROUP and len(pkt.payload) >= 636:
            self.day_count += 1
            self._day(pkt, h)
        elif h.packet_type == NIGHT_GROUP and len(pkt.payload) >= 270:
            self.night_count += 1
            self._night(pkt, h)

    def _day(self, pkt: CCSDSPacket, h: MODISHeader) -> None:
        ifov = repack_12bit(np.frombuffer(bytes(pkt.payload[12:12 + 624]),
                                          np.uint8))
        if _modis_crc(ifov[:415]) != ifov[415]:
            return
        if h.type_flag == 1:      # calibration views: record, don't image
            key = {0: "solar_diffuser_source", 1: "srca_diffuser_source",
                   2: "blackbody_source", 3: "space_source"}[h.calib_type]
            c = self.calib.setdefault(self.lines // 10, {})
            c.setdefault(key, {}).setdefault(h.calib_frame_count, {})[
                "seq%d" % pkt.header.sequence_flag] = ifov[:415].tolist()
            return
        if h.earth_frame_data_count > self.WIDTH:
            return
        position = h.earth_frame_data_count - 1
        if position == 0 and pkt.header.sequence_flag == 1 \
                and self.last_scan_count != h.scan_count:
            self._new_scan(pkt)
        self.last_scan_count = h.scan_count
        if not self._rows1000 or position < 0:
            return
        r1000, r500, r250 = (self._rows1000[-1], self._rows500[-1],
                             self._rows250[-1])
        # seq 1 carries IFOVs 1-5 (upper detector block), seq 2 IFOVs 6-10
        base = 5 if pkt.header.sequence_flag == 1 else 0
        blocks = ifov[: 5 * 83].reshape(5, 83)      # f index reversed below
        for f in range(5):
            blk = blocks[4 - f]
            row = base + f
            # 250 m: ch 1-2, 4 detectors x 4 subframes (modis_reader.cpp:127)
            b250 = blk[:32].reshape(2, 4, 4)        # (c, i, y)
            for y in range(4):
                r250[row * 4 + (3 - y), :, position * 4: position * 4 + 4] \
                    = (b250[:, :, y] << 4)
            # 500 m: ch 3-7, 2x2
            b500 = blk[32:52].reshape(5, 2, 2)
            for y in range(2):
                r500[row * 2 + (1 - y), :, position * 2: position * 2 + 2] \
                    = (b500[:, :, y] << 4)
            # 1000 m: 31 channels
            r1000[row, :, position] = blk[52:83] << 4

    def _night(self, pkt: CCSDSPacket, h: MODISHeader) -> None:
        ifov = repack_12bit(np.frombuffer(bytes(pkt.payload[12:12 + 258]),
                                          np.uint8))
        if _modis_crc(ifov[:171]) != ifov[171]:
            return
        if h.type_flag == 1 or h.earth_frame_data_count > self.WIDTH:
            return
        position = h.earth_frame_data_count - 1
        if position == 0 and self.last_scan_count != h.scan_count:
            self._new_scan(pkt)
        self.last_scan_count = h.scan_count
        if not self._rows1000 or position < 0:
            return
        r1000 = self._rows1000[-1]
        blocks = ifov[: 10 * 17].reshape(10, 17)
        for f in range(10):
            r1000[f, 14: 14 + 17, position] = blocks[9 - f] << 4

    def get_image_1000m(self, ch: int) -> np.ndarray:
        if not self._rows1000:
            return np.zeros((0, self.WIDTH), np.uint16)
        return np.concatenate([b[:, ch, :] for b in self._rows1000])

    def get_image_500m(self, ch: int) -> np.ndarray:
        if not self._rows500:
            return np.zeros((0, self.WIDTH * 2), np.uint16)
        return np.concatenate([b[:, ch, :] for b in self._rows500])

    def get_image_250m(self, ch: int) -> np.ndarray:
        if not self._rows250:
            return np.zeros((0, self.WIDTH * 4), np.uint16)
        return np.concatenate([b[:, ch, :] for b in self._rows250])


@register_module
class AquaDBDecoderModule(ProcessingModule):
    """Aqua direct-broadcast soft -> cadu (module_aqua_db_decoder.cpp:27-85):
    uncoded OQPSK, the I and Q rails NRZ-M decoded INDEPENDENTLY then
    re-interleaved, CCSDS deframe (1024 B), derandomize, RS(223) x4."""

    id = "aqua_db_decoder"

    def process(self):
        from satdump_tpu_torch.ops.fec import differential
        from satdump_tpu_torch.ops.fec.deframer import CCSDSDeframer
        from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
        from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon

        out_path = self.d_output_file_hint + ".cadu"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, np.int8)
        bi = (soft[0::2] > 0).astype(np.uint8)
        bq = (soft[1::2] > 0).astype(np.uint8)
        bi, _ = differential.nrzm_decode(bi, 0)
        bq, _ = differential.nrzm_decode(bq, 0)
        bits = np.empty(2 * len(bi), np.uint8)
        bits[0::2], bits[1::2] = bi, bq
        deframer = CCSDSDeframer(1024 * 8)
        rs = ReedSolomon(k=223)
        nframes = 0
        rs_avg = []
        with open(out_path, "wb") as f:
            frames = deframer.work(bits)
            if frames:
                cadus = np.stack(frames).astype(np.uint8)
                cadus[:, 4:] = derand_ccsds(cadus[:, 4:])
                corrected, errs = rs.decode_interleaved(
                    cadus[:, 4: 4 + 255 * 4], True, 4)
                cadus[:, 4: 4 + 255 * 4] = corrected
                rs_avg.append(errs.reshape(-1))
                f.write(cadus.tobytes())
                nframes = len(cadus)
        self.stats = {"frames": nframes,
                      "rs_avg": float(np.mean(np.concatenate(rs_avg)))
                      if rs_avg else 0.0}
        logger.info(f"Aqua DB: {nframes} CADUs")


@register_module
class EOSInstrumentsDecoderModule(ProcessingModule):
    """cadu -> MODIS products (module_eos_instruments.cpp)."""

    id = "eos_instruments"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.satellite = str(self.param("satellite", required=True))
        if self.satellite not in ("terra", "aqua"):
            from satdump_tpu_torch.core.exceptions import PipelineError
            raise PipelineError(f"EOS satellite '{self.satellite}' invalid")
        self.bowtie = bool(self.param("modis_bowtie", False))

    def process(self):
        modis = MODISReader()
        vcid = 42 if self.satellite == "terra" else 30
        dem = Demuxer(mpdu_data_size=884)
        data = np.fromfile(self.d_input_file, np.uint8)
        n = len(data) // 1024
        for i in range(n):
            cadu = bytes(data[i * 1024: (i + 1) * 1024])
            if parse_vcdu(cadu).vcid != vcid:
                continue
            for pkt in dem.work(cadu):
                if pkt.header.apid == 64:
                    modis.work(pkt)

        out_dir = Path(self.d_output_file_hint).parent
        name = "Terra" if self.satellite == "terra" else "Aqua"
        norad = 25994 if self.satellite == "terra" else 27424
        ds = DataSet(name, float(np.median(modis.timestamps_1000))
                     if modis.timestamps_1000 else -1)
        if modis.lines:
            p = ImageProduct()
            p.instrument_name = "modis"
            from satdump_tpu_torch.image.geometry import correct_generic_bowtie
            for c in range(2):
                img = modis.get_image_250m(c)
                if self.bowtie:
                    img = correct_generic_bowtie(img, 40, 1 / 1.9, 0.52333)
                p.add_channel(img, str(c + 1), bit_depth=12)
            for c in range(5):
                img = modis.get_image_500m(c)
                if self.bowtie:
                    img = correct_generic_bowtie(img, 20, 1 / 1.9, 0.52333)
                p.add_channel(img, str(c + 3), bit_depth=12)
            names1000 = [str(i) for i in range(8, 13)] + ["13L", "13H",
                                                          "14L", "14H"] + \
                [str(i) for i in range(15, 37)]
            for c in range(31):
                img = modis.get_image_1000m(c)
                if self.bowtie:
                    img = correct_generic_bowtie(img, 10, 1 / 1.9, 0.52333)
                p.add_channel(img, names1000[c], bit_depth=12)
            p.set_proj_cfg_tle_timestamps(
                {"type": "normal_line", "scan_angle": 110.0,
                 "image_width": 1354, "gcp_spacing_x": 50,
                 "gcp_spacing_y": 10, "norad": norad},
                {"name": name, "norad": norad}, modis.timestamps_1000)
            p.save(str(out_dir / "MODIS"))
            ds.products_list.append("MODIS")
        self.d_output_file = ds.save(str(out_dir))
        self.stats = {"satellite": name, "modis_lines": modis.lines,
                      "day_packets": modis.day_count,
                      "night_packets": modis.night_count}
        logger.info(f"EOS instruments: {self.stats}")
