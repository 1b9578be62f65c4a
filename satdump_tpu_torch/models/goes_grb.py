"""GOES-R GRB (GOES Rebroadcast): BBFrame -> CADU extractor and the CCSDS
data decoder producing ABI / SUVI / GLM products.

Behavioral equivalent of plugins/goes_support/goes/grb/ (PUG-GRB-vol4):
* module_goes_grb_cadu_extractor.cpp: DVB-S2 BBFrames (7274 bytes, 10-byte
  BBHeader) carry a byte-aligned stream of 2048-byte CADUs; re-sync by
  correlating the 4-byte ASM inside each window.
* module_goes_grb_data_decoder.cpp: CADU -> VCDU -> per-polarization AOS
  demux (VCID 5 RHCP / 6 LHCP, M-PDU 2034) -> per-APID payload assembly
  (sequence flags + CRC-32, payload_assembler.cpp) -> GRB payloads
  (grb_headers.h) -> ABI image blocks (J2K or raw, pasted onto the product
  canvas, abi_image_assembler.cpp), SUVI 1280x1280 images, GLM event/flash/
  group JSON (glm_parser.cpp), metadata XML.

The APID maps are generated from the arithmetic layout of the PUG tables
(abi_products.cpp transcribes the same values literal-by-literal).

Counterpart of satdump_tpu/models/goes_grb.py (host NumPy, copied). The
ABI and SUVI blocks' JPEG 2000 goes through the port's own decoder
(`image/j2k.py`, `native/j2k.c`) instead of Pillow, images through the
port's PNG codec.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from satdump_tpu_torch.ccsds import CCSDSPacket, Demuxer, parse_vcdu
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image.io import save_img
from satdump_tpu_torch.image.j2k import decompress_j2k
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module

BBFRAME_SIZE = 58192 // 8   # bytes (module_goes_grb_cadu_extractor.cpp:8)
CADU_SIZE = 2048
ASM = bytes([0x1A, 0xCF, 0xFC, 0x1D])

FULL_DISK, CONUS, MESO_1, MESO_2 = 0, 1, 2, 3
ZONE_NAMES = {FULL_DISK: "FULLDISK", CONUS: "CONUS",
              MESO_1: "MESO1", MESO_2: "MESO2"}
ZONE_DIMS = {FULL_DISK: (10848, 10848), CONUS: (5000, 3000),
             MESO_1: (1000, 1000), MESO_2: (1000, 1000)}  # (w, h) at 1 km

# channel -> (resolution km, bit depth) (abi_products.cpp ABI_CHANNEL_PARAMS)
ABI_CHANNEL_PARAMS = {
    1: (1.0, 10), 2: (0.5, 12), 3: (1.0, 10), 4: (2.0, 11), 5: (1.0, 10),
    6: (2.0, 10), 7: (2.0, 14), 8: (2.0, 12), 9: (2.0, 11), 10: (2.0, 12),
    11: (2.0, 12), 12: (2.0, 11), 13: (2.0, 12), 14: (2.0, 12),
    15: (2.0, 12), 16: (2.0, 10),
}


def _abi_apid_maps():
    """(mode, zone) -> APID base; image data and metadata maps
    (abi_products.cpp ABI_IMAGE_PRODUCTS / _META; 16 channels per base)."""
    layout = [  # (mode, {zone: (image_base, meta_base)})
        (6, {FULL_DISK: (0x90, 0x80), CONUS: (0xB0, 0xA0),
             MESO_1: (0xD0, 0xC0), MESO_2: (0xF0, 0xE0)}),
        (3, {FULL_DISK: (0x110, 0x100), CONUS: (0x130, 0x120),
             MESO_1: (0x150, 0x140), MESO_2: (0x170, 0x160)}),
        (4, {FULL_DISK: (0x190, 0x180), CONUS: (0x1A0, 0x190)}),
    ]
    image, meta = {}, {}
    for mode, zones in layout:
        for zone, (ib, mb) in zones.items():
            for ch in range(1, 17):
                image[ib + ch - 1] = (mode, zone, ch)
                meta[mb + ch - 1] = (mode, zone, ch)
    return image, meta


ABI_IMAGE_PRODUCTS, ABI_IMAGE_PRODUCTS_META = _abi_apid_maps()

SUVI_CHANNELS = ["Fe094", "Fe132", "Fe171", "Fe195", "Fe284", "Fe304"]
SUVI_IMAGE_PRODUCTS = {0x486 + i: ch for i, ch in enumerate(SUVI_CHANNELS)}
SUVI_IMAGE_PRODUCTS_META = {0x480 + i: ch for i, ch in enumerate(SUVI_CHANNELS)}

GLM_META, GLM_EVENT, GLM_FLASH, GLM_GROUP = 0, 1, 2, 3
GLM_PRODUCTS = {0x300: GLM_META, 0x301: GLM_EVENT,
                0x302: GLM_FLASH, 0x303: GLM_GROUP}
APID_GRB_INFO = 0x580

# GRB epoch (grb_headers.h: (4383+6574) days + 12 h = 2000-01-01T12:00 J2000)
GRB_EPOCH = (4383 + 6574) * 86400 + 12 * 3600

# payload variants / compression (grb_headers.h)
VARIANT_GENERIC, VARIANT_IMAGE, VARIANT_IMAGE_DQF = 0, 2, 3
COMP_NONE, COMP_J2K, COMP_SZIP = 0, 1, 2


# ---------------------------------------------------------------------------
# Headers
# ---------------------------------------------------------------------------
class GRBSecondaryHeader:
    """8-byte GRB secondary header (grb_headers.h GRBSecondaryHeader)."""

    def __init__(self, d: bytes):
        self.day_since_epoch = d[0] << 8 | d[1]
        self.ms_of_day = d[2] << 24 | d[3] << 16 | d[4] << 8 | d[5]
        self.grb_version = d[6] >> 3
        self.grb_payload_variant = (d[6] & 0b111) << 2 | d[7] >> 6
        self.assembler_identifier = (d[7] >> 4) & 0b11
        self.system_environment = d[7] & 0b1111


class GRBImagePayloadHeader:
    """34-byte image payload header (grb_headers.h GRBImagePayloadHeader).
    utc_time uses the correct us->s scale (the reference divides
    microseconds by 1000 — a factor-1000 slip it only uses for grouping)."""

    SIZE = 34

    def __init__(self, d: bytes):
        self.compression_algorithm = d[0]
        self.seconds_since_epoch = int.from_bytes(d[1:5], "big")
        self.microsecond_of_second = int.from_bytes(d[5:9], "big")
        self.block_sequence_count = int.from_bytes(d[9:11], "big")
        self.row_offset_image_block = int.from_bytes(d[11:14], "big")
        self.left_x_coord = int.from_bytes(d[14:18], "big")
        self.left_y_coord = int.from_bytes(d[18:22], "big")
        self.image_block_height = int.from_bytes(d[22:26], "big")
        self.image_block_width = int.from_bytes(d[26:30], "big")
        self.byte_offset_dqf = int.from_bytes(d[30:34], "big")
        self.utc_time = (GRB_EPOCH + self.seconds_since_epoch
                         + self.microsecond_of_second / 1e6)


class GRBGenericPayloadHeader:
    """21-byte generic payload header (grb_headers.h)."""

    SIZE = 21

    def __init__(self, d: bytes):
        self.compression_algorithm = d[0]
        self.seconds_since_epoch = int.from_bytes(d[1:5], "big")
        self.microsecond_of_second = int.from_bytes(d[5:9], "big")
        self.data_unit_sequence_count = int.from_bytes(d[16:20], "big")
        self.utc_time = (GRB_EPOCH + self.seconds_since_epoch
                         + self.microsecond_of_second / 1e6)


def _ts_string(t: float) -> str:
    import time as _t
    tm = _t.gmtime(int(t))
    return _t.strftime("%Y%m%dT%H%M%SZ", tm)


# ---------------------------------------------------------------------------
# CADU extractor (bbframe -> cadu)
# ---------------------------------------------------------------------------
@register_module
class GRBCaduExtractorModule(ProcessingModule):
    """BBFrame stream -> byte-aligned 2048-byte CADUs
    (module_goes_grb_cadu_extractor.cpp:34-90). Vectorized correlation: the
    ASM match count at every window offset via 4 shifted compares."""

    id = "goes_grb_cadu_extractor"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.synced = False
        self.cor = 0

    def _best_asm(self, win: np.ndarray) -> tuple[int, int]:
        """First offset with a full ASM match, else argmax of match count."""
        n = len(win) - 4
        cor = np.zeros(n, np.int32)
        for k, b in enumerate(ASM):
            cor += win[k: k + n] == b
        full = np.flatnonzero(cor == 4)
        if len(full):
            return int(full[0]), 4
        best = int(np.argmax(cor))
        return best, int(cor[best])

    def process(self):
        out_path = self.d_output_file_hint + ".cadu"
        self.d_output_file = out_path
        data = np.fromfile(self.d_input_file, dtype=np.uint8)
        nbb = len(data) // BBFRAME_SIZE
        # strip the 10-byte BBHeader of every frame, concatenate payloads
        payload = data[: nbb * BBFRAME_SIZE].reshape(nbb, BBFRAME_SIZE)[:, 10:]
        stream = payload.reshape(-1)
        n_cadus = 0
        pos = 0
        with open(out_path, "wb") as f:
            while pos + 2 * CADU_SIZE <= len(stream):
                win = stream[pos: pos + CADU_SIZE]
                best, cor = self._best_asm(
                    np.concatenate([win, stream[pos + CADU_SIZE:
                                                pos + CADU_SIZE + 4]]))
                self.cor, self.synced = cor, best == 0
                pos += best           # realign to the ASM
                f.write(stream[pos: pos + CADU_SIZE].tobytes())
                pos += CADU_SIZE
                n_cadus += 1
        self.stats = {"cadus": n_cadus, "synced": self.synced,
                      "correlation": self.cor}
        logger.info(f"GRB CADU extractor: {n_cadus} CADUs")


# ---------------------------------------------------------------------------
# Payload assembly
# ---------------------------------------------------------------------------
class GRBFilePayload:
    def __init__(self):
        self.valid = True
        self.in_progress = False
        self.apid = 0
        self.sec_header: Optional[GRBSecondaryHeader] = None
        self.payload = bytearray()


class GRBPayloadAssembler:
    """Per-APID CCSDS packet -> GRB file payload assembly
    (payload_assembler.cpp; CRC-32 = zlib poly 0xEDB88320, goes/crc32.h)."""

    def __init__(self, processor: "GRBDataProcessor", ignore_crc: bool = False):
        self.current: Dict[int, GRBFilePayload] = {}
        self.processor = processor
        self.ignore_crc = ignore_crc

    def _crc_ok(self, pkt: CCSDSPacket) -> bool:
        if len(pkt.payload) < 4:
            return False
        sent = int.from_bytes(pkt.payload[-4:], "big")
        full = bytes(pkt.header.raw[:6]) + bytes(pkt.payload[:-4])
        return zlib.crc32(full) & 0xFFFFFFFF == sent

    def work(self, pkt: CCSDSPacket) -> None:
        if pkt.header.packet_length + 1 != len(pkt.payload):
            return
        cur = self.current.setdefault(pkt.header.apid, GRBFilePayload())
        sf = pkt.header.sequence_flag
        if sf in (1, 3):                      # first / standalone
            if cur.in_progress and cur.valid:
                self.processor.process_payload(cur)
            cur = self.current[pkt.header.apid] = GRBFilePayload()
            if not self._crc_ok(pkt) and not self.ignore_crc:
                logger.error("GRB: invalid CRC, discarding payload")
                return
            cur.apid = pkt.header.apid
            cur.sec_header = GRBSecondaryHeader(bytes(pkt.payload[:8]))
            cur.payload += pkt.payload[8:-4]
            cur.in_progress = True
            if sf == 3:                       # standalone completes at once
                if cur.valid:
                    self.processor.process_payload(cur)
                cur.in_progress = False
        else:                                 # continuation / last
            if not self._crc_ok(pkt) and not self.ignore_crc:
                cur.in_progress = False
                cur.valid = False
                logger.error("GRB: invalid CRC, discarding payload")
                return
            if cur.in_progress and cur.apid == pkt.header.apid:
                cur.payload += pkt.payload[8:-4]
            if sf == 2 and cur.in_progress:
                if cur.valid:
                    self.processor.process_payload(cur)
                cur.in_progress = False


# ---------------------------------------------------------------------------
# Product assembly
# ---------------------------------------------------------------------------
class ABIImageAssembler:
    """Blocks -> full per-channel canvas (abi_image_assembler.cpp)."""

    def __init__(self, abi_dir: Path, mode: int, zone: int, channel: int,
                 composer: Optional["ABIComposer"] = None):
        self.dir = abi_dir
        self.mode, self.zone, self.channel = mode, zone, channel
        self.timestamp = 0.0
        self.image: Optional[np.ndarray] = None
        self.composer = composer
        self.saved = []

    def _reset(self):
        res, _depth = ABI_CHANNEL_PARAMS[self.channel]
        w, h = ZONE_DIMS[self.zone]
        self.image = np.zeros((int(h / res), int(w / res)), np.uint16)

    def save(self):
        if self.image is None:
            return
        zone = ZONE_NAMES[self.zone]
        ts = _ts_string(self.timestamp)
        d = self.dir / zone / ts
        d.mkdir(parents=True, exist_ok=True)
        fname = d / f"ABI_{zone}_{self.channel}_{ts}.png"
        save_img(self.image, fname)
        self.saved.append(str(fname))
        if self.composer is not None:
            self.composer.feed_channel(self.timestamp, self.channel,
                                       self.image)
        self.image = None

    def push_block(self, hdr: GRBImagePayloadHeader, block: np.ndarray):
        if block.size == 0:
            return
        if self.timestamp != hdr.utc_time:
            if self.image is not None:
                self.save()
            self._reset()
            self.timestamp = hdr.utc_time
        _res, depth = ABI_CHANNEL_PARAMS[self.channel]
        block = (block.astype(np.uint16) << (16 - depth))
        y = hdr.left_y_coord + hdr.row_offset_image_block
        x = hdr.left_x_coord
        h = min(block.shape[0], self.image.shape[0] - y)
        w = min(block.shape[1], self.image.shape[1] - x)
        if h > 0 and w > 0 and y >= 0 and x >= 0:
            self.image[y: y + h, x: x + w] = block[:h, :w]


class ABIComposer:
    """Per-zone channel compositor (abi_image_composer.cpp): RGB135 when
    channels 1/3/5 are present for one timestamp."""

    def __init__(self, abi_dir: Path, zone: int):
        self.dir = abi_dir
        self.zone = zone
        self.timestamp = 0.0
        self.channels: Dict[int, np.ndarray] = {}
        self.saved = []

    def feed_channel(self, timestamp: float, ch: int, img: np.ndarray):
        if timestamp != self.timestamp:
            self.save()
            self.channels = {}
            self.timestamp = timestamp
        self.channels[ch] = img

    def save(self):
        if {1, 3, 5} <= set(self.channels):
            r, g, b = (self.channels[5], self.channels[3], self.channels[1])
            h = min(x.shape[0] for x in (r, g, b))
            w = min(x.shape[1] for x in (r, g, b))
            compo = np.stack([r[:h, :w], g[:h, :w], b[:h, :w]], axis=-1)
            zone = ZONE_NAMES[self.zone]
            ts = _ts_string(self.timestamp)
            d = self.dir / zone / ts
            d.mkdir(parents=True, exist_ok=True)
            fname = d / f"ABI_{zone}_RGB135_{ts}.png"
            save_img(compo, fname)
            self.saved.append(str(fname))
        self.channels = {}


class SUVIImageAssembler:
    """SUVI 1280x1280 canvas (suvi_image_assembler.cpp; no depth scale)."""

    def __init__(self, suvi_dir: Path, channel: str):
        self.dir = suvi_dir
        self.channel = channel
        self.timestamp = 0.0
        self.image: Optional[np.ndarray] = None
        self.saved = []

    def save(self):
        if self.image is None:
            return
        d = self.dir / self.channel
        d.mkdir(parents=True, exist_ok=True)
        fname = d / f"SUVI_{self.channel}_{_ts_string(self.timestamp)}.png"
        save_img(self.image, fname)
        self.saved.append(str(fname))
        self.image = None

    def push_block(self, hdr: GRBImagePayloadHeader, block: np.ndarray):
        if block.size == 0:
            return
        if self.timestamp != hdr.utc_time:
            if self.image is not None:
                self.save()
            self.image = np.zeros((1280, 1280), np.uint16)
            self.timestamp = hdr.utc_time
        y = hdr.left_y_coord + hdr.row_offset_image_block
        x = hdr.left_x_coord
        h = min(block.shape[0], 1280 - y)
        w = min(block.shape[1], 1280 - x)
        if h > 0 and w > 0 and y >= 0 and x >= 0:
            self.image[y: y + h, x: x + w] = block.astype(np.uint16)[:h, :w]


def parse_glm_frame(data: bytes, kind: int) -> dict:
    """GLM event/flash/group record parse (glm_parser.cpp; little-endian
    raw-cast layout, group records are 24 bytes not the documented 28)."""
    out: dict = {}
    if len(data) < 8:
        return out
    count = struct.unpack_from("<Q", data, 0)[0]
    recs = []
    if kind == GLM_FLASH:
        out["number_of_flashes"] = count
        for i in range(8, min(8 + count * 24, len(data) - 23), 24):
            f = struct.unpack_from("<5H2f3H", data, i)
            recs.append(dict(zip(
                ["flash_id", "flash_time_offset_of_first_event",
                 "flash_time_offset_of_last_event",
                 "flash_frame_time_offset_of_first_event",
                 "flash_frame_time_offset_of_last_event",
                 "flash_lat", "flash_lon", "flash_area", "flash_energy",
                 "flash_quality_flag"], f)))
    elif kind == GLM_GROUP:
        out["number_of_groups"] = count
        for i in range(8, min(8 + count * 24, len(data) - 23), 24):
            f = struct.unpack_from("<I2H2f4H", data, i)
            recs.append(dict(zip(
                ["group_id", "group_time_offset", "group_frame_time_offset",
                 "group_lat", "group_lon", "group_area", "group_energy",
                 "group_parent_flash_id", "group_quality_flag"], f)))
    elif kind == GLM_EVENT:
        out["number_of_events"] = count
        for i in range(8, min(8 + count * 16, len(data) - 15), 16):
            f = struct.unpack_from("<I4HI", data, i)
            recs.append(dict(zip(
                ["event_id", "event_time_offset", "event_lat", "event_lon",
                 "event_energy", "event_parent_group_id"], f)))
    out["records"] = recs
    return out


class GRBDataProcessor:
    """Dispatch assembled GRB payloads to product assemblers
    (data_processor.cpp)."""

    def __init__(self, directory: str):
        self.dir = Path(directory)
        abi_dir = self.dir / "ABI"
        self.composers = {z: ABIComposer(abi_dir, z)
                          for z in (FULL_DISK, CONUS, MESO_1, MESO_2)}
        self.abi: Dict[int, ABIImageAssembler] = {}
        self.suvi: Dict[int, SUVIImageAssembler] = {}
        self.counts = {"abi_blocks": 0, "suvi_blocks": 0, "glm": 0,
                       "meta": 0, "info": 0}

    def _image_block(self, payload: GRBFilePayload) -> np.ndarray:
        """Decode the image payload (data_processor.cpp get_image_product)."""
        hdr = GRBImagePayloadHeader(bytes(payload.payload[:34]))
        size = min(hdr.byte_offset_dqf, len(payload.payload) - 34)
        raw = bytes(payload.payload[34: 34 + max(size, 0)])
        if hdr.compression_algorithm == COMP_NONE:
            h = hdr.image_block_height - hdr.row_offset_image_block
            w = hdr.image_block_width
            need = h * w * 2
            arr = np.frombuffer(raw[:need].ljust(need, b"\0"), "<u2")
            return arr.reshape(h, w).copy()
        if hdr.compression_algorithm == COMP_J2K:
            try:
                return decompress_j2k(raw)
            except Exception as e:
                logger.warning(f"GRB J2K decode failed: {e}")
                return np.zeros((0, 0), np.uint16)
        logger.error("GRB: SZIP compression not expected on GRB")
        return np.zeros((0, 0), np.uint16)

    def _write_xml(self, subdir: str, name: str, payload: GRBFilePayload):
        d = self.dir / subdir
        d.mkdir(parents=True, exist_ok=True)
        with open(d / f"{name}.xml", "wb") as f:
            f.write(bytes(payload.payload[21:]))
        self.counts["meta"] += 1

    def process_payload(self, p: GRBFilePayload) -> None:
        var = p.sec_header.grb_payload_variant
        if p.apid in ABI_IMAGE_PRODUCTS and var in (VARIANT_IMAGE,
                                                    VARIANT_IMAGE_DQF):
            mode, zone, ch = ABI_IMAGE_PRODUCTS[p.apid]
            hdr = GRBImagePayloadHeader(bytes(p.payload[:34]))
            if p.apid not in self.abi:
                self.abi[p.apid] = ABIImageAssembler(
                    self.dir / "ABI", mode, zone, ch, self.composers[zone])
            self.abi[p.apid].push_block(hdr, self._image_block(p))
            self.counts["abi_blocks"] += 1
        if p.apid in ABI_IMAGE_PRODUCTS_META and var == VARIANT_GENERIC:
            mode, zone, ch = ABI_IMAGE_PRODUCTS_META[p.apid]
            g = GRBGenericPayloadHeader(bytes(p.payload[:21]))
            ts = _ts_string(g.utc_time)
            self._write_xml(f"ABI/{ZONE_NAMES[zone]}/{ts}",
                            f"ABI_{ZONE_NAMES[zone]}_{ch}_{ts}", p)
        if p.apid in SUVI_IMAGE_PRODUCTS and var in (VARIANT_IMAGE,
                                                     VARIANT_IMAGE_DQF):
            ch = SUVI_IMAGE_PRODUCTS[p.apid]
            hdr = GRBImagePayloadHeader(bytes(p.payload[:34]))
            if p.apid not in self.suvi:
                self.suvi[p.apid] = SUVIImageAssembler(self.dir / "SUVI", ch)
            self.suvi[p.apid].push_block(hdr, self._image_block(p))
            self.counts["suvi_blocks"] += 1
        if p.apid in SUVI_IMAGE_PRODUCTS_META and var == VARIANT_GENERIC:
            ch = SUVI_IMAGE_PRODUCTS_META[p.apid]
            g = GRBGenericPayloadHeader(bytes(p.payload[:21]))
            self._write_xml(f"SUVI/{ch}",
                            f"SUVI_{ch}_{_ts_string(g.utc_time)}", p)
        if p.apid in GLM_PRODUCTS and var == VARIANT_GENERIC:
            g = GRBGenericPayloadHeader(bytes(p.payload[:21]))
            kind = GLM_PRODUCTS[p.apid]
            if kind == GLM_META:
                self._write_xml("GLM/Meta", _ts_string(g.utc_time), p)
            else:
                sub = {GLM_FLASH: "Flash", GLM_EVENT: "Event",
                       GLM_GROUP: "Group"}[kind]
                d = self.dir / "GLM" / sub
                d.mkdir(parents=True, exist_ok=True)
                data = parse_glm_frame(bytes(p.payload[21:]), kind)
                with open(d / f"{_ts_string(g.utc_time)}.json", "w") as f:
                    json.dump(data, f, indent=4)
                self.counts["glm"] += 1
        if p.apid == APID_GRB_INFO and var == VARIANT_GENERIC:
            g = GRBGenericPayloadHeader(bytes(p.payload[:21]))
            self._write_xml("Information", _ts_string(g.utc_time), p)
            self.counts["info"] += 1

    def flush(self):
        for a in self.abi.values():
            a.save()
        for s in self.suvi.values():
            s.save()
        for c in self.composers.values():
            c.save()


@register_module
class GRBDataDecoderModule(ProcessingModule):
    """CADU (2048 B) -> GRB products (module_goes_grb_data_decoder.cpp)."""

    id = "goes_grb_data_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.ignore_crc = bool(self.param("ignore_crc", False))

    def process(self):
        out_dir = str(Path(self.d_output_file_hint).parent)
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        processor = GRBDataProcessor(out_dir)
        assembler_rhcp = GRBPayloadAssembler(processor, self.ignore_crc)
        assembler_lhcp = GRBPayloadAssembler(processor, self.ignore_crc)
        demux_rhcp = Demuxer(mpdu_data_size=2034)
        demux_lhcp = Demuxer(mpdu_data_size=2034)

        data = np.fromfile(self.d_input_file, dtype=np.uint8)
        n = len(data) // CADU_SIZE
        for i in range(n):
            cadu = data[i * CADU_SIZE: (i + 1) * CADU_SIZE]
            vcdu = parse_vcdu(cadu)
            if vcdu.vcid == 63:
                continue
            if vcdu.vcid == 5:        # RHCP
                dem, asm_ = demux_rhcp, assembler_rhcp
            elif vcdu.vcid == 6:      # LHCP
                dem, asm_ = demux_lhcp, assembler_lhcp
            else:
                continue
            for pkt in dem.work(cadu):
                if pkt.header.apid == 2047:
                    continue
                asm_.work(pkt)
        processor.flush()
        self.stats = dict(processor.counts, cadus=n)
        logger.info(f"GRB data decoder: {self.stats}")
