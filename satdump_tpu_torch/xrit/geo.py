"""Himawari (AHI via HimawariCast), ELEKTRO-L (MSU-GS) and MSG (SEVIRI)
xRIT imagery processors.

Behavioral equivalents of plugins/xrit_support/xrit/{himawari,elektro,msg}/
plus the identification rules of xrit/identify.cpp:
* Himawari: ``IMG_DK01<ch>_<YYYYmmddHHMM>_<seg>`` names, 10 segments, JPEG
  or raw payloads; 16-bit payloads are big-endian and auto-shifted to
  16-bit range (processor/get_img.h:67-100).
* Elektro / MSG: dash-separated EUMETSAT names
  (``H-000-GOMS3_...-<channel>-...-<YYYYmmddHHMM>-__``), the MSG-style
  segment identification header (type 128: channel id, segment number,
  planned start/end, compression), JPEG (flag 2, incl. native 12-bit) and
  wavelet (DecompWT, flag 1 — xrit/decompwt.py) decompression; segments
  whose WT stream fails to parse are preserved raw under WAVELET_RAW.

Counterpart of satdump_tpu/xrit/geo.py (host code, copied) on the port's
own codecs, since the card's machine has no Pillow: 8-bit JPEG segments go
through `image/jpeg.py::decode_jpeg_gray` (libjpeg's islow IDCT, so the
pixels equal Pillow's; its IDCT on the module's `torch_device`), 12-bit
ones through the port's build of `native/jpeg12.c`, wavelet ones through
its build of `native/decompwt.c`. A stream the 8-bit decoder does not take
(progressive, arithmetic-coded, colour) is logged and skipped, as the JAX
module does with a segment Pillow fails on.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image.io import save_img
from satdump_tpu_torch.image.jpeg import decode_jpeg_gray
from satdump_tpu_torch.image.jpeg12 import decompress_jpeg12
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.utils.device import is_device_fault, resolve_device
from satdump_tpu_torch.xrit import (ImageStructureRecord, PrimaryHeader,
                                    XRITDemux, XRITFile)
from satdump_tpu_torch.xrit.decompwt import wt_decompress

SEG_ID_TYPE = 128

# HimawariCast channel-name map (identify.cpp:459-487)
HIMAWARI_CHANNELS = {
    "DK01VIS": "3", "DK01IR4": "7", "DK01IR3": "8", "DK01IR1": "13",
    "DK01IR2": "15", "DK01B04": "4", "DK01B05": "5", "DK01B06": "6",
    "DK01B09": "9", "DK01B10": "10", "DK01B11": "11", "DK01B12": "12",
    "DK01B14": "14", "DK01B16": "16",
}


class MSGSegId:
    """msg_headers.h SegmentIdentificationHeader (type 128, 13 bytes)."""

    def __init__(self, d: bytes):
        self.sc_id = d[3] << 8 | d[4]
        self.channel_id = d[5]
        self.segment_sequence_number = d[6] << 8 | d[7]
        self.planned_start_segment = d[8] << 8 | d[9]
        self.planned_end_segment = d[10] << 8 | d[11]
        self.compression = d[12]


def _payload_image(f: XRITFile, himawari_be: bool = False,
                   device=None) -> Optional[np.ndarray]:
    """Decompress/deserialize one segment (get_img.h + per-sat decomp);
    an 8-bit JPEG's IDCT runs on `device`."""
    ph = f.get_header(PrimaryHeader)
    isr = f.get_header(ImageStructureRecord)
    payload = bytes(f.lrit_data[ph.total_header_length:])
    w, h = isr.columns_count, isr.lines_count
    if isr.compression_flag == 2:          # JPEG
        try:
            if isr.bit_per_pixel > 8:      # 12-bit: native decoder
                img = decompress_jpeg12(payload)
                if img is not None:
                    return img
            return decode_jpeg_gray(payload, device)
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.warning(f"xRIT JPEG decode failed ({f.filename}): {e}")
            return None
    if isr.compression_flag == 1:          # wavelet (MSG DecompWT)
        # S+P wavelet + arithmetic coding (EUMETSAT HRIT standard
        # compression; ref xrit/msg/decomp.cpp:86-95 DecompressWT). The
        # segment-ID header's compression field may say 2 (T4) which we
        # don't support; 0/3/absent all mean WT in practice.
        r = wt_decompress(payload, w, h, isr.bit_per_pixel)
        if r is None:
            logger.warning(f"WT decompression failed ({f.filename})")
            return None
        arr, qual = r
        bad = int((qual < w).sum())
        if bad:
            logger.warning(f"WT segment {f.filename}: {bad}/{h} "
                           "damaged lines")
        if isr.bit_per_pixel > 8:
            return arr
        return arr.astype(np.uint8)
    need = w * h * (2 if isr.bit_per_pixel > 8 else 1)
    if len(payload) < need:
        return None
    if isr.bit_per_pixel > 8:
        arr = np.frombuffer(payload[:need], ">u2").reshape(h, w).copy()
        if himawari_be:
            # auto bit-depth normalization (get_img.h:80-98)
            v0 = int(arr.flat[0])
            shift = 2 if v0 >= 16383 else (4 if v0 >= 4095 else 6)
            arr = (arr << shift).astype(np.uint16)
        return arr
    return np.frombuffer(payload[:need], np.uint8).reshape(h, w).copy()


def identify_himawari(f: XRITFile) -> Optional[Tuple[str, str, int]]:
    """-> (channel, groupid, segment) for IMG_DK01... names."""
    parts = f.filename.split("_")
    if len(parts) != 4 or parts[0] != "IMG" or "DK01" not in parts[1]:
        return None
    ch = HIMAWARI_CHANNELS.get(f.filename[4:11])
    if ch is None:
        return None
    try:
        seg = int(f.filename[-3:] if not f.filename.endswith(".lrit")
                  else f.filename[-8:-5]) - 1
    except ValueError:
        seg = int(parts[3].split(".")[0]) - 1
    return ch, parts[2], seg


def identify_eumetsat(f: XRITFile) -> Optional[Tuple[str, str, str]]:
    """-> (satellite, channel_name, groupid) for H-000-GOMS/MSG names."""
    parts = f.filename.split("-")
    if len(parts) < 8 or parts[0] not in ("H", "L") or parts[1] != "000":
        return None
    sat = parts[2].strip("_")
    channel = parts[4].strip("_") or "?"
    group = parts[6].strip("_")
    return sat, channel, group


class GeoSegmentAssembler:
    def __init__(self, total: int, width: int, seg_height: int,
                 depth16: bool):
        self.total = max(total, 1)
        self.seg_height = seg_height
        self.image = np.zeros((seg_height * self.total, width),
                              np.uint16 if depth16 else np.uint8)
        self.done = np.zeros(self.total, bool)

    def push(self, idx: int, img: np.ndarray) -> None:
        if not (0 <= idx < self.total):
            return
        y0 = idx * self.seg_height
        h = min(img.shape[0], self.image.shape[0] - y0)
        w = min(img.shape[1], self.image.shape[1])
        self.image[y0: y0 + h, :w] = img[:h, :w]
        self.done[idx] = True

    @property
    def complete(self) -> bool:
        return bool(self.done.all())


class _GeoXRITModuleBase(ProcessingModule):
    """Shared cadu -> assembled-image machinery."""

    sat_dir = "GEO"
    instrument = ""          # set to emit ImageProducts per time group

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self._assemblers: Dict[str, GeoSegmentAssembler] = {}
        self._groups: Dict[str, Dict[str, np.ndarray]] = {}
        self.images = 0
        self.files = 0
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))

    def _classify(self, f: XRITFile):
        """-> (key, seg_idx, total, himawari_be) or None."""
        raise NotImplementedError

    def _process_file(self, f: XRITFile, out_dir: Path) -> None:
        self.files += 1
        ph = f.get_header(PrimaryHeader)
        if ph.file_type_code != 0 \
                or ImageStructureRecord.TYPE not in f.all_headers:
            d = out_dir / "FILES"
            d.mkdir(parents=True, exist_ok=True)
            (d / (f.filename or f"file_{self.files}")).write_bytes(
                bytes(f.lrit_data))
            return
        info = self._classify(f)
        if info is None:
            return
        key, seg_idx, total, him_be = info
        img = _payload_image(f, himawari_be=him_be, device=self.torch_device)
        if img is None:
            isr = f.get_header(ImageStructureRecord)
            if isr.compression_flag == 1:
                d = out_dir / "WAVELET_RAW"
                d.mkdir(parents=True, exist_ok=True)
                (d / f.filename).write_bytes(bytes(f.lrit_data))
            return
        isr = f.get_header(ImageStructureRecord)
        a = self._assemblers.get(key)
        if a is None:
            a = GeoSegmentAssembler(total, isr.columns_count,
                                    isr.lines_count, isr.bit_per_pixel > 8)
            self._assemblers[key] = a
        a.push(seg_idx, img)
        if a.complete:
            self._flush(key, out_dir)

    def _flush(self, key: str, out_dir: Path) -> None:
        a = self._assemblers.pop(key, None)
        if a is None:
            return
        d = out_dir / "IMAGES" / self.sat_dir
        d.mkdir(parents=True, exist_ok=True)
        save_img(a.image, d / f"{self.sat_dir}_{key}.png")
        self.images += 1
        if self.instrument:
            # key = <channel-ish>_<group>: split on the LAST underscore
            ch, _, group = key.rpartition("_") if "_" in key \
                else (key, "", "all")
            self._groups.setdefault(group, {})[ch or key] = a.image

    def _save_products(self, out_dir: Path) -> None:
        if not self.instrument or not self._groups:
            return
        ds = DataSet(self.sat_dir, -1.0)
        for group, chans in self._groups.items():
            p = ImageProduct()
            p.instrument_name = self.instrument
            for ch, img in sorted(chans.items()):
                p.add_channel(img, ch.lstrip("ch"),
                              bit_depth=16 if img.dtype == np.uint16 else 8)
            name = f"{self.sat_dir}_{group}"
            p.save(str(out_dir / name))
            ds.products_list.append(name)
        ds.save(str(out_dir))

    def process(self):
        out_dir = Path(self.d_output_file_hint).parent
        out_dir.mkdir(parents=True, exist_ok=True)
        self.d_output_file = str(out_dir)
        demux = XRITDemux()
        data = np.fromfile(self.d_input_file, np.uint8)
        n = len(data) // 1024
        for i in range(n):
            for f in demux.work(bytes(data[i * 1024: (i + 1) * 1024])):
                self._process_file(f, out_dir)
        for f in demux.flush():
            self._process_file(f, out_dir)
        for key in list(self._assemblers):
            self._flush(key, out_dir)
        self._save_products(out_dir)
        self.stats = {"files": self.files, "images": self.images}
        logger.info(f"{self.id}: {self.files} files, {self.images} images")


@register_module
class HimawariCastDataDecoderModule(_GeoXRITModuleBase):
    """HimawariCast AHI images (xrit/himawari/segment_decoder.h)."""

    id = "himawaricast_data_decoder"
    sat_dir = "AHI"
    instrument = "ahi"

    def _classify(self, f: XRITFile):
        info = identify_himawari(f)
        if info is None:
            return None
        ch, group, seg = info
        return f"{ch}_{group}", seg, 10, True


@register_module
class ElektroLRITDataDecoderModule(_GeoXRITModuleBase):
    """ELEKTRO-L MSU-GS images (xrit/elektro/, MSG-style segments)."""

    id = "elektro_lrit_data_decoder"
    sat_dir = "MSU-GS"
    instrument = "msu_gs"

    def _classify(self, f: XRITFile):
        info = identify_eumetsat(f)
        if info is None:
            return None
        sat, channel, group = info
        seg_idx, total = 0, 1
        if SEG_ID_TYPE in f.all_headers:
            off = f.all_headers[SEG_ID_TYPE]
            sid = MSGSegId(bytes(f.lrit_data[off: off + 13]))
            total = max(sid.planned_end_segment
                        - sid.planned_start_segment + 1, 1)
            seg_idx = sid.segment_sequence_number - sid.planned_start_segment
            channel = f"ch{sid.channel_id + 1}"
        return f"{sat}_{channel}_{group}", seg_idx, total, False


@register_module
class MSGLRITDataDecoderModule(ElektroLRITDataDecoderModule):
    """MSG SEVIRI images; wavelet-compressed (DecompWT) segments decode
    through the native WT codec (xrit/decompwt.py)."""

    id = "msg_lrit_data_decoder"
    sat_dir = "SEVIRI"
    instrument = "seviri"
