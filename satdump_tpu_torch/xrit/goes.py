"""GOES-R HRIT/LRIT data decoder: .cadu -> LRIT files, images, products.

Reference behavior: plugins/goes_support/goes/hrit/
module_goes_lrit_data_decoder{,_proc}.cpp — an XRITDemux with GOES hooks:
Rice-compressed image packets (NOAA compression 1) are decompressed
per CCSDS packet with missing-line fill keyed on the packet sequence
counter; finished files are routed by type: ABI images (NOAA product_id
16..19) are segment-assembled into full images, EMWIN text saved, admin
messages saved, everything else stored raw.

Counterpart of satdump_tpu/xrit/goes.py (host NumPy, copied): images go
through the port's own PNG codec (`image/io.save_img`), the Rice decoder is
the port's build of `native/rice.c`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image.io import save_img
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.xrit import (AncillaryTextRecord, ImageStructureRecord,
                              ImageNavigationRecord, NOAALRITHeader,
                              PrimaryHeader, RiceCompressionHeader,
                              SegmentIdentificationHeader, TimeStampRecord,
                              XRITDemux, XRITFile)
from satdump_tpu_torch.xrit.rice import rice_decode


@dataclasses.dataclass
class GOESFileInfo:
    """Identification subset of xrit/identify.cpp identifyGOESFile."""
    satellite: str = ""
    channel: str = ""
    region: str = ""
    timestamp: float = 0.0
    bit_depth: int = 8
    is_abi: bool = False


def identify_goes(f: XRITFile) -> Optional[GOESFileInfo]:
    if not f.has_header(NOAALRITHeader):
        return None
    noaa = f.get_header(NOAALRITHeader)
    ph = f.get_header(PrimaryHeader)
    if ph.file_type_code != 0 or not f.has_header(ImageStructureRecord):
        return None
    info = GOESFileInfo()
    info.bit_depth = f.get_header(ImageStructureRecord).bit_per_pixel
    if f.has_header(TimeStampRecord):
        info.timestamp = f.get_header(TimeStampRecord).timestamp
    if noaa.product_id in (16, 17, 18, 19):
        info.is_abi = True
        info.satellite = f"GOES-{noaa.product_id}"
        parts = f.filename.split("-")
        if len(parts) >= 4:
            m = re.match(r"M(\d)C(\d{2})", parts[3])
            if m:
                info.channel = str(int(m.group(2)))
            else:
                # L2 products (no channel number): use the product name
                info.channel = parts[2].rstrip("FC")
        if f.has_header(AncillaryTextRecord):
            meta = f.get_header(AncillaryTextRecord).meta
            info.region = meta.get("Region", "")
        return info
    info.satellite = f"GOES-{noaa.product_id}"
    info.channel = str(noaa.product_subid)
    return info


class SegmentedImageAssembler:
    """GOES segmented full-image assembler (xrit/goes/segment_decoder.h)."""

    def __init__(self, f: XRITFile):
        seg = f.get_header(SegmentIdentificationHeader)
        isr = f.get_header(ImageStructureRecord)
        self.image_id = seg.image_identifier
        self.seg_count = max(seg.max_segment, 1)
        width = seg.max_column or isr.columns_count
        height = seg.max_row or self.seg_count * isr.lines_count
        self.image = np.zeros((height, width), np.uint8)
        self.seg_height = height // self.seg_count
        self.done = np.zeros(self.seg_count, bool)

    def push(self, f: XRITFile) -> None:
        seg = f.get_header(SegmentIdentificationHeader)
        s = seg.segment_sequence_number
        if not (0 <= s < self.seg_count):
            return
        data = np.frombuffer(f.data, np.uint8)
        rows = min(len(data) // self.image.shape[1],
                   self.image.shape[0] - s * self.seg_height)
        if rows <= 0:
            return
        self.image[s * self.seg_height: s * self.seg_height + rows] = \
            data[: rows * self.image.shape[1]].reshape(rows, -1)
        self.done[s] = True

    @property
    def complete(self) -> bool:
        return bool(self.done.all())


RICE_FLAG = 1


@register_module
class GOESLRITDataDecoderModule(ProcessingModule):
    id = "goes_lrit_data_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.write_images = bool(self.param("write_images", True))
        self.write_emwin = bool(self.param("write_emwin", True))
        self.write_messages = bool(self.param("write_messages", True))
        self.write_lrit = bool(self.param("write_lrit", False))
        self.write_unknown = bool(self.param("write_unknown", False))
        self.fill_missing = bool(self.param("fill_missing", False))
        self.max_fill_lines = int(self.param("max_fill_lines", 50))
        self._rice_params: Dict[str, dict] = {}
        self._assemblers: Dict[str, SegmentedImageAssembler] = {}
        self._asm_meta: Dict[str, GOESFileInfo] = {}

    # -- Rice hookup (module_goes_lrit_data_decoder.cpp:76-165) --------------
    def _on_parse_header(self, f: XRITFile) -> None:
        f.custom_flags[RICE_FLAG] = False
        if not f.has_header(ImageStructureRecord):
            return
        isr = f.get_header(ImageStructureRecord)
        if not f.has_header(NOAALRITHeader):
            return
        noaa = f.get_header(NOAALRITHeader)
        if isr.compression_flag == 1 and noaa.noaa_specific_compression == 1:
            f.custom_flags[RICE_FLAG] = True
            p = {"bits_per_pixel": isr.bit_per_pixel,
                 "pixels_per_block": 16,
                 "pixels_per_scanline": isr.columns_count}
            if f.has_header(RiceCompressionHeader):
                rh = f.get_header(RiceCompressionHeader)
                if rh.pixels_per_block > 0:
                    p["pixels_per_block"] = rh.pixels_per_block
            self._rice_params[f.filename] = p

    def _on_process_data(self, f: XRITFile, pkt, bad_crc: bool) -> bool:
        if not f.custom_flags.get(RICE_FLAG):
            return True
        if self.fill_missing and bad_crc:
            return False
        p = self._rice_params.get(f.filename)
        if not p:
            return False
        line = rice_decode(bytes(pkt.payload)[:-2], p["pixels_per_scanline"],
                           p["bits_per_pixel"], p["pixels_per_block"])
        if line is None:
            return False
        # missing-line handling via the sequence counter
        diff = (pkt.header.packet_sequence_count
                - f.last_tracked_counter) % 16384
        if diff > 1:
            isr = f.get_header(ImageStructureRecord)
            to_fill = p["pixels_per_scanline"] * (diff - 1)
            max_fill = (isr.columns_count * isr.lines_count
                        + f.total_header_length
                        - (len(f.lrit_data) + len(line)))
            if to_fill <= max_fill:
                if self.fill_missing and diff <= self.max_fill_lines:
                    f.lrit_data += line.tobytes() * (diff - 1)
                else:
                    f.lrit_data += bytes(to_fill)
        f.last_tracked_counter = pkt.header.packet_sequence_count
        f.lrit_data += line.tobytes()
        return False  # we already appended the decompressed payload

    # -- file routing (module_goes_lrit_data_decoder_proc.cpp) ---------------
    def _route_file(self, f: XRITFile, directory: str) -> None:
        ph = f.get_header(PrimaryHeader)
        noaa = f.get_header(NOAALRITHeader) if f.has_header(NOAALRITHeader) \
            else None
        if self.write_lrit:
            self._save_raw(f, os.path.join(directory, "LRIT"))
        if ph.file_type_code == 0 and f.has_header(ImageStructureRecord):
            if not self.write_images:
                return
            info = identify_goes(f)
            if info and info.is_abi and \
                    f.has_header(SegmentIdentificationHeader):
                key = f"{info.satellite}_{info.channel}"
                seg = f.get_header(SegmentIdentificationHeader)
                a = self._assemblers.get(key)
                if a is None or a.image_id != seg.image_identifier:
                    if a is not None:
                        self._flush_image(key, directory)
                    a = SegmentedImageAssembler(f)
                    self._assemblers[key] = a
                    self._asm_meta[key] = info
                a.push(f)
                if a.complete:
                    self._flush_image(key, directory)
            else:
                isr = f.get_header(ImageStructureRecord)
                img = np.frombuffer(f.data, np.uint8)
                need = isr.columns_count * isr.lines_count
                if len(img) >= need and need > 0:
                    img = img[:need].reshape(isr.lines_count,
                                             isr.columns_count)
                    os.makedirs(os.path.join(directory, "IMAGES"),
                                exist_ok=True)
                    save_img(img, os.path.join(directory, "IMAGES",
                                               f.filename + ".png"))
                    self._nimages += 1
        elif ph.file_type_code == 2 and noaa is not None and \
                noaa.product_id in (6, 9):
            if self.write_emwin and noaa.noaa_specific_compression == 0:
                d = os.path.join(directory, "EMWIN")
                os.makedirs(d, exist_ok=True)
                base = f.filename.rsplit(".", 1)[0] or f"emwin_{self._nfiles}"
                with open(os.path.join(d, base + ".txt"), "wb") as fo:
                    fo.write(f.data)
        elif ph.file_type_code in (1, 2):
            if self.write_messages:
                d = os.path.join(directory, "Admin Messages")
                os.makedirs(d, exist_ok=True)
                base = f.filename.rsplit(".", 1)[0] or f"msg_{self._nfiles}"
                with open(os.path.join(d, base + ".txt"), "wb") as fo:
                    fo.write(f.data)
        elif self.write_unknown and not self.write_lrit:
            self._save_raw(f, os.path.join(directory, "LRIT"))

    def _save_raw(self, f: XRITFile, d: str) -> None:
        os.makedirs(d, exist_ok=True)
        name = f.filename or f"file_{self._nfiles}.lrit"
        with open(os.path.join(d, name), "wb") as fo:
            fo.write(bytes(f.lrit_data))

    def _flush_image(self, key: str, directory: str) -> None:
        a = self._assemblers.pop(key, None)
        info = self._asm_meta.pop(key, None)
        if a is None or not a.done.any():
            return
        os.makedirs(os.path.join(directory, "IMAGES"), exist_ok=True)
        name = f"{info.satellite}_{info.channel}_{a.image_id}"
        save_img(a.image, os.path.join(directory, "IMAGES", name + ".png"))
        prod = ImageProduct()
        prod.instrument_name = "abi"
        prod.set_product_timestamp(info.timestamp)
        prod.set_product_source(info.satellite)
        prod.add_channel(a.image, info.channel, bit_depth=8)
        pdir = os.path.join(directory, f"ABI_{info.channel}_{a.image_id}")
        prod.save(pdir)
        self._dataset.products_list.append(os.path.basename(pdir))
        self._nimages += 1

    def process(self):
        directory = os.path.dirname(self.d_output_file_hint) or "."
        os.makedirs(directory, exist_ok=True)
        self.d_output_file = directory
        self._nfiles = 0
        self._nimages = 0
        self._dataset = DataSet(satellite_name="GOES-R", timestamp=0.0)
        demux = XRITDemux()
        demux.on_parse_header = self._on_parse_header
        demux.on_process_data = self._on_process_data
        cadus = np.fromfile(self.d_input_file, np.uint8)
        n = (len(cadus) // 1024) * 1024
        for i in range(0, n, 1024):
            for f in demux.work(cadus[i: i + 1024]):
                self._nfiles += 1
                self._route_file(f, directory)
        for f in demux.flush():
            self._nfiles += 1
            self._route_file(f, directory)
        for key in list(self._assemblers):
            self._flush_image(key, directory)
        if self._dataset.products_list:
            self._dataset.save(directory)
        self.stats = {"files": self._nfiles, "images": self._nimages}
        logger.info(f"GOES LRIT: {self._nfiles} files, "
                    f"{self._nimages} images")
