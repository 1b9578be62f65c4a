"""Himawari Standard Data (HSD) AHI ingest.

One HSD file = one channel segment: 12 variable-length header blocks
(basic / data / projection / navigation / calibration / inter-cal /
segment / nav-correction / obs-time / error / spare / data) chained by a
little-endian u16 block length at offset +1, usually bzip2-compressed.
Segments of the same channel accumulate into one full-disk image keyed by
the segment number; the product carries the geos projection derived from
CFAC/COFF and the scale/offset/kappa radiometric calibration.

Behavioral reference: plugins/firstparty_support/processors/hsd/himawari/
ahi_hsd.cpp:17-250 (block walk, field offsets, 65534-and-up fill pixels,
the 2^16/CFAC * 624597.033 scalar). Vectorized: the whole segment's u16
pixel block is placed with one slice assignment.
"""

from __future__ import annotations

import bz2
import struct
from typing import Dict

import numpy as np

from satdump_tpu_torch.products.calibration import (ImageCalibrator,
                                                    calibrator_registry)
from satdump_tpu_torch.products.image_product import (ChannelTransform,
                                                      ImageProduct)

(B_BASIC, B_DATA, B_PROJ, B_NAV, B_CAL, B_INTERCAL, B_SEGMENT,
 B_NAVCORR, B_OBSTIME, B_ERROR, B_SPARE, B_DATABLOCK) = range(12)


class AhiHsdAccumulator:
    """Feed segment files with add_file(); finish with to_product()."""

    def __init__(self):
        self.channels: Dict[int, dict] = {}

    def add_file(self, data: bytes) -> bool:
        if data[:3] == b"BZh":
            data = bz2.decompress(data)  # handles concatenated streams

        offs = [0]
        for i in range(1, 12):
            blen = struct.unpack_from("<H", data, offs[-1] + 1)[0]
            nxt = offs[-1] + blen
            if nxt > len(data) or (i < 11 and data[nxt] != i + 1):
                return False
            offs.append(nxt)

        if data[offs[B_DATA] + 9] != 0:
            return False  # data block itself compressed: not distributed

        ncols, nlines_seg = struct.unpack_from("<HH", data, offs[B_DATA] + 5)
        bit_depth = data[offs[B_CAL] + 13]
        # segment block: +3 total segments (u8), +4 sequence number (u8),
        # +5 FIRST LINE NUMBER of this segment (u16, 1-based) — the pixel
        # placement key (ref ahi_hsd.cpp:71 pixel_offset = ncols*(val-1))
        first_line = struct.unpack_from("<H", data, offs[B_SEGMENT] + 5)[0]
        channel = struct.unpack_from("<H", data, offs[B_CAL] + 3)[0]
        if not 1 <= channel <= 16:
            return False

        st = self.channels.get(channel - 1)
        if st is None:
            nsegs = data[offs[B_SEGMENT] + 3]
            name_raw = data[offs[B_BASIC] + 6:offs[B_BASIC] + 22]
            mjd, = struct.unpack_from("<d", data, offs[B_BASIC] + 46)
            lon, cfac, lfac, coff, loff = struct.unpack_from(
                "<diiff", data, offs[B_PROJ] + 3)
            dist_ec, eq_radius = struct.unpack_from(
                "<dd", data, offs[B_PROJ] + 27)
            wavelength_um, = struct.unpack_from("<d", data, offs[B_CAL] + 5)
            cal_scale, cal_offset = struct.unpack_from(
                "<dd", data, offs[B_CAL] + 19)
            kappa = (struct.unpack_from("<d", data, offs[B_CAL] + 35)[0]
                     if channel < 7 else -999.0)
            st = self.channels[channel - 1] = {
                "img": np.zeros((nlines_seg * nsegs, ncols), np.uint16),
                "sat_name": name_raw.split(b"\x00")[0].decode("latin-1"),
                "timestamp": (mjd - 40587.0) * 86400.0,
                "longitude": lon, "cfac": cfac, "lfac": lfac,
                "coff": coff, "loff": loff,
                "altitude": (dist_ec - eq_radius) * 1000.0,
                "wavenumber": 1e4 / wavelength_um,
                "scale": cal_scale / (2 ** (16 - bit_depth)),
                "offset": cal_offset, "kappa": kappa,
            }

        px = np.frombuffer(
            data, np.dtype("<u2"), ncols * nlines_seg, offs[B_DATABLOCK]
        ).astype(np.uint16)
        px = np.where(px >= 65534, 0, px) << (16 - bit_depth)
        line0 = first_line - 1
        if line0 + nlines_seg > st["img"].shape[0]:
            return False
        st["img"][line0:line0 + nlines_seg] = px.reshape(nlines_seg, ncols)
        return True

    def to_product(self) -> ImageProduct:
        p = ImageProduct()
        p.instrument_name = "ahi"
        big = max(self.channels.values(), key=lambda s: s["img"].size)
        bh, bw = big["img"].shape
        p.set_product_timestamp(big["timestamp"])
        p.set_product_source(big["sat_name"] or "Himawari")

        k = 624597.0334223134
        sx = (2.0 ** 16 / big["cfac"]) * k
        sy = (2.0 ** 16 / big["lfac"]) * k
        p.set_proj_cfg({
            "type": "geos", "lon0": big["longitude"], "sweep_x": False,
            "scalar_x": sx, "scalar_y": -sy,
            "offset_x": -sx * big["coff"], "offset_y": sy * big["loff"],
            "width": bw, "height": bh, "altitude": big["altitude"],
        })

        cal = {"scale": [0.0] * 16, "offset": [0.0] * 16,
               "kappa": [-999.0] * 16, "spectral": True}
        for ch in sorted(self.channels):
            st = self.channels[ch]
            h, w = st["img"].shape
            p.add_channel(st["img"], str(ch + 1), abs_index=ch, bit_depth=16,
                          wavenumber=st["wavenumber"],
                          calibration_type=("albedo" if st["kappa"] > 0
                                            else "emissive_radiance"),
                          ch_transform=ChannelTransform.affine(
                              bw / w, bh / h, 0, 0))
            cal["scale"][ch] = st["scale"]
            cal["offset"][ch] = st["offset"]
            cal["kappa"][ch] = st["kappa"]
        p.set_calibration("goes_nc_abi", {"vars": cal})
        return p


class GoesNcAbiCalibrator(ImageCalibrator):
    """Radiance = offset + counts*scale (scale pre-divided to the stored
    16-bit range). Reflective channels (kappa>0) -> albedo fraction =
    kappa*radiance; emissive channels with spectral=true -> band spectral
    radiance converted to radiance at the channel wavenumber (ref
    abi_nc_calibrator.h:40-54 compute(), exact same branch structure)."""

    def _wavenumber(self, channel_idx: int) -> float:
        for h in getattr(self.product, "images", []):
            if h.abs_index == channel_idx:
                return h.wavenumber or 0.0
        return 0.0

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        from satdump_tpu_torch.products.calibration import \
            spectral_radiance_to_radiance
        v = self.cfg["vars"]
        c = np.asarray(counts, np.float64)
        rad = v["offset"][channel_idx] + c * v["scale"][channel_idx]
        kappa = v.get("kappa", [-999.0] * 16)[channel_idx]
        if kappa > 0:
            return kappa * rad
        if v.get("spectral"):
            return spectral_radiance_to_radiance(
                rad, self._wavenumber(channel_idx))
        return rad


calibrator_registry.register("goes_nc_abi", GoesNcAbiCalibrator)
