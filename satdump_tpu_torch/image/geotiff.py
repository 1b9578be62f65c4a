"""Minimal standalone GeoTIFF writer/reader (no libtiff/libgeotiff).

Reference behavior: src-core/image/geotiff/geotiff_write.cpp — a TIFF with
ModelTiepointTag (33922), ModelPixelScaleTag (33550) and a
GeoKeyDirectoryTag (34735) declaring ModelTypeGeographic / WGS84, written
for equirectangular products. Here the whole file (header, IFD, strips) is
assembled with struct/NumPy — little-endian, uncompressed, single strip.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

# TIFF tags
T_WIDTH, T_HEIGHT = 256, 257
T_BITS, T_COMPRESSION, T_PHOTO = 258, 259, 262
T_STRIP_OFFSETS, T_SAMPLES, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 277, 278, 279
T_PLANAR = 284
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_GEO_KEYS = 34735

TYPE_SHORT, TYPE_LONG, TYPE_DOUBLE = 3, 4, 12

# GeoKeys: ModelTypeGeographic(2), RasterPixelIsArea(1), GCS WGS84 (4326)
_GEOKEYS = [
    (1024, 0, 1, 2),    # GTModelTypeGeoKey = Geographic
    (1025, 0, 1, 1),    # GTRasterTypeGeoKey = PixelIsArea
    (2048, 0, 1, 4326),  # GeographicTypeGeoKey = WGS84
]


def save_geotiff(img: np.ndarray, path: str | Path,
                 lon_min: float, lat_max: float,
                 lon_res: float, lat_res: float) -> None:
    """img (H, W) or (H, W, C) uint8/uint16 -> GeoTIFF with the top-left
    tiepoint at (lon_min, lat_max) and per-pixel degree scales."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    bits = img.dtype.itemsize * 8
    assert img.dtype in (np.uint8, np.uint16), "8/16-bit only"
    photo = 1 if c == 1 else 2

    pixel_scale = np.asarray([lon_res, lat_res, 0.0], "<f8")
    tiepoint = np.asarray([0.0, 0.0, 0.0, lon_min, lat_max, 0.0], "<f8")
    nkeys = len(_GEOKEYS)
    geokeys = np.asarray(
        [1, 1, 0, nkeys] + [v for k in _GEOKEYS for v in k], "<u2")

    entries = []  # (tag, type, count, value_or_bytes)
    data_blobs = []  # deferred out-of-line values

    def entry(tag, typ, count, value):
        entries.append([tag, typ, count, value])

    strip = img.astype(img.dtype.newbyteorder("<")).tobytes()
    entry(T_WIDTH, TYPE_LONG, 1, w)
    entry(T_HEIGHT, TYPE_LONG, 1, h)
    entry(T_BITS, TYPE_SHORT, c,
          struct.pack(f"<{c}H", *([bits] * c)) if c >= 2 else bits)
    entry(T_COMPRESSION, TYPE_SHORT, 1, 1)
    entry(T_PHOTO, TYPE_SHORT, 1, photo)
    entry(T_STRIP_OFFSETS, TYPE_LONG, 1, "STRIP")
    entry(T_SAMPLES, TYPE_SHORT, 1, c)
    entry(T_ROWS_PER_STRIP, TYPE_LONG, 1, h)
    entry(T_STRIP_COUNTS, TYPE_LONG, 1, len(strip))
    entry(T_PLANAR, TYPE_SHORT, 1, 1)
    entry(T_MODEL_PIXEL_SCALE, TYPE_DOUBLE, 3, pixel_scale.tobytes())
    entry(T_MODEL_TIEPOINT, TYPE_DOUBLE, 6, tiepoint.tobytes())
    entry(T_GEO_KEYS, TYPE_SHORT, len(geokeys), geokeys.tobytes())

    entries.sort(key=lambda e: e[0])
    n = len(entries)
    ifd_offset = 8
    data_offset = ifd_offset + 2 + n * 12 + 4
    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, ifd_offset)
    ifd = bytearray(struct.pack("<H", n))
    tail = bytearray()
    strip_offset_pos = None
    for tag, typ, count, value in entries:
        if isinstance(value, bytes) and len(value) > 4:
            off = data_offset + len(tail)
            ifd += struct.pack("<HHII", tag, typ, count, off)
            tail += value + (b"\x00" if len(value) % 2 else b"")
        elif value == "STRIP":
            strip_offset_pos = len(out) + len(ifd) + 8
            ifd += struct.pack("<HHII", tag, typ, count, 0)
        else:
            if isinstance(value, bytes):
                value = value.ljust(4, b"\x00")
                ifd += struct.pack("<HHI", tag, typ, count) + value
            else:
                ifd += struct.pack("<HHII", tag, typ, count, value)
    ifd += struct.pack("<I", 0)  # next IFD
    out += ifd + tail
    strip_off = len(out)
    struct.pack_into("<I", out, strip_offset_pos, strip_off)
    out += strip
    Path(path).write_bytes(bytes(out))


def read_geotiff_tags(path: str | Path) -> dict:
    """Parse the geo tags back (validation / round-trip tests)."""
    data = Path(path).read_bytes()
    bo, magic, ifd_off = struct.unpack("<2sHI", data[:8])
    assert bo == b"II" and magic == 42
    (n,) = struct.unpack_from("<H", data, ifd_off)
    tags = {}
    for i in range(n):
        tag, typ, count, val = struct.unpack_from(
            "<HHII", data, ifd_off + 2 + i * 12)
        if typ == TYPE_DOUBLE:
            arr = np.frombuffer(data, "<f8", count=count, offset=val)
            tags[tag] = arr.tolist()
        elif typ == TYPE_SHORT and count > 2:
            arr = np.frombuffer(data, "<u2", count=count, offset=val)
            tags[tag] = arr.tolist()
        else:
            tags[tag] = val
    out = {"width": tags[T_WIDTH], "height": tags[T_HEIGHT]}
    if T_MODEL_TIEPOINT in tags:
        tp = tags[T_MODEL_TIEPOINT]
        out["lon_min"], out["lat_max"] = tp[3], tp[4]
    if T_MODEL_PIXEL_SCALE in tags:
        out["lon_res"], out["lat_res"] = tags[T_MODEL_PIXEL_SCALE][:2]
    if T_GEO_KEYS in tags:
        gk = tags[T_GEO_KEYS]
        keys = {gk[4 + i * 4]: gk[7 + i * 4] for i in range(gk[3])}
        out["geo_keys"] = keys
    return out
