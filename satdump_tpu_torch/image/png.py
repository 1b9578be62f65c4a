"""PNG codec on zlib and struct (ISO/IEC 15948), for the product and
composite images.

The writer covers 8- and 16-bit grayscale, gray+alpha, RGB and RGBA, with
16-bit samples big-endian and filter type 0 (None) on every row. The reader
takes the same colour types and depths, IDAT split over any number of
chunks and every row filter (0-4), as encoders with adaptive filtering
write them; it refuses interlaced (Adam7) images and other depths or
colour types with a FormatError. A filtered pixel depends on the pixels to
its left, above and above-left, so filtered images are undone along
anti-diagonals, all pixels of a diagonal at once.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from satdump_tpu_torch.core.exceptions import FormatError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8/uint16, C in 1-4 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise FormatError(f"PNG: dtype {img.dtype} unsupported (uint8/uint16)")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise FormatError(f"PNG: shape {img.shape} unsupported")
    h, w, c = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)   # filter byte 0
    raw[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(img: np.ndarray, path: str | Path) -> None:
    Path(path).write_bytes(encode_png(img))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: pixel (y, x) needs (y, x-1), (y-1, x) and
    (y-1, x-1), so every pixel of the anti-diagonal x + y = d is ready once
    d-1 is."""
    h, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)     # zero row and column
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = out[y + 1, x]
        b = out[y, x + 1]
        c = out[y, x]
        t = ftype[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (f[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8/uint16."""
    if data[:8] != SIGNATURE:
        raise FormatError("PNG: bad signature")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise FormatError(f"PNG: bad CRC in {kind!r}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise FormatError("PNG: no IHDR or IDAT")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise FormatError("PNG: interlaced images are not supported")
    if depth not in (8, 16) or ctype not in _CHANNELS:
        raise FormatError(f"PNG: bit depth {depth} / colour type {ctype} "
                          "not supported")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise FormatError("PNG: image data truncated")
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    ftype, filt = raw[:, 0], raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise FormatError(f"PNG: filter type {int(ftype.max())}")
    pix = _unfilter(filt, ftype, bpp) if ftype.any() else filt
    if depth == 16:
        pix = np.ascontiguousarray(pix).view(">u2").astype(np.uint16)
    pix = pix.reshape(h, w, c)
    return np.require(pix[:, :, 0] if c == 1 else pix, requirements="CW")


def load_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
