"""12-bit (and 8-bit) grayscale JPEG codec.

Decoder: native C (native/jpeg12.c, the port's hardened copy of the JAX
package's; built with `cc` at first use into `_build/`) — GK-2A LRIT, FY-4 xRIT,
DSCOVR EPIC and MATS ship 12-bit JPEG payloads that 8-bit JPEG libraries
(incl. PIL) refuse; the reference vendors a 12-bit libjpeg build for this
(src-core/libs/jpeg12, image/jpeg12_utils.cpp).

Encoder: pure NumPy extended-sequential writer used to build test
fixtures (flat-length Huffman tables, quality-scaled quantization) — the
decode side is what production uses.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from satdump_tpu_torch.native import get_lib

_lib = None

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _jp():
    global _lib
    if _lib is None:
        _lib = get_lib("jpeg12")
        _lib.jpeg12_decode_gray.restype = ctypes.c_long
        _lib.jpeg12_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
    return _lib


def decompress_jpeg12(data: bytes) -> Optional[np.ndarray]:
    """Grayscale 8/12-bit sequential JPEG -> uint8/uint16 array, or None
    if the stream isn't one this decoder handles (caller falls back to a
    general library)."""
    # probe dimensions from SOF first so the output buffer can be sized
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    prec = ctypes.c_int(0)
    dims = _sof_dims(data)
    if dims is None:
        return None
    W, H = dims
    out = np.zeros(W * H, np.uint16)
    r = _jp().jpeg12_decode_gray(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(prec))
    if r != 0:
        return None
    img = out.reshape(h.value, w.value)
    return img.astype(np.uint8) if prec.value == 8 else img


def _sof_dims(data: bytes):
    i = 2
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xD9:
            return None
        seglen = struct.unpack(">H", data[i + 2: i + 4])[0]
        if m in (0xC0, 0xC1):
            H, W = struct.unpack(">HH", data[i + 5: i + 9])
            return W, H
        i += 2 + seglen
    return None


# ------------------------------------------------------------ fixture enc
_QTAB = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int32)


class _BW:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, v, n):
        for k in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> k) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)
                self.acc = 0
                self.n = 0

    def flush(self):
        while self.n:
            self.bits(1, 1)


def _flat_huff(nsym, length):
    """counts[16], symbols for a canonical table where all nsym symbols
    share one code length; codes are 0..nsym-1 at that length."""
    counts = [0] * 16
    counts[length - 1] = nsym
    return bytes(counts), list(range(nsym))


def compress_jpeg12(img: np.ndarray, precision: int = 12,
                    quality_div: int = 1) -> bytes:
    """Encode a grayscale image as an extended-sequential JPEG at the
    given precision (8 or 12). Fixture-quality: flat Huffman tables,
    luminance quant table / quality_div (1 = near-lossless for smooth
    data)."""
    img = np.asarray(img)
    H, W = img.shape
    q = np.maximum(_QTAB // quality_div, 1)
    shift = 1 << (precision - 1)

    # tables: DC cats 0..15 @ 5 bits; AC 255 syms @ 8 bits + 1 @ 9
    dc_counts, dc_syms = _flat_huff(16, 5)
    ac_counts = [0] * 16
    ac_counts[7] = 254
    ac_counts[8] = 2
    ac_syms = list(range(255)) + [255]
    dc_code = {s: (i, 5) for i, s in enumerate(dc_syms)}
    ac_code = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(ac_counts[ln - 1]):
            ac_code[ac_syms[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1

    def cat(v):
        return int(abs(int(v))).bit_length()

    # DCT basis
    u = np.arange(8)
    Cb = np.where(u == 0, np.sqrt(0.5), 1.0)[:, None] * 0.5 * np.cos(
        (2 * np.arange(8)[None, :] + 1) * u[:, None] * np.pi / 16.0)

    bw = _BW()
    pred = 0
    bh, bwid = -(-H // 8), -(-W // 8)
    padded = np.zeros((bh * 8, bwid * 8), np.float64)
    padded[:H, :W] = img.astype(np.float64) - shift
    padded[H:, :W] = padded[H - 1: H, :W]
    padded[:, W:] = padded[:, W - 1: W]
    for by in range(bh):
        for bx in range(bwid):
            blk = padded[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8]
            coef = Cb @ blk @ Cb.T
            zz = np.round(coef.reshape(-1)[ZIGZAG]
                          / q[np.arange(64)]).astype(int)
            diff = int(zz[0]) - pred
            pred = int(zz[0])
            t = cat(diff)
            c, ln = dc_code[t]
            bw.bits(c, ln)
            if t:
                bw.bits(diff if diff >= 0 else diff + (1 << t) - 1, t)
            run = 0
            last_nz = np.nonzero(zz[1:])[0]
            last = last_nz[-1] + 1 if len(last_nz) else 0
            for kk in range(1, last + 1):
                v = int(zz[kk])
                if v == 0:
                    run += 1
                    if run == 16:
                        c, ln = ac_code[0xF0]
                        bw.bits(c, ln)
                        run = 0
                    continue
                t = cat(v)
                c, ln = ac_code[(run << 4) | t]
                bw.bits(c, ln)
                bw.bits(v if v >= 0 else v + (1 << t) - 1, t)
                run = 0
            if last < 63:
                c, ln = ac_code[0x00]
                bw.bits(c, ln)
    bw.flush()

    o = bytearray()
    o += b"\xff\xd8"
    # DQT (8-bit entries when they fit)
    o += b"\xff\xdb" + struct.pack(">H", 2 + 1 + 64) + b"\x00" \
        + bytes(int(x) for x in q)
    # SOF1 extended sequential
    o += b"\xff\xc1" + struct.pack(">HBHHB", 2 + 6 + 3, precision, H, W, 1) \
        + bytes([1, 0x11, 0])
    # DHT
    o += b"\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + len(dc_syms)) \
        + b"\x00" + dc_counts + bytes(dc_syms)
    o += b"\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + len(ac_syms)) \
        + b"\x10" + bytes(ac_counts) + bytes(ac_syms)
    # SOS
    o += b"\xff\xda" + struct.pack(">H", 2 + 1 + 2 + 3) \
        + bytes([1, 1, 0x00, 0, 63, 0])
    o += bw.out
    o += b"\xff\xd9"
    return bytes(o)
