"""EUMETSAT HRIT wavelet (WT / "DecompWT") codec bindings.

MSG SEVIRI and FY-2 HRIT image segments use EUMETSAT's S+P-wavelet +
adaptive-arithmetic compression (compression_flag == 1 in the image
structure record). The codec lives in native C
(native/decompwt.c, the port's hardened copy of the JAX package's, built
with `cc` at first use into `_build/`) — the arithmetic decoder is strictly
symbol-serial; the encoder exists for round-trip tests and TX tooling.

Reference behavior: plugins/xrit_support/DecompWT (EUMETSAT
PublicDecompWT) and the call site xrit/msg/decomp.cpp:86-95.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from satdump_tpu_torch.native import get_lib

_lib = None


def _wt():
    global _lib
    if _lib is None:
        _lib = get_lib("decompwt")
        u16p = ctypes.POINTER(ctypes.c_uint16)
        _lib.wt_decompress.restype = ctypes.c_int
        _lib.wt_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, u16p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16)]
        _lib.wt_compress.restype = ctypes.c_long
        _lib.wt_compress.argtypes = [
            u16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
    return _lib


def wt_decompress(data: bytes, width: int, height: int, bit_depth: int
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode one WT-compressed image data field.

    Returns (image (h, w) uint16, quality (h,) int16 — decoded columns per
    line, negative/zero for damaged lines) or None if the stream is not a
    valid WT field."""
    out = np.zeros((height, width), np.uint16)
    qual = np.zeros(height, np.int16)
    r = _wt().wt_decompress(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        width, height, bit_depth,
        qual.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if r != 0:
        return None
    return out, qual


def wt_compress(img: np.ndarray, bit_depth: int = 10, *, pred: int = 2,
                block_mode: int = 1, levels: int = 4, restart: int = 16,
                lossy: int = 0) -> bytes:
    """Encode an image into a WT data field (markers + stuffing included).
    pred: 0=S only, 1..3 = S+P predictors A/B/C; block_mode: 0/1/2 =
    16/32/64-px blocks, 3 = full image."""
    img = np.ascontiguousarray(img, np.uint16)
    h, w = img.shape
    cap = img.nbytes * 2 + 4096
    buf = ctypes.create_string_buffer(cap)
    n = _wt().wt_compress(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        w, h, bit_depth, pred, block_mode, levels, restart, lossy,
        ctypes.cast(buf, ctypes.c_char_p), cap)
    if n < 0:
        raise ValueError(f"wt_compress failed ({n})")
    if n > cap:  # retry with the exact required size
        buf = ctypes.create_string_buffer(int(n))
        n = _wt().wt_compress(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            w, h, bit_depth, pred, block_mode, levels, restart, lossy,
            ctypes.cast(buf, ctypes.c_char_p), int(n))
    return buf.raw[:n]
