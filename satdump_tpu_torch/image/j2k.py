"""JPEG 2000 without Pillow: the port's own decoder and encoder.

Counterpart of satdump_tpu/image/j2k.py::decompress_j2k and compress_j2k,
which go through Pillow and OpenJPEG; the card's machine has neither. The
codec is `native/j2k.c`, written from ITU-T T.800 and built with `cc` at
first use into `_build/` (`native.get_lib`). It runs on the host: tier-2 (packet
headers) and tier-1 (the MQ coder and EBCOT's passes) are bit-serial;
`decompress_j2k_timed` also returns the seconds of tier-2, tier-1 and the
inverse DWT, so that moving the DWT to the card can be decided from a
profile.

Scope: a raw codestream or a JP2 file, one component of up to 16 bits, any
tiling, quality layers, 1-33 resolutions, precincts, code-block sizes, the
five progression orders, 5/3 and 9/7. Several components, ROI, POC, packed
packet headers and the BYPASS, TERMALL and HT code-block styles raise
FormatError, as does a corrupt stream or one that claims more than 2^26
pixels (above any product's segment or block; the output is allocated
from the claim).

Samples come back as the codestream holds them after the DC level shift
(signed ones offset by half their range): (H, W) uint8 up to 8 bits,
uint16 above. Pillow, which can only write 8- and 16-bit streams, returns
the same for those; for other precisions it scales to its mode's range.

`compress_j2k` writes a JP2 file with the coding parameters Pillow's
OpenJPEG writes by default (one tile, LRCP, one layer, 64 x 64
code-blocks, min(5, floor(log2(min(h, w)))) levels; 5/3, or 9/7 with
OpenJPEG's step sizes): the same SIZ, COD and QCD segments, other bytes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from satdump_tpu_torch.core.exceptions import FormatError
from satdump_tpu_torch.native import get_lib

_lib = None


def _j2k():
    global _lib
    if _lib is None:
        lib = get_lib("j2k")
        ip = ctypes.POINTER(ctypes.c_int)
        lib.j2k_header.restype = ctypes.c_int
        lib.j2k_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ip, ip,
                                   ip, ip, ctypes.c_char_p, ctypes.c_int]
        lib.j2k_decode.restype = ctypes.c_int
        lib.j2k_encode.restype = ctypes.c_int
        lib.j2k_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
        lib.j2k_free.restype = None
        lib.j2k_free.argtypes = [ctypes.c_void_p]
        lib.j2k_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def decompress_j2k(data: bytes) -> np.ndarray:
    """Decode a raw J2K/JP2 codestream -> (H, W) uint8/uint16 array.
    Raises FormatError on a stream it does not take or a corrupt one."""
    return decompress_j2k_timed(data)[0]


def decompress_j2k_timed(data: bytes) -> Tuple[np.ndarray, Dict[str, float]]:
    """decompress_j2k, and the seconds this decode spent in tier-2, tier-1
    and the inverse DWT: (image, {"tier2", "tier1", "idwt"})."""
    data = bytes(data)
    lib = _j2k()
    err = ctypes.create_string_buffer(256)
    w, h, prec, sgnd = (ctypes.c_int(0) for _ in range(4))
    rc = lib.j2k_header(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(prec), ctypes.byref(sgnd), err, 256)
    if rc:
        raise FormatError(f"J2K: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value), np.int32)
    times = (ctypes.c_double * 3)()
    rc = lib.j2k_decode(data, len(data),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        out.size, times, err, 256)
    if rc:
        raise FormatError(f"J2K: {err.value.decode(errors='replace')}")
    if sgnd.value:
        out += 1 << (prec.value - 1)
    return (out.astype(np.uint8 if prec.value <= 8 else np.uint16),
            dict(tier2=times[0], tier1=times[1], idwt=times[2]))


def compress_j2k(img: np.ndarray, lossless: bool = True) -> bytes:
    """Encode (H, W) uint8/uint16 -> JP2 file bytes: the reversible 5/3
    (lossless) by default, else the irreversible 9/7. Raises FormatError
    for any other shape or dtype."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise FormatError("compress_j2k: single-component images only")
    if img.dtype not in (np.uint8, np.uint16):
        raise FormatError(f"compress_j2k: dtype {img.dtype}")
    img = np.ascontiguousarray(img)
    lib = _j2k()
    err = ctypes.create_string_buffer(256)
    out, n = ctypes.c_void_p(), ctypes.c_size_t(0)
    rc = lib.j2k_encode(img.ctypes.data, img.shape[1], img.shape[0],
                        8 * img.itemsize, int(bool(lossless)),
                        ctypes.byref(out), ctypes.byref(n), err, 256)
    if rc:
        raise FormatError(f"J2K: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.j2k_free(out)
