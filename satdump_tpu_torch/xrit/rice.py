"""Rice (CCSDS 121.0 / szip-RAW) decompression for xRIT image packets.

Decoder: native C (satdump_tpu_torch/native/rice.c, built at first use by
`native.get_lib`) — the restore loop is sample-serial and unfit for Python
or torch ops. Encoder: pure-Python test
fixture with per-block best-option selection (split-k / fundamental
sequence / zero-block / uncompressed / second-extension), mirroring what
szip emits so decode round-trips exercise every option.

Reference call site: module_goes_lrit_data_decoder.cpp:137
(SZ_BufftoBuffDecompress per CCSDS packet, one scanline per packet,
options SZ_ALLOW_K13 | SZ_MSB | SZ_NN | SZ_RAW).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from satdump_tpu_torch.native import get_lib

_lib = None


def _rice():
    global _lib
    if _lib is None:
        _lib = get_lib("rice")
        _lib.rice_decode_rsi.restype = ctypes.c_int
        _lib.rice_decode_rsi.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib.rice_decode_stream.restype = ctypes.c_int
        _lib.rice_decode_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return _lib


def rice_decode(data: bytes, pixels: int, bits_per_pixel: int = 8,
                pixels_per_block: int = 16,
                preprocess: bool = True) -> Optional[np.ndarray]:
    """Decode one scanline (reference-sample interval). Returns uint8/uint16
    samples or None on a corrupt stream."""
    out = np.zeros(pixels, np.uint16)
    r = _rice().rice_decode_rsi(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), pixels,
        bits_per_pixel, pixels_per_block, int(preprocess))
    if r != 0:
        return None
    return out.astype(np.uint8) if bits_per_pixel <= 8 else out


def rice_decode_stream32(data: bytes, pixels: int, bits_per_pixel: int = 32,
                         pixels_per_block: int = 32, rsi: int = 8,
                         preprocess: bool = True) -> Optional[np.ndarray]:
    """32-bit-sample multi-interval decode (the JPSS OMPS profile:
    omps_nadir_reader.cpp:18-21 — 32 bpp, 32 px/block, 256 px/scanline ->
    rsi 8 blocks). Returns uint32 samples or None."""
    lib = _rice()
    if not hasattr(lib, "_rs32_init"):
        lib.rice_decode_stream32.restype = ctypes.c_int
        lib.rice_decode_stream32.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib._rs32_init = True
    out = np.zeros(pixels, np.uint32)
    r = lib.rice_decode_stream32(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), pixels,
        bits_per_pixel, pixels_per_block, rsi, int(preprocess))
    if r != 0:
        return None
    return out


def rice_decode_stream(data: bytes, pixels: int, bits_per_pixel: int = 15,
                       pixels_per_block: int = 8, rsi: int = 128,
                       preprocess: bool = True) -> Optional[np.ndarray]:
    """Decode a multi-interval stream (new reference every rsi blocks) —
    the libaec profile VIIRS uses (channel_reader.cpp:16-19: n=15, J=8,
    rsi=128, MSB|PREPROCESS). Returns uint16 samples or None."""
    out = np.zeros(pixels, np.uint16)
    r = _rice().rice_decode_stream(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), pixels,
        bits_per_pixel, pixels_per_block, rsi, int(preprocess))
    if r != 0:
        return None
    return out


# ---------------------------------------------------------------------------
# Encoder (test fixture)
# ---------------------------------------------------------------------------
class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def fs(self, v: int):
        self.bits.extend([0] * v)
        self.bits.append(1)

    def tobytes(self) -> bytes:
        pad = (-len(self.bits)) % 8
        return np.packbits(np.asarray(self.bits + [0] * pad,
                                      np.uint8)).tobytes()


def _map_samples(x: np.ndarray, xmax: int) -> np.ndarray:
    """NN-predictor mapper: first sample raw reference, rest mapped deltas."""
    x = x.astype(np.int64)
    out = np.zeros_like(x)
    out[0] = x[0]
    for i in range(1, len(x)):
        pred = x[i - 1]
        theta = min(pred, xmax - pred)
        d = x[i] - pred
        if -theta <= d <= theta:
            out[i] = 2 * d if d >= 0 else 2 * (-d) - 1
        else:
            out[i] = theta + abs(d)
    return out


def rice_encode(samples: np.ndarray, bits_per_pixel: int = 8,
                pixels_per_block: int = 16, preprocess: bool = True,
                rsi: Optional[int] = None) -> bytes:
    """Encode samples; per-block chooses the cheapest of zero-block
    (run-aware), split-k, uncompressed, second-extension. With `rsi`, a new
    reference-sample interval starts every rsi blocks (bit-continuous, as
    libaec emits — the multi-interval VIIRS profile)."""
    if rsi is not None:
        J = pixels_per_block
        per = rsi * J
        x = np.asarray(samples, np.int64)
        w = _BitWriter()
        for off in range(0, len(x), per):
            _encode_interval(w, x[off: off + per], bits_per_pixel, J,
                             preprocess)
        return w.tobytes()
    w = _BitWriter()
    _encode_interval(w, np.asarray(samples, np.int64), bits_per_pixel,
                     pixels_per_block, preprocess)
    return w.tobytes()


def _encode_interval(w: "_BitWriter", samples: np.ndarray,
                     bits_per_pixel: int, pixels_per_block: int,
                     preprocess: bool) -> None:
    J = pixels_per_block
    n = bits_per_pixel
    xmax = (1 << n) - 1
    x = np.asarray(samples, np.int64)
    pixels = len(x)
    pad = (-pixels) % J
    if pad:
        x = np.concatenate([x, np.repeat(x[-1], pad)])
    m = _map_samples(x, xmax) if preprocess else x.copy()
    id_len = 3 if n <= 8 else (4 if n <= 16 else 5)
    uncomp_id = (1 << id_len) - 1
    nblocks = len(x) // J
    bi = 0
    while bi < nblocks:
        blk = m[bi * J: (bi + 1) * J]
        ref = preprocess and bi == 0
        body = blk[1:] if ref else blk
        # zero run (not for the reference block, keep fixture simple)
        if not ref and (blk == 0).all():
            run = 1
            while (bi + run < nblocks
                   and (m[(bi + run) * J: (bi + run + 1) * J] == 0).all()
                   and run < 63 - ((bi % 64))):
                run += 1
            w.put(0, id_len)
            w.put(0, 1)
            zb = run
            w.fs(zb - 1 if zb < 5 else zb)  # 5 reserved for ROS
            bi += run
            continue
        # candidate costs
        best_bits, best = None, None
        for k in range(0, n - 2):  # ids 1..2^L-2; the last id is uncomp
            cost = int((body >> k).sum()) + len(body) * (1 + k)
            if best_bits is None or cost < best_bits:
                best_bits, best = cost, ("split", k)
        if len(body) % 2 == 0 and n <= 16:  # SE cost overflows at n>16
            pairs = body.reshape(-1, 2)
            se = pairs[:, 0] + pairs[:, 1]
            se_vals = se * (se + 1) // 2 + pairs[:, 1]
            cost = int(se_vals.sum()) + len(se_vals) + 1
            if cost < best_bits:
                best_bits, best = cost, ("se", se_vals)
        if len(body) * n < best_bits:
            best = ("uncomp", None)
        kind, arg = best
        if kind == "uncomp":
            w.put(uncomp_id, id_len)
            for v in blk:
                w.put(int(v), n)
        elif kind == "split":
            k = arg
            w.put(k + 1, id_len)
            if ref:
                w.put(int(blk[0]), n)
            for v in body:
                w.fs(int(v) >> k)
            if k:
                for v in body:
                    w.put(int(v) & ((1 << k) - 1), k)
        else:  # second extension
            w.put(0, id_len)
            w.put(1, 1)
            if ref:
                w.put(int(blk[0]), n)
            for v in arg:
                w.fs(int(v))
        bi += 1
