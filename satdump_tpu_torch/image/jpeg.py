"""Baseline JPEG entropy decoding + batched IDCT (METEOR MSU-MR LRPT).

The METEOR LRPT downlink compresses MSU-MR imagery with the *standard*
JPEG baseline luminance scheme (ITU-T T.81 Annex K tables) — the reference
hand-embeds those tables (plugins/meteor_support/meteor/instruments/msumr/
lrpt/tables.h) and decodes MCU-by-MCU with a per-bit scan + per-block int
IDCT (lrpt/{huffman,segment,idct}.cpp). Here the tables are *constructed*
from the public T.81 spec (canonical Huffman from BITS/HUFFVAL), entropy
decoding runs on host with a 16-bit peek LUT (sequential bit stream — host
work by design), and the de-zig-zag, dequantization and IDCT of ALL
collected blocks happen in one batched pass on the device (a pair of 8x8
matmuls) at image-assembly time.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from satdump_tpu_torch.core.exceptions import FormatError
from satdump_tpu_torch.utils.device import (full_precision_matmul,
                                            resolve_device, to_numpy)

# --- ITU-T T.81 Annex K: luminance tables (public spec constants) ----------

# K.1 — luminance quantization table, natural (row-major) order
QTABLE_LUM = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.float64)

# zig-zag index: ZIGZAG[natural_pos] = position in the zig-zag sequence
ZIGZAG = np.array([
    0, 1, 5, 6, 14, 15, 27, 28,
    2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43,
    9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63], np.int64)

# UNZIGZAG[k] = natural position of the k-th coefficient in zig-zag order
_UNZIGZAG = np.argsort(ZIGZAG)

# K.3.1 — luminance DC: BITS (codes per length 1..16) and HUFFVAL
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))

# K.3.2 — luminance AC
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]
AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA]
assert len(AC_VALS) == sum(AC_BITS)


def _canonical_codes(bits: List[int]) -> List[Tuple[int, int]]:
    """BITS -> [(length, code), ...] in HUFFVAL order (T.81 C.2)."""
    out = []
    code = 0
    for length in range(1, len(bits) + 1):
        for _ in range(bits[length - 1]):
            out.append((length, code))
            code += 1
        code <<= 1
    return out


def _build_peek_lut(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """16-bit peek LUT of a canonical table: value16 -> (symbol,
    code_length); symbol -1 where no code matches (corrupt stream)."""
    sym = np.full(1 << 16, -1, np.int32)
    ln = np.zeros(1 << 16, np.int32)
    for (length, code), v in zip(_canonical_codes(list(bits)), vals):
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        if hi > 1 << 16:
            raise FormatError("JPEG: Huffman table has more codes than its "
                              "lengths hold")
        sym[lo:hi] = v
        ln[lo:hi] = length
    return sym, ln


@lru_cache(maxsize=4)
def _peek_lut(kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """The T.81 Annex K luminance table's peek LUT (see _build_peek_lut)."""
    bits, vals = (DC_BITS, DC_VALS) if kind == "dc" else (AC_BITS, AC_VALS)
    return _build_peek_lut(bits, vals)


def quantization_table(qf: float) -> np.ndarray:
    """Quality-factor-scaled luminance quant table, natural order.
    Matches the reference's scaling variant (lrpt/huffman.cpp:14-29:
    the 5000/qf branch is gated at 20<=qf<50, unlike stock IJG)."""
    if 20 <= qf < 50:
        scale = 5000.0 / qf
    else:
        scale = 200.0 - 2.0 * qf
    t = np.floor(scale / 100.0 * QTABLE_LUM + 0.5)
    return np.maximum(t, 1.0)


class BitReader:
    """MSB-first bit reader over a byte buffer (no JPEG byte-stuffing on
    the LRPT link)."""

    __slots__ = ("bits", "pos", "n")

    def __init__(self, data: bytes):
        arr = np.frombuffer(data, np.uint8)
        self.bits = np.unpackbits(arr)
        self.pos = 0
        self.n = self.bits.size

    def peek16(self) -> int:
        p = self.pos
        chunk = self.bits[p: p + 16]
        v = 0
        for b in chunk:
            v = (v << 1) | int(b)
        return v << (16 - chunk.size)

    def take(self, k: int) -> int:
        p = self.pos
        if p + k > self.n:
            raise EOFError
        v = 0
        for b in self.bits[p: p + k]:
            v = (v << 1) | int(b)
        self.pos = p + k
        return v


def _extend(v: int, length: int) -> int:
    """T.81 F.12 EXTEND: map `length`-bit magnitude to signed value."""
    if length == 0:
        return 0
    if v < (1 << (length - 1)):
        return v - (1 << length) + 1
    return v


def decode_mcus(data: bytes, n_mcus: int) -> Tuple[np.ndarray, int]:
    """Entropy-decode up to n_mcus 8x8 blocks from a segment bitstream.

    Returns (coeffs (n_mcus, 64) int32 in ZIG-ZAG order, n_decoded).
    Decoding stops at the first corrupt/truncated block (the reference marks
    the segment partial, lrpt/segment.cpp FindDC/FindAC CFC path)."""
    dc_sym, dc_len = _peek_lut("dc")
    ac_sym, ac_len = _peek_lut("ac")
    out = np.zeros((n_mcus, 64), np.int32)
    rd = BitReader(data)
    last_dc = 0
    done = 0
    try:
        for i in range(n_mcus):
            p16 = rd.peek16()
            cat = int(dc_sym[p16])
            if cat < 0:
                break
            rd.take(int(dc_len[p16]))
            diff = _extend(rd.take(cat), cat) if cat else 0
            last_dc += diff
            out[i, 0] = last_dc
            k = 1
            while k < 64:
                p16 = rd.peek16()
                rs = int(ac_sym[p16])
                if rs < 0:
                    raise EOFError
                rd.take(int(ac_len[p16]))
                if rs == 0x00:          # EOB
                    break
                run, size = rs >> 4, rs & 0xF
                if rs == 0xF0:          # ZRL: 16 zeros
                    k += 16
                    continue
                k += run
                if k >= 64:
                    break
                out[i, k] = _extend(rd.take(size), size)
                k += 1
            done = i + 1
    except EOFError:
        pass
    return out, done


@lru_cache(maxsize=1)
def _dct_basis() -> np.ndarray:
    """8x8 type-II DCT basis C with C[k,n] = a_k cos((2n+1)kπ/16)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.cos((2 * n + 1) * k * np.pi / 16.0)
    c[0] *= 1.0 / np.sqrt(2.0)
    return (c * 0.5).astype(np.float32)


def dequantize_idct(coeffs_zz: np.ndarray, qtables: np.ndarray,
                    device: str | torch.device | None = None) -> np.ndarray:
    """(N, 64) zig-zag coeffs + (N, 64) natural-order quant tables ->
    (N, 8, 8) uint8 pixels. One batched pair of matmuls over all blocks on
    `device` (default ``cuda``).

    The reference's einsum("ki,nkl,lj->nij", C, B, C) contracts k first
    (T[n,l,i] = sum_k B[n,k,l] C[k,i]), then l; the same two contractions
    run here in float32 with TF32 off, so only the order of the 8-term sums
    inside each product may differ from XLA's."""
    dev = resolve_device(device)
    if coeffs_zz.size == 0:
        return np.zeros((0, 8, 8), np.uint8)
    # de-zig-zag into natural order and dequantize on the device too: the
    # int32 coefficients and the tables are exact in float32, so the
    # product is the reference's host product
    zz = torch.from_numpy(np.ascontiguousarray(coeffs_zz, np.int32)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(qtables, np.float32)).to(dev)
    order = torch.from_numpy(ZIGZAG).to(dev)
    b = (zz[:, order].to(torch.float32) * q).reshape(-1, 8, 8)
    C = torch.from_numpy(_dct_basis()).to(dev)
    with full_precision_matmul():
        t = torch.matmul(b.transpose(1, 2), C)          # (n, l, i)
        y = torch.matmul(t.transpose(1, 2), C)          # (n, i, j)
    y = torch.clamp(torch.round(y + 128.0), 0, 255)
    return to_numpy(y.to(torch.uint8))


# --- baseline grayscale JFIF (xRIT 8-bit segments) -------------------------
#
# The JAX package decodes 8-bit xRIT JPEG segments with Pillow (libjpeg),
# which the card's machine does not have. This decoder takes what libjpeg's
# default path takes for one 8-bit component: SOF0/SOF1, DQT, DHT (any
# canonical table, as `optimize=True` writes), DRI and RSTn, and libjpeg's
# integer "islow" IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, its
# range-limit table), so the pixels equal Pillow's bit for bit. Progressive,
# arithmetic-coded, lossless, hierarchical and colour streams raise
# FormatError.

_SOF_REFUSED = {0xC2: "progressive", 0xC3: "lossless",
                0xC5: "hierarchical", 0xC6: "hierarchical progressive",
                0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless", 0xCC: "arithmetic-coded",
                0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical progressive",
                0xCF: "arithmetic-coded hierarchical lossless"}

# islow's constants: FIX(x) = round(x * 2^13)
_F = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
      "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
      "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
_CONST_BITS, _PASS1_BITS = 13, 2


def _segments(data: bytes):
    """Yield (marker, body offset, body length) of each marker segment up
    to and including SOS; every length is checked against the buffer."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise FormatError("JPEG: no SOI marker")
    i = 2
    while i + 1 < n:
        if data[i] != 0xFF:
            raise FormatError(f"JPEG: expected a marker at byte {i}")
        m = data[i + 1]
        if m == 0xFF:                      # fill byte
            i += 1
            continue
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xD9:
            break
        if i + 4 > n:
            raise FormatError("JPEG: truncated marker segment")
        ln = data[i + 2] << 8 | data[i + 3]
        if ln < 2 or i + 2 + ln > n:
            raise FormatError(f"JPEG: marker 0x{m:02X} overruns the stream")
        yield m, i + 4, ln - 2
        if m == 0xDA:
            return
        i += 2 + ln
    raise FormatError("JPEG: no SOS marker")


def parse_jfif_gray(data: bytes) -> Dict:
    """The headers of a baseline one-component 8-bit JPEG -> {"width",
    "height", "q" (64,) natural order, "dc"/"ac": (bits, vals), "restart",
    "scan": offset of the entropy-coded data}."""
    data = bytes(data)
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
    frame = None
    restart = 0
    for m, o, ln in _segments(data):
        body = data[o: o + ln]
        if m == 0xDB:                                  # DQT
            k = 0
            while k < ln:
                pq, tq = body[k] >> 4, body[k] & 15
                size = 128 if pq else 64
                if tq > 3 or pq > 1 or k + 1 + size > ln:
                    raise FormatError("JPEG: bad DQT segment")
                raw = np.frombuffer(body[k + 1: k + 1 + size],
                                    ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int32)
                q[_UNZIGZAG] = raw
                qt[tq] = q
                k += 1 + size
        elif m == 0xC4:                                # DHT
            k = 0
            while k < ln:
                if k + 17 > ln:
                    raise FormatError("JPEG: bad DHT segment")
                tc, th = body[k] >> 4, body[k] & 15
                bits = list(body[k + 1: k + 17])
                nv = sum(bits)
                if tc > 1 or th > 3 or nv > 256 or k + 17 + nv > ln:
                    raise FormatError("JPEG: bad DHT segment")
                huff[(tc, th)] = (bits, list(body[k + 17: k + 17 + nv]))
                k += 17 + nv
        elif m in (0xC0, 0xC1):                        # SOF0 / SOF1
            if ln < 6:
                raise FormatError("JPEG: bad SOF segment")
            prec, h, w, nc = body[0], body[1] << 8 | body[2], \
                body[3] << 8 | body[4], body[5]
            if nc != 1:
                raise FormatError(f"JPEG: {nc} components (colour) not "
                                  "taken")
            if prec != 8:
                raise FormatError(f"JPEG: precision {prec} not taken")
            if ln < 9 or body[8] > 3 or not w or not h:
                raise FormatError("JPEG: bad SOF segment")
            frame = (w, h, body[6], body[8])
        elif m in _SOF_REFUSED:
            raise FormatError(f"JPEG: {_SOF_REFUSED[m]} stream not taken")
        elif m == 0xDD:                                # DRI
            if ln < 2:
                raise FormatError("JPEG: bad DRI segment")
            restart = body[0] << 8 | body[1]
        elif m == 0xDA:                                # SOS
            if frame is None:
                raise FormatError("JPEG: SOS before SOF")
            if ln < 6 or body[0] != 1:
                raise FormatError("JPEG: scan is not one component")
            w, h, cid, tq = frame
            td, ta = body[2] >> 4, body[2] & 15
            if (body[1] != cid or tq not in qt or (0, td) not in huff
                    or (1, ta) not in huff):
                raise FormatError("JPEG: scan names a missing table")
            if body[3] != 0 or body[4] != 63 or body[5] != 0:
                raise FormatError("JPEG: scan is not sequential")
            return {"width": w, "height": h, "q": qt[tq],
                    "dc": huff[(0, td)], "ac": huff[(1, ta)],
                    "restart": restart, "scan": o + ln}
    raise FormatError("JPEG: no SOS marker")


def _intervals(data: bytes, start: int) -> List[bytes]:
    """The entropy-coded data from `start` up to the first marker other
    than RSTn, split at the RSTn markers, each with its FF00 unstuffed."""
    out, cur = [], start
    i = start
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            out.append(data[cur:])
            break
        m = data[j + 1]
        if m == 0x00:
            i = j + 2
        elif 0xD0 <= m <= 0xD7:
            out.append(data[cur:j])
            cur = i = j + 2
        elif m == 0xFF:
            i = j + 1
        else:
            out.append(data[cur:j])
            break
    return [iv.replace(b"\xff\x00", b"\xff") for iv in out]


def _windows16(chunk: bytes) -> List[int]:
    """The 16 bits at every bit position of chunk (zeros past its end), as
    a list: a peek is then one index."""
    bits = np.unpackbits(np.frombuffer(chunk, np.uint8))
    bits = np.concatenate([bits, np.zeros(32, np.uint8)]).astype(np.int32)
    n = len(bits) - 16
    win = np.zeros(n, np.int32)
    for k in range(16):
        win |= bits[k: k + n] << (15 - k)
    return win.tolist()


def huffman_decode_gray(hdr: Dict, data: bytes) -> np.ndarray:
    """Entropy-decode every block of a parsed baseline scan -> (N, 64)
    int32 coefficients in zig-zag order (host; sequential by nature)."""
    w, h = hdr["width"], hdr["height"]
    nblocks = -(-w // 8) * -(-h // 8)
    restart = hdr["restart"] or nblocks
    dcs, dcl = (x.tolist() for x in _build_peek_lut(*hdr["dc"]))
    acs, acl = (x.tolist() for x in _build_peek_lut(*hdr["ac"]))
    out = np.zeros((nblocks, 64), np.int32)
    try:
        b = _decode_intervals(_intervals(bytes(data), hdr["scan"]), out,
                              restart, dcs, dcl, acs, acl)
    except IndexError:          # a corrupt code ran past the padded end
        raise FormatError("JPEG: entropy-coded data ends early") from None
    if b < len(out):
        raise FormatError(f"JPEG: {b} of {len(out)} blocks in the stream")
    return out


def _decode_intervals(ivs, out, restart, dcs, dcl, acs, acl) -> int:
    """Decode the restart intervals into out's rows; returns the count."""
    nblocks = len(out)
    b = 0
    for iv in ivs:
        if b >= nblocks:
            break
        win = _windows16(iv)
        end = len(iv) * 8
        pos, pred = 0, 0
        for _ in range(min(restart, nblocks - b)):
            row = out[b]
            p16 = win[pos]
            t = dcs[p16]
            if t < 0 or t > 16:
                raise FormatError("JPEG: bad DC Huffman code")
            pos += dcl[p16]
            if t:
                v = win[pos] >> (16 - t)
                pos += t
                pred += v - (1 << t) + 1 if v < 1 << (t - 1) else v
            row[0] = pred
            k = 1
            while k < 64:
                p16 = win[pos]
                rs = acs[p16]
                if rs < 0:
                    raise FormatError("JPEG: bad AC Huffman code")
                pos += acl[p16]
                r, sz = rs >> 4, rs & 15
                if not sz:
                    if r != 15:
                        break                       # EOB
                    k += 16
                    continue
                k += r
                v = win[pos] >> (16 - sz)
                pos += sz
                if k < 64:
                    row[k] = v - (1 << sz) + 1 if v < 1 << (sz - 1) else v
                k += 1
            if pos > end:
                raise FormatError("JPEG: entropy-coded data ends early")
            b += 1
    return b


def idct_islow(coeffs_zz: np.ndarray, q: np.ndarray,
               device: str | torch.device | None = None) -> np.ndarray:
    """libjpeg's jpeg_idct_islow on (N, 64) zig-zag coefficients with a
    (64,) natural-order table -> (N, 8, 8) uint8, as int64 torch ops on
    `device` (default ``cuda``): integer arithmetic, so every device gives
    the same pixels. Columns first, then rows, each with the even / odd
    split of jidctint.c; DESCALE rounds half up by an arithmetic shift."""
    dev = resolve_device(device)
    if len(coeffs_zz) == 0:
        return np.zeros((0, 8, 8), np.uint8)
    zz = torch.from_numpy(np.ascontiguousarray(coeffs_zz, np.int32)).to(dev)
    order = torch.from_numpy(ZIGZAG).to(dev)
    qt = torch.from_numpy(np.asarray(q, np.int64)).to(dev)
    b = (zz[:, order].to(torch.int64) * qt).reshape(-1, 8, 8)
    f = _F

    def pass_(x, shift):
        """One 1-D islow pass over x[..., k] (k = the 8 inputs)."""
        z2, z3 = x[..., 2], x[..., 6]
        z1 = (z2 + z3) * f["0_541196100"]
        tmp2 = z1 - z3 * f["1_847759065"]
        tmp3 = z1 + z2 * f["0_765366865"]
        tmp0 = (x[..., 0] + x[..., 4]) << _CONST_BITS
        tmp1 = (x[..., 0] - x[..., 4]) << _CONST_BITS
        t10, t13 = tmp0 + tmp3, tmp0 - tmp3
        t11, t12 = tmp1 + tmp2, tmp1 - tmp2
        o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
        z1, z2 = o0 + o3, o1 + o2
        z3, z4 = o0 + o2, o1 + o3
        z5 = (z3 + z4) * f["1_175875602"]
        o0 = o0 * f["0_298631336"]
        o1 = o1 * f["2_053119869"]
        o2 = o2 * f["3_072711026"]
        o3 = o3 * f["1_501321110"]
        z1 = z1 * -f["0_899976223"]
        z2 = z2 * -f["2_562915447"]
        z3 = z3 * -f["1_961570560"] + z5
        z4 = z4 * -f["0_390180644"] + z5
        o0 = o0 + z1 + z3
        o1 = o1 + z2 + z4
        o2 = o2 + z2 + z3
        o3 = o3 + z1 + z4
        rnd = 1 << (shift - 1)
        return torch.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                            t13 - o0, t12 - o1, t11 - o2, t10 - o3],
                           -1).add(rnd) >> shift

    # pass 1: each column (inputs down the rows) -> workspace columns
    ws = pass_(b.transpose(1, 2), _CONST_BITS - _PASS1_BITS).transpose(1, 2)
    # pass 2: each row of the workspace
    v = pass_(ws, _CONST_BITS + _PASS1_BITS + 3)
    # libjpeg's range_limit[v & 1023]: v as a 10-bit signed value + 128,
    # clamped to [0, 255]
    u = v & 1023
    u = torch.where(u >= 512, u - 1024, u)
    return to_numpy(torch.clamp(u + 128, 0, 255).to(torch.uint8))


def decode_jpeg_gray(data: bytes, device: str | torch.device | None = None
                     ) -> np.ndarray:
    """A baseline 8-bit one-component JPEG -> (H, W) uint8, equal to
    libjpeg's default decode. Entropy decoding on the host, the IDCT on
    `device`. Raises FormatError on any stream it does not take."""
    hdr = parse_jfif_gray(data)
    zz = huffman_decode_gray(hdr, data)
    blocks = idct_islow(zz, hdr["q"], device)
    w, h = hdr["width"], hdr["height"]
    bw, bh = -(-w // 8), -(-h // 8)
    img = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(img.reshape(bh * 8, bw * 8)[:h, :w])
