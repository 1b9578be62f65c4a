"""Minimal CBOR (RFC 8949) encoder/decoder.

Reference: the product store saves `contents` as CBOR
(src-core/products/product.cpp via nlohmann::json::to_cbor), so byte-level
product compatibility needs a CBOR codec. Covers the types nlohmann emits:
unsigned/negative ints, byte/text strings, arrays, maps, false/true/null,
float32/float64."""

from __future__ import annotations

import math
import struct
from typing import Any, Tuple


def _head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([major << 5 | arg])
    if arg < 0x100:
        return bytes([major << 5 | 24, arg])
    if arg < 0x10000:
        return bytes([major << 5 | 25]) + struct.pack(">H", arg)
    if arg < 0x100000000:
        return bytes([major << 5 | 26]) + struct.pack(">I", arg)
    return bytes([major << 5 | 27]) + struct.pack(">Q", arg)


def encode(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _enc(o: Any, out: bytearray) -> None:
    if o is False:
        out += b"\xf4"
    elif o is True:
        out += b"\xf5"
    elif o is None:
        out += b"\xf6"
    elif isinstance(o, int):
        out += _head(0, o) if o >= 0 else _head(1, -1 - o)
    elif isinstance(o, float):
        # nlohmann emits float64 for doubles; keep that for byte parity
        out += b"\xfb" + struct.pack(">d", o)
    elif isinstance(o, bytes):
        out += _head(2, len(o)) + o
    elif isinstance(o, str):
        b = o.encode("utf-8")
        out += _head(3, len(b)) + b
    elif isinstance(o, (list, tuple)):
        out += _head(4, len(o))
        for v in o:
            _enc(v, out)
    elif isinstance(o, dict):
        out += _head(5, len(o))
        for k, v in o.items():
            _enc(str(k), out)
            _enc(v, out)
    else:
        import numpy as np
        if isinstance(o, np.integer):
            _enc(int(o), out)
        elif isinstance(o, np.floating):
            _enc(float(o), out)
        elif isinstance(o, np.ndarray):
            _enc(o.tolist(), out)
        else:
            raise TypeError(f"CBOR: unsupported type {type(o)}")


def decode(data: bytes) -> Any:
    v, off = _dec(memoryview(data), 0)
    return v


def _dec(d: memoryview, i: int) -> Tuple[Any, int]:
    ib = d[i]
    major, info = ib >> 5, ib & 0x1F
    i += 1
    if major <= 1 or major in (2, 3, 4, 5):
        if info < 24:
            arg = info
        elif info == 24:
            arg = d[i]; i += 1
        elif info == 25:
            arg = struct.unpack_from(">H", d, i)[0]; i += 2
        elif info == 26:
            arg = struct.unpack_from(">I", d, i)[0]; i += 4
        elif info == 27:
            arg = struct.unpack_from(">Q", d, i)[0]; i += 8
        else:
            raise ValueError("CBOR: indefinite lengths unsupported")
    if major == 0:
        return arg, i
    if major == 1:
        return -1 - arg, i
    if major == 2:
        return bytes(d[i: i + arg]), i + arg
    if major == 3:
        return bytes(d[i: i + arg]).decode("utf-8"), i + arg
    if major == 4:
        items = []
        for _ in range(arg):
            v, i = _dec(d, i)
            items.append(v)
        return items, i
    if major == 5:
        m = {}
        for _ in range(arg):
            k, i = _dec(d, i)
            v, i = _dec(d, i)
            m[k] = v
        return m, i
    if major == 7:
        if info == 20:
            return False, i
        if info == 21:
            return True, i
        if info == 22:
            return None, i
        if info == 25:  # half float
            h = struct.unpack_from(">H", d, i)[0]
            i += 2
            sign = -1.0 if h & 0x8000 else 1.0
            exp = (h >> 10) & 0x1F
            frac = h & 0x3FF
            if exp == 0:
                return sign * frac * 2 ** -24, i
            if exp == 31:
                return sign * (math.inf if frac == 0 else math.nan), i
            return sign * (1 + frac / 1024.0) * 2 ** (exp - 15), i
        if info == 26:
            return struct.unpack_from(">f", d, i)[0], i + 4
        if info == 27:
            return struct.unpack_from(">d", d, i)[0], i + 8
    raise ValueError(f"CBOR: unsupported item {ib:#x}")
