"""QOI image codec (the Quite OK Image format, qoiformat.org spec).

Reference: src-core/image/io_qoi.cpp (the reference ships a native QOI
reader/writer). From-scratch implementation of the public spec: OP_RGB/
OP_RGBA/OP_INDEX/OP_DIFF/OP_LUMA/OP_RUN chunks, 64-entry hash index."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

MAGIC = b"qoif"
OP_INDEX, OP_DIFF, OP_LUMA, OP_RUN = 0x00, 0x40, 0x80, 0xC0
OP_RGB, OP_RGBA = 0xFE, 0xFF


def _hash(r, g, b, a):
    return (r * 3 + g * 5 + b * 7 + a * 11) % 64


def save_qoi(img: np.ndarray, path: str | Path) -> None:
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    assert c in (3, 4)
    out = bytearray()
    out += MAGIC + struct.pack(">IIBB", w, h, c, 0)
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    px = img.reshape(-1, c)
    run = 0
    for p in px:
        cur = (int(p[0]), int(p[1]), int(p[2]),
               int(p[3]) if c == 4 else 255)
        if cur == prev:
            run += 1
            if run == 62:
                out.append(OP_RUN | (run - 1))
                run = 0
            continue
        if run:
            out.append(OP_RUN | (run - 1))
            run = 0
        hidx = _hash(*cur)
        if index[hidx] == cur:
            out.append(OP_INDEX | hidx)
        else:
            index[hidx] = cur
            if cur[3] == prev[3]:
                dr = (cur[0] - prev[0] + 256) % 256
                dg = (cur[1] - prev[1] + 256) % 256
                db = (cur[2] - prev[2] + 256) % 256
                sdr = dr if dr < 128 else dr - 256
                sdg = dg if dg < 128 else dg - 256
                sdb = db if db < 128 else db - 256
                if -2 <= sdr <= 1 and -2 <= sdg <= 1 and -2 <= sdb <= 1:
                    out.append(OP_DIFF | ((sdr + 2) << 4) | ((sdg + 2) << 2)
                               | (sdb + 2))
                elif -32 <= sdg <= 31 and -8 <= sdr - sdg <= 7 \
                        and -8 <= sdb - sdg <= 7:
                    out.append(OP_LUMA | (sdg + 32))
                    out.append(((sdr - sdg + 8) << 4) | (sdb - sdg + 8))
                else:
                    out.append(OP_RGB)
                    out += bytes(cur[:3])
            else:
                out.append(OP_RGBA)
                out += bytes(cur)
        prev = cur
    if run:
        out.append(OP_RUN | (run - 1))
    out += b"\x00" * 7 + b"\x01"
    Path(path).write_bytes(bytes(out))


def load_qoi(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    assert data[:4] == MAGIC, "not a QOI file"
    w, h, c, _cs = struct.unpack(">IIBB", data[4:14])
    px = np.empty((h * w, 4), np.uint8)
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    i, n = 14, 0
    total = h * w
    while n < total:
        b0 = data[i]
        i += 1
        if b0 == OP_RGB:
            prev = (data[i], data[i + 1], data[i + 2], prev[3])
            i += 3
        elif b0 == OP_RGBA:
            prev = tuple(data[i: i + 4])
            i += 4
        else:
            tag = b0 & 0xC0
            if tag == OP_INDEX:
                prev = index[b0 & 0x3F]
            elif tag == OP_DIFF:
                dr = ((b0 >> 4) & 3) - 2
                dg = ((b0 >> 2) & 3) - 2
                db = (b0 & 3) - 2
                prev = ((prev[0] + dr) % 256, (prev[1] + dg) % 256,
                        (prev[2] + db) % 256, prev[3])
            elif tag == OP_LUMA:
                dg = (b0 & 0x3F) - 32
                b1 = data[i]
                i += 1
                dr = dg + ((b1 >> 4) & 0xF) - 8
                db = dg + (b1 & 0xF) - 8
                prev = ((prev[0] + dr) % 256, (prev[1] + dg) % 256,
                        (prev[2] + db) % 256, prev[3])
            else:  # OP_RUN
                run = (b0 & 0x3F) + 1
                px[n: n + run] = prev
                n += run
                continue
        index[_hash(*prev)] = prev
        px[n] = prev
        n += 1
    out = px.reshape(h, w, 4)
    return out[:, :, :c] if c in (3, 4) else out
