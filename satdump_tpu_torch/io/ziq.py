"""ZIQ compressed baseband format (ref src-core/common/ziq.{h,cpp} and
docs/pages/ZIQ.md).

Layout: b"ZIQ_" | u8 is_compressed | s8 bits_per_sample | u64le samplerate
| u64le annotation_len | annotation (JSON) | payload. Payload is interleaved
IQ as int8 (x127), int16 (x32767) or float32, zstd-framed when compressed
(the reference uses streaming ZSTD with checksums; standard frames decode
it either way).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SIGNATURE = b"ZIQ_"

try:
    import zstandard as _zstd
except Exception:           # pragma: no cover - zstandard is in the image
    _zstd = None


def is_ziq(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == SIGNATURE


def _scale(bits: int) -> float:
    return {8: 127.0, 16: 32767.0, 32: 1.0}[bits]


def write_ziq(path: str | Path, samples: np.ndarray, samplerate: float = 0,
              bits_per_sample: int = 8, compress: bool = True,
              annotation: Optional[dict] = None) -> None:
    samples = np.asarray(samples, np.complex64)
    inter = np.empty(2 * len(samples), np.float32)
    inter[0::2] = samples.real
    inter[1::2] = samples.imag
    s = _scale(bits_per_sample)
    if bits_per_sample == 8:
        data = np.clip(np.round(inter * s), -127, 127).astype(np.int8).tobytes()
    elif bits_per_sample == 16:
        data = np.clip(np.round(inter * s), -32767, 32767).astype(np.int16).tobytes()
    elif bits_per_sample == 32:
        data = inter.tobytes()
    else:
        raise ValueError(f"ziq bits_per_sample {bits_per_sample}")

    ann = json.dumps(annotation or {}).encode()
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(struct.pack("<B", 1 if compress else 0))
        f.write(struct.pack("<b", bits_per_sample))
        f.write(struct.pack("<Q", int(samplerate)))
        f.write(struct.pack("<Q", len(ann)))
        f.write(ann)
        if compress:
            if _zstd is None:
                raise RuntimeError("zstandard module unavailable")
            f.write(_zstd.ZstdCompressor(level=1).compress(data))
        else:
            f.write(data)


def read_ziq(path: str | Path
             ) -> Tuple[np.ndarray, float, dict]:
    """-> (complex64 samples, samplerate, annotation dict)."""
    with open(path, "rb") as f:
        if f.read(4) != SIGNATURE:
            raise ValueError("not a ZIQ file")
        is_comp = struct.unpack("<B", f.read(1))[0]
        bits = struct.unpack("<b", f.read(1))[0]
        samplerate = struct.unpack("<Q", f.read(8))[0]
        ann_len = struct.unpack("<Q", f.read(8))[0]
        ann = f.read(ann_len)
        payload = f.read()
    if is_comp:
        if _zstd is None:
            raise RuntimeError("zstandard module unavailable")
        payload = _zstd.ZstdDecompressor().decompressobj().decompress(payload)
    if bits == 8:
        inter = np.frombuffer(payload, np.int8).astype(np.float32) / 127.0
    elif bits == 16:
        inter = np.frombuffer(payload, np.int16).astype(np.float32) / 32767.0
    elif bits == 32:
        inter = np.frombuffer(payload, np.float32)
    else:
        raise ValueError(f"ziq bits_per_sample {bits}")
    n = len(inter) // 2
    out = (inter[0: 2 * n: 2] + 1j * inter[1: 2 * n: 2]).astype(np.complex64)
    try:
        annotation = json.loads(ann.decode() or "{}")
    except json.JSONDecodeError:
        annotation = {}
    return out, float(samplerate), annotation


# ---------------------------------------------------------------------------
# ZIQ2 (ref src-core/common/ziq2.{h,cpp}): packetized, ASM-synced stream of
# [0x1ACFFC1D][u32le pkt_size][u8 pkt_type]{payload}. INFO packets carry a
# u64le samplerate; IQ packets carry [u8 bit_depth][f32le scale] + samples
# quantized per packet by their own peak magnitude.
# ---------------------------------------------------------------------------

SIGNATURE2 = b"ZIQ2"
ZIQ2_ASM = b"\x1a\xcf\xfc\x1d"
ZIQ2_PKT_INFO = 0
ZIQ2_PKT_IQ = 1


def is_ziq2(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == SIGNATURE2


def write_ziq2(path: str | Path, samples: np.ndarray, samplerate: float = 0,
               bits_per_sample: int = 8, pkt_samples: int = 8192) -> None:
    """File header + INFO packet + IQ packets (ziq2_write_file_hdr /
    ziq2_write_iq_pkt)."""
    samples = np.asarray(samples, np.complex64)
    with open(path, "wb") as f:
        f.write(SIGNATURE2)
        info = struct.pack("<Q", int(samplerate))
        f.write(ZIQ2_ASM + struct.pack("<IB", len(info), ZIQ2_PKT_INFO)
                + info)
        for off in range(0, len(samples), pkt_samples):
            blk = samples[off: off + pkt_samples]
            peak = float(np.max(np.abs(blk))) or 1.0
            scale = _scale(bits_per_sample) / peak
            iq = np.empty(2 * len(blk), np.float32)
            iq[0::2], iq[1::2] = blk.real, blk.imag
            dt = np.int8 if bits_per_sample == 8 else np.int16
            data = np.round(iq * scale).astype(dt).tobytes()
            hdr = struct.pack("<Bf", bits_per_sample, scale)
            f.write(ZIQ2_ASM + struct.pack(
                "<IB", len(hdr) + len(data), ZIQ2_PKT_IQ) + hdr + data)


def read_ziq2(path: str | Path) -> Tuple[np.ndarray, float]:
    """Returns (complex64 samples, samplerate)."""
    raw = Path(path).read_bytes()
    if raw[:4] != SIGNATURE2:
        raise ValueError("not a ZIQ2 file")
    pos = 4
    rate = 0.0
    chunks = []
    while pos + 9 <= len(raw):
        if raw[pos: pos + 4] == ZIQ2_ASM:
            pos += 4
        size, ptype = struct.unpack_from("<IB", raw, pos)
        pos += 5
        payload = raw[pos: pos + size]
        pos += size
        if ptype == ZIQ2_PKT_INFO and size >= 8:
            rate = float(struct.unpack_from("<Q", payload)[0])
        elif ptype == ZIQ2_PKT_IQ and size >= 5:
            depth, scale = struct.unpack_from("<Bf", payload)
            dt = np.int8 if depth == 8 else np.int16
            iq = np.frombuffer(payload[5:], dt).astype(np.float32) \
                / (scale or 1.0)
            chunks.append(iq[0::2] + 1j * iq[1::2])
    if not chunks:
        return np.zeros(0, np.complex64), rate
    return np.concatenate(chunks).astype(np.complex64), rate
