"""Radiosonde decoding: M10/M20 weather-balloon telemetry.

Behavioral equivalent of plugins/radiosonde_support/m10/ (m10.cpp:9-64,
m10_decoder.cpp:45-85, m10_parser.cpp:27-43): a 9600-baud FSK bit stream
carries Manchester-coded, scrambled 104-byte frames behind the 48-bit
channel sync 0x66666666b366. Decode chain: sync-correlate -> take the
second bit of each Manchester pair -> descramble (per-byte feedback
whitener) -> length/CRC check -> parse GPS position (type 0x9F; M20 type
0x20 carries a different layout).

Everything is vectorized over frame candidates at once (the per-sample
shift-register correlation of the reference becomes one windowed
compare); frames are ~100 bytes at 2.4 Hz so this layer is host-side
NumPy by design — the sample-rate FSK front-end (fsk_demod) runs on the
pipeline's `torch_device`. A copy of satdump_tpu/models/radiosonde.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module

M10_BAUDRATE = 9600.0
M10_SYNCWORD = 0x66666666B366          # 48 channel bits
M10_SYNC_BITS = 48
M10_FRAME_CHANNEL_BITS = 1664          # 208 bytes raw -> 104 decoded
M10_FRAME_LEN = 104
M10_FTYPE_DATA = 0x9F
M20_FTYPE_DATA = 0x20
_GPS_EPOCH_UNIX = 315964800            # 1980-01-06


def _sync_bits() -> np.ndarray:
    return np.array([(M10_SYNCWORD >> (M10_SYNC_BITS - 1 - i)) & 1
                     for i in range(M10_SYNC_BITS)], np.uint8)


def manchester_decode(bits: np.ndarray) -> np.ndarray:
    """Channel bits (..., 2n) -> decoded bytes (..., n//8): the second
    bit of each pair is the data bit (m10.cpp:9-16)."""
    bits = np.asarray(bits, np.uint8)
    data = bits[..., 1::2]
    return np.packbits(data, axis=-1)


def frame_descramble(frm: np.ndarray) -> np.ndarray:
    """(..., 104) bytes: out[i] = in[i] ^ 0xFF ^ ((in[i-1]&1)<<7 |
    in[i]>>1) (m10.cpp:18-28), vectorized with a shifted copy."""
    frm = np.asarray(frm, np.uint8)
    prev = np.roll(frm, 1, axis=-1)
    prev[..., 0] = 0
    return frm ^ 0xFF ^ (((prev & 1) << 7) | (frm >> 1))


def frame_scramble(frm: np.ndarray) -> np.ndarray:
    """Inverse of frame_descramble (TX fixture). Solved MSB-to-LSB per
    byte: b7_in = b7_out ^ 1 ^ (in[i-1]&1), b_k_in = b_k_out ^ 1 ^
    b_{k+1}_in."""
    out = np.asarray(frm, np.uint8)
    res = np.zeros_like(out)
    shape = out.shape
    flat = out.reshape(-1, shape[-1])
    rflat = res.reshape(-1, shape[-1])
    for r in range(flat.shape[0]):
        prev = 0
        for i in range(shape[-1]):
            o = int(flat[r, i])
            b = 0
            hi = ((o >> 7) & 1) ^ 1 ^ (prev & 1)
            b |= hi << 7
            for k in range(6, -1, -1):
                bk = ((o >> k) & 1) ^ 1 ^ ((b >> (k + 1)) & 1)
                b |= bk << k
            rflat[r, i] = b
            prev = b
        res.reshape(-1, shape[-1])[r] = rflat[r]
    return res


def _crc_step(crc: int, byte: int) -> int:
    """One byte of the M10 CRC (m10.cpp:40-59)."""
    c = crc
    c1 = c & 0xFF
    b = ((byte >> 1) | ((byte & 1) << 7)) & 0xFF
    b ^= (b >> 2) & 0xFF
    t6 = (c & 1) ^ ((c >> 2) & 1) ^ ((c >> 4) & 1)
    t7 = ((c >> 1) & 1) ^ ((c >> 3) & 1) ^ ((c >> 5) & 1)
    t = (c & 0x3F) | (t6 << 6) | (t7 << 7)
    s = (c >> 7) & 0xFF
    s ^= (s >> 2) & 0xFF
    c0 = b ^ t ^ s
    return ((c1 << 8) | c0) & 0xFFFF


def frame_crc(frame: np.ndarray) -> int:
    """CRC over frame[3 : 3+len-1] (from the length byte up to, not
    including, the 2-byte big-endian CRC at 3+len-1)."""
    frame = np.asarray(frame, np.uint8)
    ln = int(frame[3])
    crc = 0
    for byte in frame[3: 3 + ln - 1]:
        crc = _crc_step(crc, int(byte))
    return crc


def frame_crc_check(frame: np.ndarray) -> bool:
    frame = np.asarray(frame, np.uint8)
    ln = int(frame[3])
    if ln == 0 or ln > M10_FRAME_LEN - 3:
        return False
    exp = int(frame[3 + ln - 1]) << 8 | int(frame[3 + ln])
    return frame_crc(frame) == exp


def find_frames(bits: np.ndarray, max_errors: int = 2) -> np.ndarray:
    """Hard channel bits -> (n, 104) CRC-valid descrambled frames.
    Correlates the 48-bit sync over every offset at once (the reference
    walks a 1664-bit shift register per sample, m10_decoder.cpp:45-85)."""
    bits = np.asarray(bits, np.uint8).reshape(-1) & 1
    if len(bits) < M10_FRAME_CHANNEL_BITS:
        return np.zeros((0, M10_FRAME_LEN), np.uint8)
    sync = _sync_bits()
    win = np.lib.stride_tricks.sliding_window_view(bits, M10_SYNC_BITS)
    errs = np.count_nonzero(win != sync, axis=1)
    cand = np.nonzero(errs <= max_errors)[0]
    cand = cand[cand + M10_FRAME_CHANNEL_BITS <= len(bits)]
    out = []
    last = -M10_FRAME_CHANNEL_BITS
    for pos in cand:
        if pos - last < M10_FRAME_CHANNEL_BITS // 2:
            continue
        raw = bits[pos: pos + M10_FRAME_CHANNEL_BITS]
        frame = frame_descramble(manchester_decode(raw))
        if frame_crc_check(frame):
            out.append(frame)
            last = pos
    return (np.stack(out) if out
            else np.zeros((0, M10_FRAME_LEN), np.uint8))


def parse_frame(frame: np.ndarray) -> Optional[dict]:
    """Type-0x9F GPS telemetry -> dict (m10_parser.cpp:27-43). Offsets
    are into the 104-byte decoded frame (M10Frame_9f in m10.h)."""
    frame = np.asarray(frame, np.uint8)
    ftype = int(frame[4])
    if ftype != M10_FTYPE_DATA:
        return {"type": ftype} if ftype == M20_FTYPE_DATA else None

    def be(off, n):
        v = 0
        for i in range(n):
            v = v << 8 | int(frame[off + i])
        return v

    def sbe32(off):
        v = be(off, 4)
        return v - (1 << 32) if v >= (1 << 31) else v

    # struct offsets: sync 0-2, len 3, type 4, small_values 5-6,
    # dlat/dlon/dalt 7-12, time 13-16, lat 17-20, lon 21-24, alt 25-28,
    # pad 29-32, sat_count 33, pad 34, week 35-36
    ms = be(13, 4)
    week = be(35, 2)
    return {
        "type": ftype,
        "timestamp": ms // 1000 + 86400 * 7 * week + _GPS_EPOCH_UNIX,
        "lat": sbe32(17) * 360.0 / (1 << 32),
        "lon": sbe32(21) * 360.0 / (1 << 32),
        "alt": sbe32(25) / 1e3,
        "sat_count": int(frame[33]),
        # raw velocity counts (dlat/dlon/dalt in m10.h are labeled
        # x/y/z velocity; the reference parser does not scale them)
        "dlat": be(7, 2), "dlon": be(9, 2), "dalt": be(11, 2),
    }


# ---------------------------------------------------------------------------
# TX fixture (the reference has none; needed for loopback tests)
# ---------------------------------------------------------------------------
def encode_frame(payload: dict) -> np.ndarray:
    """Build the 1664 channel bits of one type-0x9F frame carrying the
    given GPS fields. Exact inverse of the decode chain."""
    frame = np.zeros(M10_FRAME_LEN, np.uint8)
    ln = 100
    frame[3] = ln
    frame[4] = M10_FTYPE_DATA

    def put_be(off, v, n):
        v = int(v) & ((1 << (8 * n)) - 1)
        for i in range(n):
            frame[off + i] = (v >> (8 * (n - 1 - i))) & 0xFF

    t = int(payload.get("timestamp", 0)) - _GPS_EPOCH_UNIX
    week = t // (86400 * 7)
    put_be(13, (t - week * 86400 * 7) * 1000, 4)
    put_be(35, week, 2)
    put_be(17, round(payload.get("lat", 0.0) / 360.0 * (1 << 32)), 4)
    put_be(21, round(payload.get("lon", 0.0) / 360.0 * (1 << 32)), 4)
    put_be(25, round(payload.get("alt", 0.0) * 1e3), 4)
    frame[33] = payload.get("sat_count", 8)
    crc = frame_crc(frame)
    frame[3 + ln - 1] = crc >> 8
    frame[3 + ln] = crc & 0xFF

    # frame[0:3] must equal whatever the fixed channel sync decodes to,
    # since the scrambler feedback runs through them
    sync = _sync_bits()
    sync_dec = frame_descramble(
        np.concatenate([manchester_decode(sync), np.zeros(101, np.uint8)])
    )[:3]
    frame[0:3] = sync_dec

    scr = frame_scramble(frame[None])[0]
    data_bits = np.unpackbits(scr)
    chan = np.empty(M10_FRAME_CHANNEL_BITS, np.uint8)
    chan[0::2] = 1 - data_bits
    chan[1::2] = data_bits
    chan[:M10_SYNC_BITS] = sync      # first bits of the pairs are free
    return chan


@register_module
class M10DecoderModule(ProcessingModule):
    """soft FSK bits -> M10 frames + parsed positions. The reference runs
    this as an ndsp flowgraph pair (m10_decoder_hh + m10_parser_h); here
    it is one pipeline module emitting a .frm file and a JSON track."""

    id = "radiosonde_m10_decoder"

    def process(self):
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        frames = find_frames(bits)
        out_path = self.d_output_file_hint + ".frm"
        frames.astype(np.uint8).tofile(out_path)
        self.d_output_file = out_path
        track = [p for p in (parse_frame(f) for f in frames) if p]
        if track:
            tp = Path(self.d_output_file_hint).parent / "m10_track.json"
            tp.write_text(json.dumps(track, indent=1))
        self.stats = {"frames": int(len(frames)),
                      "positions": len(track)}
        logger.info(f"M10: {len(frames)} frames, {len(track)} positions")
