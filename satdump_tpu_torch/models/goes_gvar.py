"""GOES GVAR (legacy GOES-N imager) chain: .soft -> 32786-byte GVAR frames
-> imager channel products.

Reference: plugins/goes_support/goes/gvar/ — the decoder byte-packs soft
bits, NRZ-S diff-decodes, deframes on the 64-bit PN sync word (262288-bit
frames, early-abort on a new sync) and XORs the x^15+x^8 PN derandomizer
table with alternate-byte complement (gvar_derand.cpp:48-58); the image
decoder majority-votes the triple 30-byte block header, parses the
10-bit-word line documentation header, and assembles IR block 1/2 (two
detector lines per scan, two channels per reader) and VIS blocks 3..10
(eight detector lines per scan) into full-disk channel images
(module_gvar_image_decoder.cpp, image/*.cpp). The sounder readout and the
IR detector calibration LUTs are not ported.

Deframing is one correlate-everywhere pass over the diff-decoded bit
stream; line assembly keeps a sparse {line: row} map instead of
preallocated 20944 x 10832 full-disk buffers.

Counterpart of satdump_tpu/models/goes_gvar.py (host NumPy, copied): the
psk_demod in front of these modules runs on the pipeline's `torch_device`;
these modules take none."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec.deframer import correlate_bits
from satdump_tpu_torch.ops.fec.differential import nrzs_decode
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet

ASM_SYNC = 0b0001101111100111110100000001111110111111100000001111111111111110
FRAME_BITS = 262288
FRAME_BYTES = 32786

IR_WIDTH = 5236
VIS_WIDTH = 20944


def gvar_derand_table() -> np.ndarray:
    """PN table: x^15+x^8 LFSR seeded 0b101001110110101, first 10032 output
    bits discarded (gvar_derand.cpp:13-44). The reference stops the LFSR at
    262288 bits and XORs the frame tail with uninitialized memory; we run
    the sequence over the full 32778-byte frame body instead."""
    total = 10032 + (FRAME_BYTES - 8) * 8
    shifter = 0b101001110110101
    bits = np.empty(total, np.uint8)
    for i in range(total):
        out = ((shifter >> 14) & 1) ^ ((shifter >> 7) & 1)
        shifter = ((shifter << 1) | out) & 0xFFFF
        bits[i] = out
    return np.packbits(bits[10032:])


_DERAND: Optional[np.ndarray] = None


def derand_frame(frame: np.ndarray) -> np.ndarray:
    """XOR the PN table over frame bytes 8.., complementing odd-index bytes
    (gvar_derand.cpp:48-58)."""
    global _DERAND
    if _DERAND is None:
        _DERAND = gvar_derand_table()
    out = frame.copy()
    n = len(frame) - 8
    t = _DERAND[:n].copy()
    t[1::2] ^= 0xFF
    out[8: 8 + n] ^= t[: n]
    return out


def rand_frame_tx(frame: np.ndarray) -> np.ndarray:
    """TX inverse (XOR is an involution)."""
    return derand_frame(frame)


class GVARDeframer:
    """Correlate-everywhere deframer on the diff-decoded bit stream.
    Frames are FRAME_BITS long, truncated (zero-padded) when the next sync
    arrives early (gvar_deframer.cpp:96-146)."""

    def __init__(self):
        self.pattern = ((ASM_SYNC >> np.arange(63, -1, -1)) & 1
                        ).astype(np.uint8)
        self._tail = np.zeros(0, np.uint8)

    def work(self, bits: np.ndarray, last: bool = False) -> List[np.ndarray]:
        stream = np.concatenate([self._tail, np.asarray(bits, np.uint8)])
        if len(stream) < 64:
            self._tail = stream
            return []
        dist = correlate_bits(stream, self.pattern)
        hits = np.flatnonzero(dist == 0)
        frames = []
        consumed = max(len(stream) - FRAME_BITS, 0) if not last \
            else len(stream)
        for k, h in enumerate(hits):
            h = int(h)
            end = min(int(hits[k + 1]) if k + 1 < len(hits)
                      else h + FRAME_BITS, h + FRAME_BITS)
            if end > len(stream) and not last:
                consumed = h        # partial frame: keep for the next call
                break
            fb = stream[h: min(end, len(stream))]
            if len(fb) < FRAME_BITS:
                fb = np.concatenate(
                    [fb, np.zeros(FRAME_BITS - len(fb), np.uint8)])
            frames.append(np.packbits(fb))
            consumed = max(consumed, end)
        self._tail = stream[consumed:]
        return frames


@register_module
class GVARDecoderModule(ProcessingModule):
    id = "goes_gvar_decoder"

    def process(self):
        out_path = self.d_output_file_hint + ".gvar"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        bits, _ = nrzs_decode(bits)
        deframer = GVARDeframer()
        n = 0
        with open(out_path, "wb") as f:
            for frm in deframer.work(bits, last=True):
                f.write(derand_frame(frm).tobytes())
                n += 1
        self.stats = {"frame_count": n,
                      "deframer_lock": bool(n)}
        logger.info(f"GVAR: {n} frames")


def unpack_words10(data: np.ndarray, nwords: int, bit_offset: int = 0
                   ) -> np.ndarray:
    bits = np.unpackbits(np.asarray(data, np.uint8))[bit_offset:]
    n = min(nwords, len(bits) // 10)
    w = (1 << np.arange(9, -1, -1))
    return (bits[: n * 10].reshape(n, 10) @ w).astype(np.uint16)


def majority_header(frame: np.ndarray) -> np.ndarray:
    """Triple-redundant 30-byte primary header, bit-level majority
    (module_gvar_image_decoder.cpp:44-92)."""
    a = frame[8:38].copy()
    b = frame[38:68].copy()
    c = frame[68:98].copy()
    a[0] &= 0xF
    b[0] &= 0xF
    c[0] &= 0xF
    return ((a & b) | (b & c) | (a & c)).astype(np.uint8)


class LineDocHeader:
    """gvar_headers.h:306-349 — 16 10-bit words."""

    def __init__(self, data: np.ndarray):
        w = unpack_words10(data, 16)
        self.sc_id = int(w[0])
        self.sps_id = int(w[1])
        self.l_side = int(w[2])
        self.detector_number = int(w[3])
        self.source_channel = int(w[4])
        self.relative_scan_count = int(w[5]) << 10 | int(w[6])
        self.pixel_count = int(w[9]) << 10 | int(w[10])
        self.word_count = int(w[11]) << 10 | int(w[12])


class InfraredReader:
    """infrared1_reader.cpp / infrared2_reader.cpp — one block carries two
    detector lines of two channels, 10-bit words starting at word 16 with
    per-channel stride word_cnt."""

    def __init__(self):
        self.rows1: Dict[int, np.ndarray] = {}
        self.rows2: Dict[int, np.ndarray] = {}

    def push_frame(self, data: np.ndarray, counter: int, word_cnt: int
                   ) -> None:
        words = unpack_words10(data, 5252 * 4)
        for half in range(2):
            for chan, rows in ((0, self.rows1), (1, self.rows2)):
                start = 16 + word_cnt * (chan * 2 + half)
                seg = words[start: start + IR_WIDTH]
                row = np.zeros(IR_WIDTH, np.uint16)
                row[: len(seg)] = seg << 6
                rows[counter * 2 + half] = row

    def image(self, chan: int) -> np.ndarray:
        rows = self.rows1 if chan == 0 else self.rows2
        if not rows:
            return np.zeros((0, IR_WIDTH), np.uint16)
        h = max(rows) + 1
        img = np.zeros((h, IR_WIDTH), np.uint16)
        for y, r in rows.items():
            img[y] = r
        return img


class VisibleReader:
    """visible_reader.cpp — VIS blocks 3..10 are the 8 detector lines of a
    scan; pixels are 10-bit words at byte 116 + 6-bit shift."""

    def __init__(self):
        self.rows: Dict[int, np.ndarray] = {}

    def push_frame(self, frame: np.ndarray, block: int, counter: int
                   ) -> None:
        words = unpack_words10(frame[116:], VIS_WIDTH + 4, bit_offset=6)
        row = np.zeros(VIS_WIDTH, np.uint16)
        seg = words[1: 1 + VIS_WIDTH]
        row[: len(seg)] = seg << 6
        self.rows[counter * 8 + (block - 3)] = row

    def image(self) -> np.ndarray:
        if not self.rows:
            return np.zeros((0, VIS_WIDTH), np.uint16)
        h = max(self.rows) + 1
        img = np.zeros((h, VIS_WIDTH), np.uint16)
        for y, r in self.rows.items():
            img[y] = r
        return img


@register_module
class GVARImageDecoderModule(ProcessingModule):
    id = "goes_gvar_image_decoder"

    def process(self):
        directory = str(Path(self.d_output_file_hint).parent)
        Path(directory).mkdir(parents=True, exist_ok=True)
        self.d_output_file = directory
        ir1 = InfraredReader()
        ir2 = InfraredReader()
        vis = VisibleReader()
        scids: List[int] = []
        nimagery = 0
        raw = np.fromfile(self.d_input_file, np.uint8)
        nfrm = len(raw) // FRAME_BYTES
        for i in range(nfrm):
            frame = raw[i * FRAME_BYTES: (i + 1) * FRAME_BYTES]
            hdr = majority_header(frame)
            # spare2 (bytes 24-27, always zero) junk check
            # (module_gvar_image_decoder.cpp:132-156)
            if np.unpackbits(hdr[24:28]).sum() > 4:
                continue
            block_id = int(hdr[0])
            if not 1 <= block_id <= 10:
                continue
            line = LineDocHeader(frame[98:])
            counter = line.relative_scan_count & 0x7FF
            if counter > 1354:
                continue
            scids.append(line.sc_id)
            nimagery += 1
            if block_id in (1, 2):
                words = min(line.word_count & 0x1FFF, 6565)
                (ir1 if block_id == 1 else ir2).push_frame(
                    frame[98:], counter, words)
            else:
                vis.push_frame(frame, block_id, counter)
        sat = int(np.bincount(scids).argmax()) if scids else 0
        ds = DataSet(satellite_name=f"GOES-{sat}", timestamp=0.0)
        channels = [("1", vis.image()), ("2", ir1.image(0)),
                    ("3", ir1.image(1)), ("4", ir2.image(0)),
                    ("5", ir2.image(1))]
        if any(img.size for _, img in channels):
            prod = ImageProduct()
            prod.instrument_name = "gvar_imager"
            prod.set_product_source(f"GOES-{sat}")
            for name, img in channels:
                if img.size:
                    prod.add_channel(img, name, bit_depth=10)
            prod.save(str(Path(directory) / "IMAGER"))
            ds.products_list.append("IMAGER")
            ds.save(directory)
        self.stats = {"imagery_frames": nimagery, "satellite": sat,
                      "vis_lines": len(vis.rows)}
        logger.info(f"GVAR imager: {nimagery} imagery frames "
                    f"(GOES-{sat}, {len(vis.rows)} VIS lines)")
