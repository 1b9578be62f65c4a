"""METEOR-M instruments: LRPT MSU-MR decoder (.cadu -> products).

Reference behavior: plugins/meteor_support/meteor/instruments/msumr/
module_meteor_msumr_lrpt.cpp (VCID 5, Demuxer(882, insert-zone), APIDs
64-69 = MSU-MR channels 1-6, APID 70 telemetry) and lrpt_msumr_reader.cpp
(43-packet transmission loop -> segment ids, rollover handling, channel
alignment). Each CCSDS packet carries one *segment*: a 14-byte header
(CDS time, MCU number, quality factor) + a standard-JPEG entropy-coded
strip of 14 8x8 blocks (image/jpeg.py). The split: entropy decode on the
host at packet rate; ONE batched dequant+IDCT over every block of a channel
on `torch_device` (default ``cuda``) at image-assembly time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from satdump_tpu_torch.ccsds import (CCSDSPacket, Demuxer, parse_ccsds_time_full_raw,
                               parse_vcdu)
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image import jpeg
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.utils.device import resolve_device

SEG_CNT = 20000             # image height guard (ref lrpt_msumr_reader.cpp:7)
SEG_W = 14 * 8              # pixels per segment strip (14 MCUs x 8)
LINE_SEGS = 14              # segments per image line -> 1568 px wide
INVALID = 0xFFFFFFFF

METEOR_NORAD = {"METEOR-M2": 40069, "METEOR-M2-2": 44387,
                "METEOR-M2-3": 57166, "METEOR-M2-4": 59051}

# Per-satellite attitude/timing settings matching the reference
# resources/projections_settings/meteor_m2*_msumr_lrpt.json files. MSU-MR
# LRPT carries ONE timestamp per 8-line strip; interpolate_timestamps: 8
# with the 0.2 s line scan time expands them to per-line values.
_MSUMR_LRPT_PROJ_COMMON = {
    "type": "normal_single_line", "image_width": 1568,
    "gcp_spacing_x": 100, "gcp_spacing_y": 100,
    "interpolate_timestamps": 8, "interpolate_timestamps_scantime": 0.2,
    "timefilter": {"type": "simple", "scan_time": 1.6, "max_diff": 10.0},
}
MSUMR_LRPT_PROJ = {
    "METEOR-M2": {"scan_angle": 110.6, "roll_offset": 2.3, "pitch_offset": 0,
                  "yaw_offset": 2.4, "timestamp_offset": 0.2,
                  **_MSUMR_LRPT_PROJ_COMMON},
    "METEOR-M2-2": {"scan_angle": 110.6, "roll_offset": 2.3, "pitch_offset": 0,
                    "yaw_offset": 2.4, "timestamp_offset": 0.2,
                    **_MSUMR_LRPT_PROJ_COMMON},
    "METEOR-M2-3": {"scan_angle": 110.1, "roll_offset": -0.31, "pitch_offset": 0,
                    "yaw_offset": 0, "timestamp_offset": 0,
                    **_MSUMR_LRPT_PROJ_COMMON},
    "METEOR-M2-4": {"scan_angle": 110.1, "roll_offset": -0.4, "pitch_offset": 0,
                    "yaw_offset": 0, "timestamp_offset": 1,
                    **_MSUMR_LRPT_PROJ_COMMON},
}


class Segment:
    """One MSU-MR LRPT segment (ref lrpt/segment.cpp). Holds the entropy-
    decoded coefficient blocks; pixels materialize in the batched IDCT."""

    __slots__ = ("valid", "partial", "timestamp", "mcun", "qf", "coeffs",
                 "n_blocks")

    def __init__(self, payload: bytes, partial: bool, m2x_mode: bool):
        self.valid = False
        self.partial = partial
        self.timestamp = 0.0
        self.mcun = 0
        self.qf = 0.0
        self.coeffs: Optional[np.ndarray] = None
        self.n_blocks = 0
        if len(payload) <= 14:
            return
        d = payload
        # header: 8B CDS time, MCUN, QT, DC/AC nibbles, QFM u16, QF
        qt = d[9]
        dc_ac = d[10]
        qfm = d[11] << 8 | d[12]
        if qt != 0x00 or dc_ac != 0x00 or qfm != 0xFFF0:
            return
        # m2x parses the day field; legacy M2 ignores it and the reader adds
        # the wall-clock day (module_meteor_msumr_lrpt.cpp:160)
        self.timestamp = parse_ccsds_time_full_raw(
            d[:8], 11322 * 86400 if m2x_mode else 0)
        self.mcun = d[8]
        self.qf = float(d[13])
        coeffs, done = jpeg.decode_mcus(bytes(d[14:]), LINE_SEGS)
        if done == 0:
            return
        if done < LINE_SEGS:
            self.partial = True
        self.coeffs = coeffs
        self.n_blocks = done
        self.valid = True


class MSUMRReader:
    """Arrange LRPT segments into per-channel images
    (ref lrpt_msumr_reader.cpp)."""

    def __init__(self, m2x_mode: bool, device=None):
        self.m2x = m2x_mode
        self.device = resolve_device(device)
        self.segments: List[Dict[int, Segment]] = [dict() for _ in range(6)]
        self.first_seg = [INVALID] * 6
        self.last_seg = [0] * 6
        self.rollover = [0] * 6
        self.last_seq = [0] * 6
        self.offset = [INVALID] * 6
        self.lines = [0] * 6
        self.timestamps: List[float] = []
        import time as _t
        now = int(_t.time()) + 3 * 3600
        self.day_value = now - now % 86400   # legacy-M2 Moscow-day base

    def work(self, pkt: CCSDSPacket) -> None:
        apid = pkt.header.apid
        if not (64 <= apid <= 69):
            return
        ch = apid - 64
        partial = (len(pkt.payload) - 1) != pkt.header.packet_length
        seg = Segment(bytes(pkt.payload), partial, self.m2x)
        if not seg.valid:
            return

        seq = pkt.header.packet_sequence_count
        mcu_count = seg.mcun // 14

        # sequence rollover (14-bit counter), 15% guard bands
        if self.last_seq[ch] > seq and self.last_seq[ch] > 13926 and seq < 2458:
            self.rollover[ch] += 16384
        if self.offset[ch] == INVALID:
            mcu_seq = seq + (16384 if mcu_count > seq else 0) - mcu_count
            self.offset[ch] = (mcu_seq + self.rollover[ch]) % 43
        # 43-packet loop: 14 segments x 3 channels + 1 telemetry
        sid = ((seq + self.rollover[ch] - self.offset[ch]) // 43) * 14 + mcu_count
        new_first = min(self.first_seg[ch], sid)
        new_last = max(self.last_seg[ch], sid)
        if new_last - new_first > SEG_CNT:
            return
        self.first_seg[ch] = new_first
        self.last_seg[ch] = new_last
        self.last_seq[ch] = seq
        self.segments[ch][sid] = seg

    # -- image assembly -------------------------------------------------------
    def _line_range(self, channel: int) -> Tuple[int, int]:
        """First/last segment id of the full image, aligned across channels
        (ref getChannel alignment block)."""
        first_line = INVALID
        last_line = 0
        first_before = INVALID
        last_before = 0
        first_after = INVALID
        last_after = 0
        ch_lowest_offset = 6
        ch_lowest_transmitted = 6
        for i in range(6):
            if self.offset[i] == INVALID:
                continue
            if ch_lowest_transmitted == 6:
                ch_lowest_transmitted = i
            cur = 43 if ch_lowest_offset == 6 else self.offset[ch_lowest_offset]
            if self.offset[i] < cur:
                ch_lowest_offset = i
        for i in range(6):
            if self.offset[i] == INVALID:
                continue
            first_line = min(first_line, self.first_seg[i])
            last_line = max(last_line, self.last_seg[i])
            if i < ch_lowest_offset:
                first_before = min(first_before, self.first_seg[i])
                last_before = max(last_before, self.last_seg[i])
            else:
                first_after = min(first_after, self.first_seg[i])
                last_after = max(last_after, self.last_seg[i])

        if ch_lowest_transmitted != ch_lowest_offset \
                and first_before != INVALID and first_after != INVALID:
            fdir = (first_before - first_before % 14) >= (first_after - first_after % 14)
            ldir = (last_before - last_before % 14) < (last_after - last_after % 14)
            if channel < ch_lowest_offset:
                if fdir:
                    first_line -= 14
                if ldir:
                    last_line -= 14
            else:
                if not fdir:
                    first_line += 14
                if not ldir:
                    last_line += 14

        last_line += 14
        if self.first_seg[channel] == INVALID:
            first_line = 0
        if self.last_seg[channel] == 0:
            last_line = 0
        first_line -= first_line % 14
        last_line -= last_line % 14
        return first_line, last_line

    def get_channel(self, channel: int) -> Tuple[np.ndarray, List[float]]:
        """-> ((lines, 1568) uint8, per-line timestamps). All blocks of the
        channel go through ONE batched dequant+IDCT."""
        first_line, last_line = self._line_range(channel)
        n_lines = ((last_line - first_line) // 14) * 8 if last_line else 0
        self.lines[channel] = n_lines
        img = np.zeros((max(n_lines, 0), LINE_SEGS * SEG_W), np.uint8)
        timestamps: List[float] = []
        if n_lines <= 0:
            return img, timestamps

        # batch every present segment's blocks
        segs = self.segments[channel]
        present = [sid for sid in range(first_line, last_line)
                   if sid in segs and segs[sid].valid]
        if present:
            coeffs = np.concatenate([segs[s].coeffs for s in present])
            qtabs = np.repeat(
                np.stack([jpeg.quantization_table(segs[s].qf) for s in present]),
                LINE_SEGS, axis=0)
            pixels = jpeg.dequantize_idct(coeffs, qtabs,   # (N*14, 8, 8)
                                          self.device)
            pixels = pixels.reshape(len(present), LINE_SEGS, 8, 8)

        for row_i, x in enumerate(range(first_line, last_line, 14)):
            line_ts = []
            for j in range(LINE_SEGS):
                sid = x + j
                if sid in segs and segs[sid].valid:
                    k = present.index(sid)
                    strip = pixels[k]           # (14, 8, 8)
                    n_ok = segs[sid].n_blocks
                    # (8, 112) strip: MCU m occupies columns 8m..8m+8
                    block = np.transpose(strip, (1, 0, 2)).reshape(8, SEG_W)
                    if n_ok < LINE_SEGS:
                        block = block.copy()
                        block[:, n_ok * 8:] = 0
                    img[row_i * 8:(row_i + 1) * 8,
                        j * SEG_W:(j + 1) * SEG_W] = block
                    ts = segs[sid].timestamp if self.m2x \
                        else self.day_value + segs[sid].timestamp - 3 * 3600
                    line_ts.append(ts)
            timestamps.append(float(np.median(line_ts)) if line_ts else -1.0)
        return img, timestamps


@register_module
class MeteorMSUMRLRPTModule(ProcessingModule):
    """cadu -> MSU-MR LRPT products (ref module_meteor_msumr_lrpt.cpp)."""

    id = "meteor_msumr_lrpt"

    def process(self):
        m2x = bool(self.param("m2x_mode", True))
        sat_name = str(self.param("satellite", "METEOR-M2-4"))
        reader = MSUMRReader(m2x, self.param("torch_device", "cuda"))
        demux = Demuxer(mpdu_data_size=882, has_insert_zone=True)

        cadus = np.fromfile(self.d_input_file, np.uint8)
        cadus = cadus[: len(cadus) // 1024 * 1024].reshape(-1, 1024)
        n_pkts = 0
        for cadu in cadus:
            if parse_vcdu(cadu).vcid != 5:
                continue
            for pkt in demux.work(bytes(cadu)):
                n_pkts += 1
                reader.work(pkt)

        out_dir = Path(self.d_output_file_hint).parent
        p = ImageProduct()
        p.instrument_name = "msu_mr"
        all_ts: List[float] = []
        n_ch = 0
        for ch in range(6):
            img, ts = reader.get_channel(ch)
            if img.shape[0] == 0:
                continue
            p.add_channel((img.astype(np.uint16) << 8), str(ch + 1),
                          bit_depth=16)
            if not all_ts and any(t > 0 for t in ts):
                all_ts = ts
            n_ch += 1
        logger.info(f"MSU-MR LRPT: {n_pkts} packets, {n_ch} channels, "
                    f"{max(reader.lines)} lines")

        ds = DataSet(sat_name, float(np.median([t for t in all_ts if t > 0]))
                     if any(t > 0 for t in all_ts) else -1.0)
        if n_ch:
            proj = dict(MSUMR_LRPT_PROJ.get(sat_name,
                                            MSUMR_LRPT_PROJ["METEOR-M2-4"]))
            proj["norad"] = METEOR_NORAD.get(sat_name, 0)
            p.set_proj_cfg_tle_timestamps(
                proj,
                {"name": sat_name, "norad": METEOR_NORAD.get(sat_name, 0)},
                all_ts or [-1.0])
            p.save(str(out_dir / "MSU-MR"))
            ds.products_list.append("MSU-MR")
        self.d_output_file = ds.save(str(out_dir))
        self.stats = {"packets": n_pkts, "channels": n_ch,
                      "lines": int(max(reader.lines))}
