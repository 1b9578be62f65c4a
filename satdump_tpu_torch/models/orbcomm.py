"""Orbcomm STX downlink: 4800-baud FSK VHF telemetry frames.

Behavioral equivalent of plugins/orbcomm_support/orbcomm/:
* stx_deframer.cpp:22-104 — bit-serial deframer for 4800-bit frames
  behind the 24-bit ASM 0xA6159F with inversion handling and a
  NOSYNC(0)/SYNCING(6)/SYNCED(8) tolerance ladder;
* module_orbcomm_stx_demod.cpp:46-120 — FSK chain (quadrature demod ->
  DC block -> RRC 0.4 -> M&M) feeding the deframer, output bytes
  bit-reversed;
* module_orbcomm_plotter.cpp:84-258 — packet parsing: 0x1F ephemeris
  (GPS week/TOW + 20-bit-packed ECEF position/velocity), 0x65 sync
  (downlink frequency), 0x1C channel tables, all guarded by the
  Fletcher-style additive FCS.

The demod front-end is the shared fsk_demod module (on the pipeline's
`torch_device`); this file is the frame-rate (600 B / 125 ms) host-side
layer, a copy of satdump_tpu/models/orbcomm.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module

STX_ASM = 0xA6159F
STX_ASM_BITS = 24
STX_FRM_BITS = 4800
STX_FRM_BYTES = STX_FRM_BITS // 8

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


class STXDeframer:
    """Bit-serial ASM sync with inversion recovery (stx_deframer.cpp).
    States double as Hamming-distance tolerances: NOSYNC=0 (exact match
    required), SYNCING=6, SYNCED=8."""

    STATE_NOSYNC = 0
    STATE_SYNCING = 6
    STATE_SYNCED = 8

    def __init__(self, frm_size: int = STX_FRM_BITS):
        self.frm_size = frm_size
        self.state = self.STATE_NOSYNC
        self._in_frame = False
        self._shifter = 0
        self._invert = False
        self._bits: List[int] = []
        self._good = 0
        self._bad = 0

    def _reset_frame(self):
        self._bits = [(STX_ASM >> i) & 1
                      for i in range(STX_ASM_BITS - 1, -1, -1)]

    def work(self, bits: np.ndarray) -> np.ndarray:
        """Unpacked hard bits -> (n, frm_size/8) frames (ASM included,
        inversion corrected)."""
        out = []
        asm = STX_ASM
        inv = STX_ASM ^ 0xFFFFFF
        for b in np.asarray(bits, np.uint8) & 1:
            b = int(b)
            self._shifter = (self._shifter << 1 | b) & 0xFFFFFF
            if self._in_frame:
                self._bits.append(b ^ self._invert)
                n = len(self._bits)
                if n == self.frm_size:
                    out.append(np.packbits(
                        np.array(self._bits, np.uint8)))
                elif n == self.frm_size + STX_ASM_BITS - 1:
                    self._in_frame = False
                continue
            dist_cur = bin(self._shifter
                           ^ (inv if self._invert else asm)).count("1")
            if self.state == self.STATE_NOSYNC:
                if self._shifter == asm or self._shifter == inv:
                    self._invert = self._shifter == inv
                    self._reset_frame()
                    self._in_frame = True
                    self.state = self.STATE_SYNCING
                    self._good = self._bad = 0
            elif self.state == self.STATE_SYNCING:
                if dist_cur < self.state:
                    self._reset_frame()
                    self._in_frame = True
                    self._bad = 0
                    self._good += 1
                    if self._good > 10:
                        self.state = self.STATE_SYNCED
                else:
                    self._bad += 1
                    self._good = 0
                    if self._bad > 2:
                        self.state = self.STATE_NOSYNC
            else:  # SYNCED
                if dist_cur < self.state:
                    self._reset_frame()
                    self._in_frame = True
                else:
                    self._good = self._bad = 0
                    self.state = self.STATE_NOSYNC

        return (np.stack(out) if out
                else np.zeros((0, self.frm_size // 8), np.uint8))


def reverse_bits(frames: np.ndarray) -> np.ndarray:
    """Per-byte bit reversal (utils/binary.h reverseBits, applied to
    every deframed byte in module_orbcomm_stx_demod.cpp:105-107)."""
    return _REV8[np.asarray(frames, np.uint8)]


def orbcomm_fcs(data: np.ndarray) -> int:
    """Additive Fletcher-style check (module_orbcomm_plotter.cpp:86-97);
    zero for an error-free packet."""
    c0 = c1 = 0
    for byte in np.asarray(data, np.uint8):
        c0 = (c0 + int(byte)) & 0xFF
        c1 = (c1 + c0) & 0xFF
    return (c0 + c1) & 0xFF


def calc_freq(f: int, small: bool = True) -> float:
    """Channel index -> downlink MHz (orbcomm_calcFreq)."""
    if small:
        if f <= 0x40:
            f = 1 << 8 | f
        elif f >= 0x50:
            f = 0 << 8 | f
    return 137.0 + f * 0.0025


def _repack_20(data: np.ndarray) -> List[int]:
    """15 bytes -> six 20-bit values (common/repack.h
    repackBytesTo20bits semantics: MSB-first bit stream)."""
    bits = np.unpackbits(np.asarray(data, np.uint8))
    return [int(bits[i * 20: (i + 1) * 20] @
                (1 << np.arange(19, -1, -1))) for i in range(6)]


_GPS_EPOCH_UNIX = 315964800
# GPS seconds at each leap insertion (module_orbcomm_plotter.cpp:25-27)
_LEAPS = [46828800, 78364801, 109900802, 173059203, 252028804, 315187205,
          346723206, 393984007, 425520008, 457056009, 504489610, 551750411,
          599184012, 820108813, 914803214, 1025136015, 1119744016,
          1167264017]


def gps_to_unix(week: int, tow: int) -> int:
    g = week * 604800 + tow
    nleaps = sum(1 for i, ls in enumerate(_LEAPS) if g >= ls - i)
    return g + _GPS_EPOCH_UNIX - nleaps


def parse_frame(frame: np.ndarray) -> List[dict]:
    """One 600-byte frame -> list of parsed packets (12-byte slots,
    module_orbcomm_plotter.cpp:127-258)."""
    from satdump_tpu_torch.geo.geodetic import ecef_to_lla
    frame = np.asarray(frame, np.uint8)
    out: List[dict] = []
    MAX_R = 8378155.0
    V20 = 1048576.0
    for i in range(len(frame) // 12):
        pkt = frame[i * 12:]
        if pkt[0] == 0x1F and len(pkt) >= 24 and orbcomm_fcs(pkt[:24]) == 0:
            p = pkt[:24].copy()
            p[2:22] = p[2:22][::-1]
            scid = int(p[1])
            week = int(p[2]) << 8 | int(p[3])
            tow = int(p[4]) << 16 | int(p[5]) << 8 | int(p[6])
            v = _repack_20(p[7:22])
            xyz = [(2.0 * v[5 - k] * MAX_R / V20 - MAX_R) / 1e3
                   for k in range(3)]
            lla = ecef_to_lla(np.array(xyz))
            out.append({"type": "ephemeris", "scid": scid + 70,
                        "timestamp": gps_to_unix(week, tow),
                        "x": xyz[0], "y": xyz[1], "z": xyz[2],
                        "lat": float(lla[0]), "lon": float(lla[1]),
                        "alt": float(lla[2])})
        elif pkt[0] == 0x65 and len(pkt) >= 24 \
                and orbcomm_fcs(pkt[:24]) == 0:
            out.append({"type": "sync", "freq_mhz": calc_freq(int(pkt[5]))})
        elif pkt[0] == 0x1C and len(pkt) >= 12 \
                and orbcomm_fcs(pkt[:12]) == 0:
            p = pkt[:12].copy()
            p[2:10] = p[2:10][::-1]
            bits = np.unpackbits(p[2:10])[4:]          # shift left 4 bits
            vals = [int(bits[k * 12: (k + 1) * 12]
                        @ (1 << np.arange(11, -1, -1))) for k in range(5)]
            out.append({"type": "channels", "pos": int(p[1]) & 0xF,
                        "freqs_mhz": [calc_freq(v, False)
                                      for v in vals if v]})
    return out


def make_fcs_packet(body: np.ndarray, total: int) -> np.ndarray:
    """TX fixture: append the 2-byte additive check so orbcomm_fcs
    (over `total` bytes) returns 0."""
    pkt = np.zeros(total, np.uint8)
    pkt[: len(body)] = np.asarray(body, np.uint8)
    n = total - 2
    c0 = c1 = 0
    for byte in pkt[:n]:
        c0 = (c0 + int(byte)) & 0xFF
        c1 = (c1 + c0) & 0xFF
    # after appending (a, b): sum = c1 + 3*c0 + 3*a + 2*b (mod 256);
    # a's parity fixes solvability of 2*b, so search a in {0,1}
    for a in range(2):
        rhs = (-(c1 + 3 * c0 + 3 * a)) % 256
        if rhs % 2 == 0:
            pkt[n] = a
            pkt[n + 1] = rhs // 2
            assert orbcomm_fcs(pkt[:total]) == 0
            return pkt
    raise AssertionError("unreachable: one parity always solves")


def make_ephemeris_packet(scid: int, timestamp: int, xyz_km) -> np.ndarray:
    """TX fixture: 24-byte wire-order 0x1F packet (inverse of
    parse_frame's ephemeris branch, FCS appended)."""
    # invert gps_to_unix's leap-second subtraction by direct search
    for nleaps in range(len(_LEAPS) + 1):
        g = timestamp - _GPS_EPOCH_UNIX + nleaps
        if gps_to_unix(g // 604800, g % 604800) == timestamp:
            break
    week, tow = g // 604800, g % 604800
    MAX_R = 8378155.0
    V20 = 1048576.0
    raw = [round((v * 1e3 + MAX_R) / (2.0 * MAX_R) * V20)
           for v in xyz_km]
    vals = [0, 0, 0, raw[2], raw[1], raw[0]]      # v5=x, v4=y, v3=z
    bits = np.concatenate([
        np.array([(v >> (19 - k)) & 1 for k in range(20)], np.uint8)
        for v in vals])
    q = np.zeros(22, np.uint8)
    q[0], q[1] = 0x1F, scid - 70
    q[2], q[3] = week >> 8, week & 0xFF
    q[4], q[5], q[6] = tow >> 16, (tow >> 8) & 0xFF, tow & 0xFF
    q[7:22] = np.packbits(bits)
    wire = q.copy()
    wire[2:22] = q[2:22][::-1]
    return make_fcs_packet(wire, 24)


def make_frame(packets, fill: Optional[np.ndarray] = None) -> np.ndarray:
    """TX fixture: 600-byte decoded-order frame. Slot 0 is the on-air
    sync packet 0x65 (whose first bytes are the bit-reversed ASM);
    `packets` is a list of (slot_index, wire_bytes). `fill` sets the
    unused slot bytes (real downlinks are never long zero runs — an
    all-zero filler droops through the FSK DC blocker)."""
    frame = (np.zeros(STX_FRM_BYTES, np.uint8) if fill is None
             else np.asarray(fill, np.uint8).copy())
    sync = np.zeros(22, np.uint8)
    sync[0:3] = reverse_bits(np.array([0xA6, 0x15, 0x9F], np.uint8))
    frame[0:24] = make_fcs_packet(sync, 24)
    for slot, pkt in packets:
        frame[slot * 12: slot * 12 + len(pkt)] = pkt
    return frame


def frame_to_channel_bits(frame: np.ndarray) -> np.ndarray:
    """TX fixture: decoded-order frame -> 4800 on-air bits (inverse of
    deframe + per-byte reversal)."""
    return np.unpackbits(reverse_bits(np.asarray(frame, np.uint8)))


@register_module
class OrbcommSTXDeframerModule(ProcessingModule):
    """soft FSK bits -> 600-byte STX frames (.frm), bit-reversed per
    byte as in module_orbcomm_stx_demod.cpp:105-107."""

    id = "orbcomm_stx_deframer"

    def process(self):
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        frames = STXDeframer().work(bits)
        frames = reverse_bits(frames)
        out_path = self.d_output_file_hint + ".frm"
        frames.tofile(out_path)
        self.d_output_file = out_path
        self.stats = {"frames": int(len(frames))}
        logger.info(f"Orbcomm STX: {len(frames)} frames")


@register_module
class OrbcommPlotterModule(ProcessingModule):
    """STX frames -> parsed ephemeris/sync/channel packets as JSON
    (headless equivalent of the plotter's log + ephem list)."""

    id = "orbcomm_plotter"

    def process(self):
        raw = np.fromfile(self.d_input_file, np.uint8)
        n = len(raw) // STX_FRM_BYTES
        packets: List[dict] = []
        for i in range(n):
            packets += parse_frame(raw[i * STX_FRM_BYTES:
                                       (i + 1) * STX_FRM_BYTES])
        out_path = Path(self.d_output_file_hint).parent / "orbcomm.json"
        out_path.write_text(json.dumps(packets, indent=1))
        self.d_output_file = str(out_path)
        eph = sum(1 for p in packets if p["type"] == "ephemeris")
        self.stats = {"frames": n, "packets": len(packets),
                      "ephemeris": eph}
        logger.info(f"Orbcomm: {len(packets)} packets ({eph} ephemeris)"
                    f" from {n} frames")
