"""MSG SEVIRI L1.5 native (.nat) ingest.

Parses the EUMETSAT MPEF "native" wrapper: fixed-offset ASCII main-product
header records, the 15HEADER GADS block (per-channel calibration slope /
offset as big-endian f64), the 15TRAILER (HRV actual-window line/column
registration), and the per-line CCSDS-wrapped 10-bit packed image data for
the 11 VIS/IR channels + 3x-rate HRV.

Behavioral reference: plugins/firstparty_support/processors/nat/msg/
seviri_nat.cpp:14-303 (offsets, HRV lower/upper window placement, the
final full mirror, geos projection constants) — re-expressed as vectorized
NumPy over whole lines instead of per-pixel set() loops.
"""

from __future__ import annotations

import calendar
import re
import struct
import time
from typing import Optional

import numpy as np

from satdump_tpu_torch.products.calibration import (ImageCalibrator,
                                                    calibrator_registry,
                                                    freq_to_wavenumber)
from satdump_tpu_torch.products.image_product import (ChannelTransform,
                                                      ImageProduct)
from satdump_tpu_torch.utils.repack import repack_10bit

# Central wavelengths (m) of SEVIRI channels 1..12 (VIS0.6 .. HRV); ref
# resources/calibration/SEVIRI_table.json.
SEVIRI_WAVELENGTHS = [0.635e-6, 0.81e-6, 1.64e-6, 3.92e-6, 6.25e-6,
                      7.35e-6, 8.70e-6, 9.66e-6, 10.80e-6, 12.00e-6,
                      13.40e-6, 0.75e-6]

# Fixed byte offsets of the 48 main-product-header text records
# (seviri_nat.cpp:20-73). Records 6-10 are split in two pieces.
_MH_OFFSETS = ([0, 80, 160, 240, 320, 400]
               + [480, 542, 604, 666, 728]          # 6..10 (first piece)
               + [2154 + 80 * i for i in range(37)])  # 11..47
_MH_SECOND_PIECE = {6: 526, 7: 588, 8: 650, 9: 712, 10: 774}


def _mh_record(buf: bytes, idx: int) -> str:
    def cstr(off, lim):
        raw = buf[off:off + lim]
        for stop in (b"\x00", b"\n"):
            cut = raw.find(stop)
            if cut >= 0:
                raw = raw[:cut]
        return raw.decode("latin-1", "replace")

    s = cstr(_MH_OFFSETS[idx], 46 if idx in _MH_SECOND_PIECE else 80)
    if idx in _MH_SECOND_PIECE:
        s += cstr(_MH_SECOND_PIECE[idx], 16)
    return s


def _value(rec: str) -> str:
    return rec.split(":", 1)[1].strip() if ":" in rec else ""


def _last_int(rec: str) -> int:
    nums = re.findall(r"-?\d+", _value(rec))
    return int(nums[-1]) if nums else 0


def _first_num(rec: str) -> float:
    nums = re.findall(r"-?\d+(?:\.\d+)?", _value(rec))
    return float(nums[0]) if nums else 0.0


def is_seviri_nat(head: bytes) -> bool:
    return b"FormatName" in head[:80] or b"NumberLinesVISIR" in head[:6000]


def parse_seviri_nat(data: bytes) -> Optional[ImageProduct]:
    buf = np.frombuffer(data, np.uint8)

    vis_y = _last_int(_mh_record(data, 44))
    vis_x = _last_int(_mh_record(data, 45))
    hrv_y = _last_int(_mh_record(data, 46))
    hrv_x = _last_int(_mh_record(data, 47))
    longitude = _first_num(_mh_record(data, 14))
    if vis_x <= 0 or vis_y <= 0:
        return None

    headerpos = _last_int(_mh_record(data, 8))
    datapos = _last_int(_mh_record(data, 9))
    trailerpos = _last_int(_mh_record(data, 10))
    bandsel = _value(_mh_record(data, 39))[:12].ljust(12, "-")

    sat_name = "Unknown MSG"
    m = re.search(r"MSG(\d)", _mh_record(data, 13))
    if m:
        sat_name = f"MSG-{m.group(1)}"
    prod_ts = time.time()
    m = re.search(r"(\d{4})(\d{2})(\d{2})(\d{2})(\d{2})(\d{2})",
                  _mh_record(data, 17))
    if m:
        prod_ts = calendar.timegm(tuple(map(int, m.groups())) + (0, 0, -1))

    # 15HEADER: per-channel calibration (seviri_nat.cpp:140-153)
    hdr = 38 + headerpos + 1 + 60134 + 700 + 326058 + 101 + 72
    slope = np.zeros(12)
    offset = np.zeros(12)
    if hdr + 192 <= len(data):
        coefs = struct.unpack(">24d", data[hdr:hdr + 192])
        slope, offset = np.array(coefs[0::2]), np.array(coefs[1::2])

    # 15TRAILER: HRV actual-window registration (seviri_nat.cpp:157-178)
    tro = 38 + trailerpos + 1 + 2 + 14 + 12 + 192 + 6 * 12 + 16
    lower_east_col = upper_south_line = upper_east_col = 0
    if tro + 32 <= len(data):
        (l_s, l_n, lower_east_col, l_w, upper_south_line, u_n,
         upper_east_col, u_w) = struct.unpack(">8i", data[tro:tro + 32])

    imgs = {ch: np.zeros((hrv_y if ch == 11 else vis_y,
                          hrv_x if ch == 11 else vis_x), np.uint16)
            for ch in range(12) if bandsel[ch] == "X"}

    # Line records: 38-byte packet header + 27-byte line header + 10-bit
    # packed payload; pkt_len (BE u32 at +18) counts payload+15+27.
    ptr = datapos
    for line in range(vis_y):
        for ch in range(12):
            if bandsel[ch] != "X":
                continue
            for rep in range(3 if ch == 11 else 1):
                if ptr + 42 > len(data):
                    break
                pkt_len = struct.unpack(">I", data[ptr + 18:ptr + 22])[0]
                datasize = pkt_len - 15 - 27
                payload = buf[ptr + 65:ptr + 65 + datasize]
                px = repack_10bit(payload).astype(np.uint16) << 6
                if ch < 11:
                    n = min(vis_x, px.size)
                    imgs[ch][line, :n] = px[:n]
                else:
                    y = line * 3 + rep
                    col0 = (upper_east_col if line * 3 + 4 > upper_south_line
                            else lower_east_col)
                    n = min(hrv_x, px.size)
                    lo = max(0, -col0)
                    hi = min(n, hrv_x - col0)
                    if y < hrv_y and hi > lo:
                        imgs[ch][y, col0 + lo:col0 + hi] = px[lo:hi]
                ptr += 65 + datasize

    p = ImageProduct()
    p.instrument_name = "seviri"
    p.set_product_timestamp(prod_ts)
    p.set_product_source(sat_name)
    p.set_proj_cfg({
        "type": "geos", "lon0": longitude, "sweep_x": False,
        "altitude": 35785831.0,
        "scalar_x": 3000.403165817, "scalar_y": -3000.403165817,
        "offset_x": -5568748.275756353,
        "offset_y": 5572548.275756 if vis_y == 1392 else 5568748.275756353,
        "width": 3712, "height": vis_y,
    })
    for ch in sorted(imgs):
        img = imgs[ch][::-1, ::-1]  # full mirror (seviri_nat.cpp:270)
        if ch == 11 and vis_y == 1392:
            # RSS special case: re-place HRV columns by LowerEastColumnActual
            # after the mirror (seviri_nat.cpp:269-282: new_col = i - LEC)
            shifted = np.zeros_like(img)
            lec = lower_east_col
            if lec >= 0:
                if lec < img.shape[1]:
                    shifted[:, : img.shape[1] - lec] = img[:, lec:]
            else:
                if -lec < img.shape[1]:
                    shifted[:, -lec:] = img[:, : img.shape[1] + lec]
            img = shifted
        tr = ChannelTransform.none()
        if ch == 11:
            tr = ChannelTransform.affine(vis_x / hrv_x, vis_y / hrv_y, 0, 0)
        # storage is <<6-shifted 10-bit counts -> declared depth 16 (repo
        # convention: declared depth == storage scaling; the calibrator
        # divides by 64 to recover 10-bit counts)
        p.add_channel(img, str(ch + 1), abs_index=ch, bit_depth=16,
                      wavenumber=freq_to_wavenumber(
                          299792458.0 / SEVIRI_WAVELENGTHS[ch]),
                      calibration_type=("reflective_radiance"
                                        if ch < 3 or ch == 11
                                        else "emissive_radiance"),
                      ch_transform=tr)
    p.set_calibration("msg_nat_seviri", {"vars": {
        "slope": slope.tolist(), "offset": offset.tolist()}})
    return p


class MsgNatSeviriCalibrator(ImageCalibrator):
    """radiance = offset[ch] + counts * slope[ch]; 0 counts invalid
    (ref nat/msg/msg_nat_calibrator.h:20-37). Counts are the stored
    16-bit values; the slope applies to 10-bit counts, so >>6 first."""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        s = self.cfg["vars"]["slope"][channel_idx]
        b = self.cfg["vars"]["offset"][channel_idx]
        c = np.asarray(counts, np.float64)
        out = b + (c / 64.0) * s
        return np.where(c == 0, np.nan, out)


calibrator_registry.register("msg_nat_seviri", MsgNatSeviriCalibrator)
