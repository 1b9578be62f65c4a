"""HDF5 / netCDF-4 firstparty ingest (h5py-gated).

netCDF-4 files ARE HDF5, so one reader covers both trees:

* GOES-R ABI L1b Radiances (.nc): `Rad` counts + projection/calibration
  attributes -> 16-bit ImageProduct with geos proj and the goes_nc_abi
  spectral calibrator (ref plugins/firstparty_support/processors/nc/goes/
  abi_nc.cpp:10-60).
* FY-4 AGRI L1 (HDF): NOMChannelNN count planes + CALChannelNN lookup
  tables -> per-channel LUT calibration (ref processors/hdf/fy4/
  agri_hdf.cpp).
* Generic fallback: every 2-D numeric dataset becomes a channel, scaled
  into 16 bits — honest partial coverage for the remaining per-mission
  HDF processors (DMSP SSMIS, FY-2 S-VISSR, FY-3 MERSI, GPM GMI).
"""

from __future__ import annotations

import calendar
import re
from typing import List, Optional

import numpy as np

from satdump_tpu_torch.products.calibration import (ImageCalibrator,
                                                    calibrator_registry)
from satdump_tpu_torch.products.image_product import ImageProduct

try:
    import h5py
    HAVE_H5PY = True
except Exception:  # pragma: no cover - h5py is present in the image
    h5py = None
    HAVE_H5PY = False

HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

# ABI band center wavelengths, nm (ref abi_nc.cpp:150-166
# goes_abi_wavelength_table) -> channel wavenumber = 1e7/wavelength
ABI_WAVELENGTH_NM = (470, 640, 860, 1380, 1610, 2260, 3900, 6190,
                     6950, 7340, 8500, 9610, 10350, 11200, 12300, 13300)


def _attr(obj, name, default=None):
    v = obj.attrs.get(name, default)
    if isinstance(v, bytes):
        return v.decode("latin-1")
    if isinstance(v, np.ndarray) and v.size == 1:
        return v.reshape(()).item()
    return v


def parse_abi_nc(f) -> Optional[ImageProduct]:
    if "Rad" not in f or "band_id" not in f:
        return None
    rad = f["Rad"]
    band = int(np.asarray(f["band_id"]).reshape(-1)[0])
    bit_depth = int(_attr(rad, "sensor_band_bit_depth", 14))
    fill = (1 << bit_depth) - 1
    img = np.asarray(rad[()], np.int64)
    img = np.where(img >= fill, 0, img) << (16 - bit_depth)
    img = img.astype(np.uint16)

    scale = float(_attr(rad, "scale_factor", 1.0)) / 2 ** (16 - bit_depth)
    offset = float(_attr(rad, "add_offset", 0.0))
    kappa = (float(np.asarray(f["kappa0"]).reshape(-1)[0])
             if "kappa0" in f else -999.0)
    if not np.isfinite(kappa):
        kappa = -999.0

    p = ImageProduct()
    p.instrument_name = "abi"
    p.set_product_source(str(_attr(f, "platform_ID", "GOES-R")))
    t = str(_attr(f, "time_coverage_start", ""))
    m = re.match(r"(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})", t)
    if m:
        p.set_product_timestamp(
            calendar.timegm(tuple(map(int, m.groups())) + (0, 0, -1)))

    if "goes_imager_projection" in f and "x" in f:
        gp = f["goes_imager_projection"]
        hgt = float(_attr(gp, "perspective_point_height", 35786023.0))
        lon0 = float(_attr(gp, "longitude_of_projection_origin", 0.0))
        xs = float(_attr(f["x"], "scale_factor", 1.0)) * hgt
        ys = float(_attr(f["y"], "scale_factor", 1.0)) * hgt
        xo = float(_attr(f["x"], "add_offset", 0.0)) * hgt
        yo = float(_attr(f["y"], "add_offset", 0.0)) * hgt
        p.set_proj_cfg({"type": "geos", "lon0": lon0, "sweep_x": True,
                        "altitude": hgt, "scalar_x": xs, "scalar_y": ys,
                        "offset_x": xo, "offset_y": yo,
                        "width": img.shape[1], "height": img.shape[0]})

    # storage is <<(16-depth)-shifted, so the DECLARED depth is 16 (repo
    # convention: declared depth == storage scaling; the calibration scale
    # above is pre-divided to match)
    p.add_channel(img, str(band), abs_index=band - 1, bit_depth=16,
                  wavenumber=1e7 / ABI_WAVELENGTH_NM[band - 1],
                  calibration_type=("albedo" if kappa > 0
                                    else "emissive_radiance"))
    # ABI L1b Rad is already band radiance -> spectral=false
    # (ref abi_nc.cpp:176 is_spectral=false; AHI HSD is the spectral one)
    cal = {"scale": [0.0] * 16, "offset": [0.0] * 16,
           "kappa": [-999.0] * 16, "spectral": False}
    cal["scale"][band - 1] = scale
    cal["offset"][band - 1] = offset
    cal["kappa"][band - 1] = kappa
    p.set_calibration("goes_nc_abi", {"vars": cal})
    return p


def parse_fy4_agri(f) -> Optional[ImageProduct]:
    root = f["Data"] if "Data" in f and isinstance(
        f["Data"], h5py.Group) else f
    chans = sorted(k for k in root if re.fullmatch(r"NOMChannel\d+", k))
    if not chans:
        return None
    p = ImageProduct()
    p.instrument_name = "agri"
    p.set_product_source(str(_attr(f, "Satellite Name",
                                   _attr(f, "platform_ID", "FY-4"))))
    luts = {}
    cal_root = (f["Calibration"] if "Calibration" in f
                and isinstance(f["Calibration"], h5py.Group) else root)
    for name in chans:
        ch = int(re.search(r"\d+", name).group()) - 1
        img = np.asarray(root[name][()])
        fill = img.max() if img.dtype.kind == "u" else 65535
        img16 = np.where(img >= 65534, 0, img).astype(np.uint16)
        p.add_channel(img16, str(ch + 1), abs_index=ch, bit_depth=12)
        lname = name.replace("NOM", "CAL")
        if lname in cal_root:
            luts[str(ch)] = np.asarray(
                cal_root[lname][()], np.float64).tolist()
        del fill
    p.set_calibration("fy4_agri_lut", {"vars": {"lut": luts}})
    return p


def parse_hdf_generic(f, instrument="hdf") -> Optional[ImageProduct]:
    planes: List = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset) and obj.ndim == 2 \
                and obj.dtype.kind in "uif" and min(obj.shape) >= 8:
            planes.append((name, obj))

    f.visititems(visit)
    if not planes:
        return None
    p = ImageProduct()
    p.instrument_name = instrument
    for i, (name, ds) in enumerate(planes[:64]):
        a = np.asarray(ds[()], np.float64)
        a = np.nan_to_num(a)
        lo, hi = np.nanmin(a), np.nanmax(a)
        scaled = ((a - lo) / (hi - lo or 1.0) * 65535).astype(np.uint16)
        p.add_channel(scaled, name.replace("/", "_"), abs_index=i)
    return p


def merge_abi_products(prods: List[ImageProduct]) -> List[ImageProduct]:
    """Fold single-band ABI .nc products (the normal one-file-per-band
    distribution) into ONE multi-channel product, the way the reference's
    ABINcProcessor accumulates all files before push (abi_nc.cpp:168-190).
    Non-ABI products pass through untouched; channel transforms rescale
    the 0.5/1/2 km bands onto the largest grid."""
    from satdump_tpu_torch.products.image_product import ChannelTransform
    abi = [p for p in prods if p.instrument_name == "abi"]
    if len(abi) <= 1:
        return prods
    out = [p for p in prods if p.instrument_name != "abi"]
    base = max(abi, key=lambda p: p.images[0].image.size)
    bh, bw = base.images[0].image.shape
    cal = {"scale": [0.0] * 16, "offset": [0.0] * 16,
           "kappa": [-999.0] * 16, "spectral": False}
    for p in abi:
        _, c = p.get_calibration()
        for k in ("scale", "offset", "kappa"):
            for i, v in enumerate(c["vars"][k]):
                if v not in (0.0, -999.0):
                    cal[k][i] = v
    merged = ImageProduct()
    merged.instrument_name = "abi"
    merged.set_product_source(base.get_product_source())
    if base.has_product_timestamp():
        merged.set_product_timestamp(base.get_product_timestamp())
    if base.has_proj_cfg():
        merged.set_proj_cfg(base.get_proj_cfg())
    for p in sorted(abi, key=lambda p: p.images[0].abs_index):
        h = p.images[0]
        hh, hw = h.image.shape
        merged.add_channel(
            h.image, h.channel_name, abs_index=h.abs_index,
            bit_depth=h.bit_depth,
            wavenumber=h.wavenumber, calibration_type=h.calibration_type,
            ch_transform=ChannelTransform.affine(bw / hw, bh / hh, 0, 0))
    merged.set_calibration("goes_nc_abi", {"vars": cal})
    out.append(merged)
    return out


class Fy4AgriLutCalibrator(ImageCalibrator):
    """counts -> physical value via the per-channel CAL lookup table
    (ref hdf/fy4/agri_hdf.cpp LUT application)."""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        lut = np.asarray(
            self.cfg["vars"]["lut"].get(str(channel_idx), [0.0]))
        idx = np.clip(np.asarray(counts, np.int64), 0, lut.size - 1)
        return lut[idx]


calibrator_registry.register("fy4_agri_lut", Fy4AgriLutCalibrator)


def parse_hdf5_file(path) -> Optional[ImageProduct]:
    if not HAVE_H5PY:
        raise RuntimeError("h5py unavailable: cannot ingest HDF/netCDF")
    with h5py.File(path, "r") as f:
        for fn in (parse_abi_nc, parse_fy4_agri, parse_hdf_generic):
            p = fn(f)
            if p is not None:
                return p
    return None
