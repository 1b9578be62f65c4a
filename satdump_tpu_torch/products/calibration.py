"""Radiometric calibration framework.

Reference: src-core/common/calibration.cpp (Planck radiance<->brightness
temperature), products/image/calibration_units.h (unit ids),
products/image/image_calibrator.h (per-instrument counts->unit calibrators,
registered by plugins via RequestImageCalibratorEvent). Here calibrators
register in a plain registry keyed by id; `compute` is vectorized over the
whole channel image (batched NumPy, not per-pixel virtuals).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from satdump_tpu_torch.core.events import event_bus
from satdump_tpu_torch.core.registry import Registry

# Planck constants (SI), radiance in mW/(m^2 sr cm^-1) per the CCSDS/NOAA
# convention used by the reference (calibration.cpp)
C1 = 1.1910427e-5   # mW/(m^2 sr cm^-4)
C2 = 1.4387752      # cm K

CALIBRATION_INVALID_VALUE = -9999.9

UNITS = {
    "sun_angle": ("deg", "Sun angle"),
    "albedo": ("%", "Albedo"),
    "sun_angle_compensated_albedo": ("%", "Sun-compensated albedo"),
    "emissive_radiance": ("mW/(m^2.sr.cm^-1)", "Emissive radiance"),
    "reflective_radiance": ("mW/(m^2.sr.cm^-1)", "Reflective radiance"),
    "sun_angle_compensated_reflective_radiance":
        ("mW/(m^2.sr.cm^-1)", "Sun-compensated reflective radiance"),
    "brightness_temperature": ("K", "Brightness temperature"),
    "brightness_temperature_celsius": ("degC", "Brightness temperature"),
    "backscatter": ("dB", "Backscatter"),
}


def temperature_to_radiance(t, v):
    """Planck: brightness temperature (K) -> spectral radiance at
    wavenumber v (cm^-1). Vectorized (ref calibration.cpp)."""
    t = np.asarray(t, np.float64)
    return (C1 * v ** 3) / (np.exp(C2 * v / np.maximum(t, 1e-6)) - 1.0)


def radiance_to_temperature(L, v):
    """Inverse Planck. Vectorized; invalid (<=0) radiance -> 0 K."""
    L = np.asarray(L, np.float64)
    safe = np.maximum(L, 1e-12)
    return np.where(L > 0, C2 * v / np.log(1.0 + C1 * v ** 3 / safe), 0.0)


def spectral_radiance_to_radiance(L, wavenumber):
    """Band spectral radiance (the W/(m^2.sr.um)-style convention of the
    GOES-R/AHI L1b emissive products) -> radiance at the channel wavenumber
    via the equivalent brightness temperature. Vectorized
    (ref common/calibration.cpp:10-17, constants and form matched exactly)."""
    L = np.asarray(L, np.float64)
    c_1 = 1.191042e8
    c_2 = 1.4387752e4
    lam = (1e7 / wavenumber) / 1e3          # wavelength, um
    with np.errstate(divide="ignore", invalid="ignore"):
        t = c_2 / (lam * np.log(c_1 / (lam ** 5 * L + 1.0)))
    return temperature_to_radiance(np.nan_to_num(t), wavenumber)


def freq_to_wavenumber(freq_hz):
    return np.asarray(freq_hz, np.float64) / 29979245800.0


def wavenumber_to_freq(wavenumber):
    return np.asarray(wavenumber, np.float64) * 29979245800.0


def get_sun_angle(t_unix, lat_deg, lon_deg):
    """Solar elevation angle (deg) — low-precision (±0.3°) solar position,
    enough for albedo compensation (ref calculate/compensate sun funcs)."""
    t = np.asarray(t_unix, np.float64)
    days = t / 86400.0 - 10957.5          # days since J2000.0
    L = np.radians((280.460 + 0.9856474 * days) % 360.0)
    g = np.radians((357.528 + 0.9856003 * days) % 360.0)
    lam = L + np.radians(1.915) * np.sin(g) + np.radians(0.020) * np.sin(2 * g)
    eps = np.radians(23.439 - 0.0000004 * days)
    dec = np.arcsin(np.sin(eps) * np.sin(lam))
    ra = np.arctan2(np.cos(eps) * np.sin(lam), np.cos(lam))
    gmst_h = (18.697374558 + 24.06570982441908 * days) % 24.0
    ha = np.radians(gmst_h * 15.0 + np.asarray(lon_deg, np.float64)) - ra
    lat = np.radians(lat_deg)
    el = np.arcsin(np.sin(lat) * np.sin(dec)
                   + np.cos(lat) * np.cos(dec) * np.cos(ha))
    return np.degrees(el)


def compensate_for_sun(value, t_unix, lat_deg, lon_deg):
    """Divide by sin(solar elevation), clipped — the reference's
    sun-compensated albedo/radiance variants."""
    el = get_sun_angle(t_unix, lat_deg, lon_deg)
    s = np.sin(np.radians(np.clip(el, 3.0, 90.0)))
    return np.where(el > 0, np.asarray(value) / s, CALIBRATION_INVALID_VALUE)


class ImageCalibrator:
    """Base: counts -> physical unit over a whole channel at once
    (ref image_calibrator.h compute(abs_idx, x, y, px) — vectorized here)."""

    def __init__(self, product, cfg: dict):
        self.product = product
        self.cfg = cfg

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class LinearCalibrator(ImageCalibrator):
    """value = a * counts + b, per-channel coefficients from cfg
    {"coefs": {"<abs_idx>": {"a":..., "b":...}}}."""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        c = self.cfg.get("coefs", {}).get(str(channel_idx), {"a": 1.0, "b": 0.0})
        return np.asarray(counts, np.float64) * c["a"] + c["b"]


calibrator_registry: Registry = Registry("calibrator")
calibrator_registry.register("linear", LinearCalibrator)


class RequestImageCalibratorEvent:
    """Fired so plugins can contribute calibrators
    (ref RequestImageCalibratorEvent, noaa_metop_support/main.cpp:45-57)."""

    def __init__(self, calibrator_id: str):
        self.calibrator_id = calibrator_id
        self.calibrators: Dict[str, type] = {}


def get_calibrator(calibrator_id: str, product, cfg: dict
                   ) -> Optional[ImageCalibrator]:
    cls = calibrator_registry.get_opt(calibrator_id)
    if cls is None:
        ev = RequestImageCalibratorEvent(calibrator_id)
        event_bus.fire_event(ev)
        cls = ev.calibrators.get(calibrator_id)
    return cls(product, cfg) if cls else None


def calibrate_channel(product, channel_name, target_unit: str = "") -> np.ndarray:
    """Product channel counts -> calibrated physical values; chains the
    radiance->BT conversion when the target asks for temperature
    (ref products/image/calibration_converter.h)."""
    h = product.get_channel(channel_name)
    if not product.has_calibration():
        raise ValueError("product has no calibration config")
    calib_id, cfg = product.get_calibration()
    cal = get_calibrator(calib_id, product, cfg)
    if cal is None:
        raise ValueError(f"no calibrator '{calib_id}'")
    vals = cal.compute(h.abs_index, h.image)
    unit = h.calibration_type or cfg.get("type", "")
    if target_unit in ("brightness_temperature",
                       "brightness_temperature_celsius") \
            and unit == "emissive_radiance":
        vals = radiance_to_temperature(vals, h.wavenumber)
        if target_unit.endswith("celsius"):
            vals = vals - 273.15
    return vals
