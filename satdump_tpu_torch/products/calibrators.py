"""Per-instrument radiometric calibrators (beyond AVHRR/3, VERDICT r3 #4).

Vectorized counterparts of the reference's per-pixel calibrator plugins —
each `compute(channel_idx, counts)` evaluates a whole (lines, width) channel
at once. Config ("vars") shapes match the reference JSON exactly so saved
products are interchangeable:

* noaa_mhs / noaa_amsu — per-line per-channel quadratic radiance
  (plugins/noaa_metop_support/instruments/mhs/mhs_calibrator.h).
* noaa_hirs — per-channel (ch 20) linear albedo + per-line linear radiance
  (noaa/instruments/hirs/hirs_calibrator.h; note the [channel][line] index
  order, transposed vs MHS).
* metop_ascat — the 16-bit float backscatter decode
  (metop/instruments/ascat/ascat_calibrator.h).
* metop_iasi_img — per-scan two-point radiance against the 2.73 K space
  view and the blackbody temperature (iasi_img_calibrator.h).
* meteor_msumr — MSU-MR visible two-point reflective radiance + IR
  two-point radiance from per-line cold/hot views and telemetry
  temperatures with most-common fallback smoothing
  (meteor_support/instruments/msumr/msumr_calibrator.h).
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np

from satdump_tpu_torch.products.calibration import (CALIBRATION_INVALID_VALUE,
                                              ImageCalibrator,
                                              calibrator_registry,
                                              freq_to_wavenumber,
                                              temperature_to_radiance,
                                              wavenumber_to_freq)

_INVALID = CALIBRATION_INVALID_VALUE


class NoaaMHSCalibrator(ImageCalibrator):
    """vars.perLine_perChannel[line][channel] = {a0, a1, a2};
    radiance = a0 + a1*c + a2*c^2, invalid when a0 == -999.99 or c == 0."""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        plpc = self.cfg.get("vars", {}).get("perLine_perChannel", [])
        c = np.asarray(counts, np.float64)
        out = np.full(c.shape, _INVALID)
        nl = min(len(plpc), c.shape[0])
        if nl == 0:
            return out
        a = np.array([[plpc[ln][channel_idx].get(k, -999.99)
                       for k in ("a0", "a1", "a2")]
                      for ln in range(nl)])                # (nl, 3)
        vals = a[:, 0:1] + a[:, 1:2] * c[:nl] + a[:, 2:3] * c[:nl] ** 2
        bad = (c[:nl] == 0) | (a[:, 0:1] == -999.99)
        out[:nl] = np.where(bad, _INVALID, vals)
        return out


class NoaaHIRSCalibrator(ImageCalibrator):
    """vars.perLine_perChannel[channel][line] = {a0, a1} (radiance) and
    vars.perChannel = {a0, a1} for channel 19 (visible albedo, capped 1)."""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        v = self.cfg.get("vars", {})
        c = np.asarray(counts, np.float64)
        out = np.full(c.shape, _INVALID)
        if channel_idx == 19:
            pc = v.get("perChannel", {})
            alb = pc.get("a0", 0.0) + pc.get("a1", 0.0) * c
            return np.where((c == 0) | (alb > 1), _INVALID, alb)
        plpc = v.get("perLine_perChannel", [])
        if channel_idx >= len(plpc):
            return out
        rows = plpc[channel_idx]
        nl = min(len(rows), c.shape[0])
        if nl == 0:
            return out
        a = np.array([[rows[ln].get(k, -999.99) for k in ("a0", "a1")]
                      for ln in range(nl)])
        vals = a[:, 0:1] + a[:, 1:2] * c[:nl]
        bad = (c[:nl] == 0) | (a[:, 0:1] == -999.99)
        out[:nl] = np.where(bad, _INVALID, vals)
        return out


class MetOpASCATCalibrator(ImageCalibrator):
    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        from satdump_tpu_torch.models.metop import _ieee_halfish_to_float
        return _ieee_halfish_to_float(np.asarray(counts, np.uint16))


class MetOpIASIImagingCalibrator(ImageCalibrator):
    """vars[scan] = {bbt, cold_counts, warm_counts}; two-point radiance
    between the 2.73 K space view and the blackbody."""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        v = self.cfg.get("vars", [])
        wavenum = 0.0
        imgs = getattr(self.product, "images", None)
        if imgs:
            wavenum = imgs[0].wavenumber or 0.0
        c = np.asarray(counts, np.float64)
        out = np.full(c.shape, _INVALID)
        if not wavenum:
            return out
        for scan in range(min(len(v), c.shape[0] // 64)):
            e = v[scan]
            bbt = e.get("bbt", 0.0)
            cold = e.get("cold_counts", 0.0)
            warm = e.get("warm_counts", 0.0)
            if not bbt or not cold or not warm:
                continue
            space_rad = temperature_to_radiance(2.73, wavenum)
            warm_rad = temperature_to_radiance(bbt, wavenum)
            gain = (warm - cold) / max(warm_rad - space_rad, 1e-12)
            seg = c[scan * 64: (scan + 1) * 64]
            vals = warm_rad + (seg - warm) / gain
            out[scan * 64: (scan + 1) * 64] = np.where(seg == 0, _INVALID,
                                                       vals)
        return out


class MeteorMsuMrCalibrator(ImageCalibrator):
    """MSU-MR: vars = {vis: [[c0,c1]x3, [min,max]], lrpt: bool,
    views: [ch][2][lines], temps: [line]{analog_tlm:{cold_temp1/2,
    hot_temp1/2}}} (msumr_calibrator.h)."""

    def __init__(self, product, cfg):
        super().__init__(product, cfg)
        v = cfg.get("vars", {})
        self.lrpt = bool(v.get("lrpt", False))
        self.vis = v.get("vis")
        self.views = v.get("views")
        self.temps = v.get("temps")
        self.cold_temps: List[float] = []
        self.hot_temps: List[float] = []
        if self.views is not None and self.temps is not None:
            max_lcnt = max((len(ch[0]) for ch in self.views if ch), default=0)
            for i in range(max_lcnt):
                coldt = hott = 0.0
                for j in list(range(i, max_lcnt)) + list(range(i, -1, -1)):
                    t = self.temps[j] if j < len(self.temps) else None
                    if t:
                        a = t.get("analog_tlm", {})
                        coldt = (a.get("cold_temp1", 0)
                                 + a.get("cold_temp2", 0)) / 2.0
                        hott = (a.get("hot_temp1", 0)
                                + a.get("hot_temp2", 0)) / 2.0
                        if coldt and hott:
                            break
                self.cold_temps.append(coldt)
                self.hot_temps.append(hott)
            if self.cold_temps:
                coldm = Counter(self.cold_temps).most_common(1)[0][0]
                hotm = Counter(self.hot_temps).most_common(1)[0][0]
                self.cold_temps = [coldm if abs(coldm - t) > 5 else t
                                   for t in self.cold_temps]
                self.hot_temps = [hotm if abs(hotm - t) > 5 else t
                                  for t in self.hot_temps]

    def _wavenumber(self, ch: int) -> float:
        for h in getattr(self.product, "images", []):
            if h.abs_index == ch:
                return h.wavenumber or 0.0
        return 0.0

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        c = np.asarray(counts, np.float64)
        out = np.full(c.shape, _INVALID)
        wavenum = self._wavenumber(channel_idx)
        if wavenum == 0:
            return out
        if channel_idx < 3:
            if not self.vis:
                return out
            c0, c1 = self.vis[channel_idx]
            vmin, vmax = self.vis[3]
            rad = (c - vmin) / float(vmax - 1 - vmin) * (c1 - c0)
            rad = np.maximum(rad, 0.0)
            rad *= (299792458.0 / wavenumber_to_freq(wavenum)) * 1e6
            return np.where(c == 0, _INVALID, rad)
        if self.views is None or channel_idx >= len(self.views):
            return out
        cold_v = np.asarray(self.views[channel_idx][0], np.float64)
        hot_v = np.asarray(self.views[channel_idx][1], np.float64)
        nl = c.shape[0]
        line_idx = np.arange(nl) // (8 if self.lrpt else 1)
        line_idx = np.clip(line_idx, 0, len(cold_v) - 1)
        cv = cold_v[line_idx][:, None]
        hv = hot_v[line_idx][:, None]
        ct = np.asarray(self.cold_temps, np.float64)[
            np.clip(line_idx, 0, len(self.cold_temps) - 1)][:, None]
        ht = np.asarray(self.hot_temps, np.float64)[
            np.clip(line_idx, 0, len(self.hot_temps) - 1)][:, None]
        cold_rad = temperature_to_radiance(ct, wavenum)
        hot_rad = temperature_to_radiance(ht, wavenum)
        denom = hv - cv
        denom = np.where(denom == 0, 1.0, denom)
        gain = (hot_rad - cold_rad) / denom
        rad = cold_rad + (c - cv) * gain
        bad = (cv == 0) | (hv == 0) | (c == 0) | ((ct == 0) & (ht == 0))
        return np.where(bad, _INVALID, rad)


# ATMS channel center frequencies, GHz (ATMS SDR coefficient table,
# ref atms_calibrator.cpp atmsSdrCoeffsPtr.centralFrequency)
ATMS_FREQ_GHZ = [23.8, 31.4, 50.3, 51.76, 52.8, 53.596, 54.4, 54.94,
                 55.5, 57.2903, 57.2903, 57.2903, 57.2903, 57.2903,
                 57.2903, 88.2, 165.5, 183.31, 183.31, 183.31, 183.31,
                 183.31]


class JpssAtmsCalibrator(ImageCalibrator):
    """ATMS counts -> radiance by per-scan two-point calibration against
    the cold-space and warm-load views the scan itself carries (ref
    atms_calibrator.cpp; the reference additionally folds PRT telemetry
    into the warm-load temperature — here the warm temperature comes from
    cfg vars ("warm_temp" per scan or scalar, default 285 K), a documented
    simplification worth ~1 K absolute).

    vars = {"cold_counts": [scan][ch], "warm_counts": [scan][ch],
            "warm_temp": scalar | [scan]}"""

    T_COLD = 2.7279  # cosmic background, atms_calibrator SPACE_TEMP

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        v = self.cfg.get("vars", {})
        cc = np.asarray(v.get("cold_counts", []), np.float64)
        wc = np.asarray(v.get("warm_counts", []), np.float64)
        c = np.asarray(counts, np.float64)
        out = np.full(c.shape, _INVALID)
        if cc.ndim != 2 or wc.ndim != 2 or not len(cc):
            return out
        wavenum = freq_to_wavenumber(ATMS_FREQ_GHZ[channel_idx] * 1e9)
        wt = v.get("warm_temp", 285.0)
        wt = np.asarray(wt, np.float64)
        if wt.ndim == 0:
            wt = np.full(len(cc), float(wt))
        nl = min(c.shape[0], len(cc))
        li = np.clip(np.arange(c.shape[0]), 0, len(cc) - 1)
        cold = cc[li, channel_idx][:, None]
        warm = wc[li, channel_idx][:, None]
        cold_rad = temperature_to_radiance(self.T_COLD, wavenum)
        warm_rad = temperature_to_radiance(wt[li], wavenum)[:, None]
        denom = warm - cold
        denom = np.where(denom == 0, 1.0, denom)
        gain = (warm_rad - cold_rad) / denom
        rad = cold_rad + (c - cold) * gain
        bad = (cold == 0) | (warm == 0) | (c == 0)
        del nl
        return np.where(bad, _INVALID, rad)


calibrator_registry.register("noaa_mhs", NoaaMHSCalibrator)
calibrator_registry.register("noaa_amsu", NoaaMHSCalibrator)
calibrator_registry.register("noaa_hirs", NoaaHIRSCalibrator)
calibrator_registry.register("metop_ascat", MetOpASCATCalibrator)
calibrator_registry.register("metop_iasi_img", MetOpIASIImagingCalibrator)
calibrator_registry.register("meteor_msumr", MeteorMsuMrCalibrator)
class GenericXritCalibrator(ImageCalibrator):
    """Per-channel count->value lookup curve, spline-interpolated between
    published calibration points (ref xrit/generic_xrit_calibrator.h —
    the workhorse for GK-2A/Himawari/GOES xRIT products whose operators
    distribute calibration tables rather than coefficients).

    cfg vars: {"<channel_name>": [[count, value], ...],
               "bits_for_calib": {"<channel_name>": bits},   # LUT domain
               "to_complete": true}  # sparse points -> interpolate"""

    def compute(self, channel_idx: int, counts: np.ndarray) -> np.ndarray:
        h = None
        for im in getattr(self.product, "images", []):
            if im.abs_index == channel_idx:
                h = im
                break
        if h is None:
            return np.full(np.shape(counts), _INVALID)
        cfg = self.cfg.get("vars", self.cfg)
        pts = cfg.get(h.channel_name)
        if not pts:
            return np.full(np.shape(counts), _INVALID)
        pts = sorted((int(k), float(v)) for k, v in pts
                     if v != 0 or int(k) == 0)
        xs = np.asarray([p[0] for p in pts], np.float64)
        ys = np.asarray([p[1] for p in pts], np.float64)
        c = np.asarray(counts, np.float64)
        bits = cfg.get("bits_for_calib", {}).get(h.channel_name)
        if bits:
            c = c * ((2 ** int(bits) - 1) / ((1 << h.bit_depth) - 1))
        if len(xs) >= 3:
            from satdump_tpu_torch.geo.raytrace import _natural_cubic
            vals = _natural_cubic(xs, ys)(c)
        else:
            vals = np.interp(c, xs, ys)
        return np.where(np.asarray(counts) == 0, _INVALID, vals)


calibrator_registry.register("jpss_atms", JpssAtmsCalibrator)
calibrator_registry.register("generic_xrit", GenericXritCalibrator)
