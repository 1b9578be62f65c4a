"""Scanline geolocation: satellite raytracing to the WGS84 ellipsoid.

Reference behavior: src-core/common/geodetic/euler_raytrace.cpp +
projection/raytrace/common/normal_line.cpp (push-broom imagers: AVHRR,
MSU-MR, MODIS). The reference raytraces pixel-by-pixel through virtuals;
here the whole image geolocates in one vectorized NumPy pass on the
host: build the orbital frame per line (nadir / velocity axes), rotate
the nadir ray by (roll, pitch, yaw) with Rodrigues rotations broadcast
over every pixel, and intersect with the ellipsoid analytically.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from satdump_tpu_torch.geo.geodetic import (WGS84_A, WGS84_B,
                                            ecef_to_lla, lla_to_ecef)
from satdump_tpu_torch.geo.sgp4 import SGP4
from satdump_tpu_torch.geo.tle import TLE

RESOURCES = Path(__file__).resolve().parent.parent.parent / "resources"


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _rodrigues(v: np.ndarray, axis: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Rotate v around unit axis by theta (all (..., 3) / (...))."""
    c = np.cos(theta)[..., None]
    s = np.sin(theta)[..., None]
    k = axis
    return (v * c + np.cross(k, v) * s
            + k * np.sum(k * v, axis=-1, keepdims=True) * (1.0 - c))


def ray_ellipsoid_intersect(origin: np.ndarray, direction: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """First intersection of rays with the WGS84 ellipsoid.
    origin/direction (..., 3) km. Returns (points (..., 3), hit mask)."""
    # scale z so the ellipsoid becomes a sphere of radius A
    sz = WGS84_A / WGS84_B
    o = origin.copy()
    d = direction.copy()
    o[..., 2] *= sz
    d[..., 2] *= sz
    a = np.sum(d * d, axis=-1)
    b = 2.0 * np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - WGS84_A ** 2
    disc = b * b - 4 * a * c
    hit = disc >= 0
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    hit &= t > 0
    p = origin + t[..., None] * direction
    return p, hit


class NormalLineRaytracer:
    """Push-broom scanline geolocator (ref normal_line.cpp).

    cfg keys (same schema as the reference proj cfg): timestamps,
    image_width, scan_angle, timestamp_offset, invert_scan, roll/pitch/yaw
    offsets, rotate_yaw, yaw_offset_asc/des.
    """

    def __init__(self, cfg: dict, tle: TLE):
        self.cfg = cfg
        self.timestamps = np.asarray(cfg["timestamps"], np.float64)
        self.width = int(cfg["image_width"])
        self.scan_angle = float(cfg["scan_angle"])
        self.ts_offset = float(cfg.get("timestamp_offset", 0.0))
        self.invert_scan = bool(cfg.get("invert_scan", False))
        self.rotate_yaw = bool(cfg.get("rotate_yaw", False))
        self.roll_offset = float(cfg.get("roll_offset", 0.0))
        self.pitch_offset = float(cfg.get("pitch_offset", 0.0))
        self.yaw_offset = float(cfg.get("yaw_offset", 0.0))
        self.yaw_asc = float(cfg.get("yaw_offset_asc", 0.0))
        self.yaw_des = float(cfg.get("yaw_offset_des", 0.0))

        prop = SGP4(tle)
        ts = self.timestamps + self.ts_offset
        bad = self.timestamps <= 0
        ts = np.where(bad, np.median(self.timestamps[~bad]) if (~bad).any()
                      else 0.0, ts)
        self.pos = prop.position_ecef(ts)                       # (L, 3)
        # finite-difference velocity in the rotating (ECEF) frame — the same
        # frame the reference's predict positions/velocities live in
        self.vel = (prop.position_ecef(ts + 0.5)
                    - prop.position_ecef(ts - 0.5))              # (L, 3) km/s
        nxt = prop.subpoint(ts + 1.0)
        cur = prop.subpoint(ts)
        self.ascending = cur[..., 0] < nxt[..., 0]
        self.bad_line = bad

    def get_latlon(self, x: np.ndarray, y: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Pixel (x, y) arrays -> (lat, lon) degrees; NaN where invalid."""
        x = np.asarray(x, np.float64)
        iy = np.clip(np.floor(y).astype(int), 0, len(self.timestamps) - 1)
        pos = self.pos[iy]                                      # (..., 3)
        vel = _normalize(self.vel[iy])

        # nadir: towards the geodetic sub-point (not the geocenter)
        lla = ecef_to_lla(pos)
        ground = lla_to_ecef(lla[..., 0], lla[..., 1], 0.0)
        nadir = _normalize(ground - pos)

        ang = (x - self.width / 2.0) / self.width * np.radians(self.scan_angle)
        if self.rotate_yaw:
            yaw_off = np.where(self.ascending[iy], self.yaw_asc, self.yaw_des) \
                if (self.yaw_asc or self.yaw_des) else self.yaw_offset
            roll = np.full_like(ang, np.radians(self.roll_offset))
            pitch = np.radians(self.pitch_offset)
            yaw = np.radians(yaw_off) + (1.0 if self.invert_scan else -1.0) * ang
        else:
            roll = (-1.0 if self.invert_scan else 1.0) * ang \
                + np.radians(self.roll_offset)
            pitch = np.radians(self.pitch_offset)
            yaw = np.radians(self.yaw_offset)

        # orbital frame axes
        pitch_axis = _normalize(np.cross(nadir, vel))
        ray = _rodrigues(nadir, vel, np.broadcast_to(roll, x.shape))
        ray = _rodrigues(ray, pitch_axis, np.broadcast_to(
            np.asarray(pitch, np.float64), x.shape))
        ray = _rodrigues(ray, nadir, np.broadcast_to(
            np.asarray(yaw, np.float64), x.shape))

        p, hit = ray_ellipsoid_intersect(np.broadcast_to(pos, ray.shape), ray)
        lla_out = ecef_to_lla(p)
        lat = np.where(hit & ~self.bad_line[iy], lla_out[..., 0], np.nan)
        lon = np.where(hit & ~self.bad_line[iy], lla_out[..., 1], np.nan)
        return lat, lon


class NormalPerIFOVRaytracer(NormalLineRaytracer):
    """Per-IFOV sounder/interferometer geolocator (ref normal_per_ifov.cpp,
    registered as "normal_per_ifov_old"): one timestamp per (scan, ifov)
    cell; within a cell the pointing is a small ifov_x/ifov_y raster around
    the cell's scan-angle offset. Serves IASI-IMG, AIRS and the other
    stare-per-IFOV sounders.

    cfg: timestamps (scan-major, ifov-minor), image_width, ifov_count,
    ifov_x_size, ifov_y_size, ifov_x_scan_angle, ifov_y_scan_angle,
    scan_angle (default ifov_x_scan_angle*ifov_count), invert_scan,
    roll/pitch/yaw offsets, timestamp_offset."""

    def __init__(self, cfg: dict, tle: TLE):
        self.ifov_count = int(cfg["ifov_count"])
        self.ifov_x_size = int(cfg["ifov_x_size"])
        self.ifov_y_size = int(cfg["ifov_y_size"])
        self.ifov_x_ang = float(cfg["ifov_x_scan_angle"])
        self.ifov_y_ang = float(cfg["ifov_y_scan_angle"])
        cfg = dict(cfg)
        cfg.setdefault("scan_angle", self.ifov_x_ang * self.ifov_count)
        super().__init__(cfg, tle)

    def get_latlon(self, x: np.ndarray, y: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n_scans = len(self.timestamps) // self.ifov_count
        # scan direction: the reference flips x unless invert_scan
        fx = x if self.invert_scan else (self.width - 1) - x
        scan = np.clip((y // self.ifov_y_size).astype(int), 0, n_scans - 1)
        ifov = np.clip((fx // self.ifov_x_size).astype(int),
                       0, self.ifov_count - 1)
        idx = scan * self.ifov_count + ifov           # timestamp cell
        pos = self.pos[idx]
        vel = _normalize(self.vel[idx])
        lla = ecef_to_lla(pos)
        ground = lla_to_ecef(lla[..., 0], lla[..., 1], 0.0)
        nadir = _normalize(ground - pos)

        # cell center scan offset + in-cell raster (normal_per_ifov.cpp:72-80)
        cell_off = 0.0 if self.ifov_count == 1 else \
            -((ifov - self.ifov_count / 2.0) / self.ifov_count
              * self.scan_angle)
        ifx = np.floor(fx).astype(int) % self.ifov_x_size
        ify = (self.ifov_y_size - 1) - (np.floor(y).astype(int)
                                        % self.ifov_y_size)
        roll = np.radians(
            -((ifx - self.ifov_x_size / 2.0) / self.ifov_x_size
              * self.ifov_x_ang) + cell_off + self.roll_offset)
        pitch = np.radians(
            -((ify - self.ifov_y_size / 2.0) / self.ifov_y_size
              * self.ifov_y_ang) + self.pitch_offset)
        yaw = np.radians(np.where(self.ascending[idx],
                                  -self.yaw_offset, self.yaw_offset))

        pitch_axis = _normalize(np.cross(nadir, vel))
        ray = _rodrigues(nadir, vel, np.broadcast_to(roll, x.shape))
        ray = _rodrigues(ray, pitch_axis, np.broadcast_to(pitch, x.shape))
        ray = _rodrigues(ray, nadir, np.broadcast_to(yaw, x.shape))

        p, hit = ray_ellipsoid_intersect(np.broadcast_to(pos, ray.shape), ray)
        lla_out = ecef_to_lla(p)
        bad = self.bad_line[idx] | (y >= n_scans * self.ifov_y_size)
        lat = np.where(hit & ~bad, lla_out[..., 0], np.nan)
        lon = np.where(hit & ~bad, lla_out[..., 1], np.nan)
        return lat, lon


def _natural_cubic(xs: np.ndarray, ys: np.ndarray):
    """Natural cubic spline through (xs, ys); returns an evaluator.
    (The reference fits a spline through its manual pointing table,
    manual_line.cpp:33-37; linear interp would kink at the knots.)"""
    n = len(xs)
    if n < 3:
        return lambda q: np.interp(q, xs, ys)
    h = np.diff(xs)
    rhs = np.zeros(n)
    rhs[1:-1] = 3.0 * ((ys[2:] - ys[1:-1]) / h[1:]
                       - (ys[1:-1] - ys[:-2]) / h[:-1])
    A = np.zeros((n, n))
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2.0 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
    c = np.linalg.solve(A, rhs)
    b = (ys[1:] - ys[:-1]) / h - h * (2 * c[:-1] + c[1:]) / 3.0
    d = (c[1:] - c[:-1]) / (3.0 * h)

    def ev(q):
        q = np.asarray(q, np.float64)
        i = np.clip(np.searchsorted(xs, q) - 1, 0, n - 2)
        t = q - xs[i]
        return ys[i] + b[i] * t + c[i] * t * t + d[i] * t ** 3
    return ev


class ManualLineRaytracer(NormalLineRaytracer):
    """Scanline geolocator with a MANUAL per-pixel pointing table (ref
    manual_line.cpp "manual_single_line_old"): roll/pitch as a spline
    through cfg["points"] = {"<px>": [roll, pitch, yaw]} — used where the
    scan geometry is not a uniform rotation (e.g. conical or stepped
    scanners calibrated empirically)."""

    def __init__(self, cfg: dict, tle: TLE):
        cfg = dict(cfg)
        cfg.setdefault("scan_angle", 0.0)
        super().__init__(cfg, tle)
        pts = sorted((int(k), v) for k, v in cfg["points"].items())
        xs = np.asarray([p[0] for p in pts], np.float64)
        self._roll = _natural_cubic(xs, np.asarray([p[1][0] for p in pts]))
        self._pitch = _natural_cubic(xs, np.asarray([p[1][1] for p in pts]))

    def get_latlon(self, x: np.ndarray, y: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        x = np.asarray(x, np.float64)
        iy = np.clip(np.floor(y).astype(int), 0, len(self.timestamps) - 1)
        pos = self.pos[iy]
        vel = _normalize(self.vel[iy])
        lla = ecef_to_lla(pos)
        ground = lla_to_ecef(lla[..., 0], lla[..., 1], 0.0)
        nadir = _normalize(ground - pos)

        roll = np.radians(self._roll(x))
        pitch = np.radians(self._pitch(x))
        yaw = np.radians(np.where(self.ascending[iy],
                                  -self.yaw_offset, self.yaw_offset))

        pitch_axis = _normalize(np.cross(nadir, vel))
        ray = _rodrigues(nadir, vel, np.broadcast_to(roll, x.shape))
        ray = _rodrigues(ray, pitch_axis, np.broadcast_to(pitch, x.shape))
        ray = _rodrigues(ray, nadir, np.broadcast_to(yaw, x.shape))

        p, hit = ray_ellipsoid_intersect(np.broadcast_to(pos, ray.shape), ray)
        lla_out = ecef_to_lla(p)
        bad = self.bad_line[iy] | (x >= self.width)
        lat = np.where(hit & ~bad, lla_out[..., 0], np.nan)
        lon = np.where(hit & ~bad, lla_out[..., 1], np.nan)
        return lat, lon


RAYTRACERS = {"normal_line": NormalLineRaytracer,
              "normal_single_line": NormalLineRaytracer,
              "normal_single_line_old": NormalLineRaytracer,
              "normal_per_ifov": NormalPerIFOVRaytracer,
              "normal_per_ifov_old": NormalPerIFOVRaytracer,
              "manual_line": ManualLineRaytracer,
              "manual_single_line_old": ManualLineRaytracer}


def filter_timestamps_simple(timestamps: np.ndarray, max_tolerate: float,
                             max_diff: float) -> np.ndarray:
    """Outlier rejection vs the median + monotonicity check
    (ref timestamp_filtering.cpp filter_timestamps_simple)."""
    ts = np.asarray(timestamps, np.float64).copy()
    valid = ts != -1
    if not valid.any():
        return ts
    avg = float(np.median(ts[valid]))
    last = -1.0
    for i in range(len(ts)):
        v = ts[i]
        if v == -1:
            continue
        if abs(avg - v) > max_tolerate or last >= v or abs(last - v) > max_diff:
            last = v
            ts[i] = -1
            continue
        last = v
    return ts


def filter_timestamps_cfg(timestamps, tf_cfg: dict) -> np.ndarray:
    """Apply a proj cfg "timefilter" block (ref filter_timestamps_width_cfg)."""
    ts = np.asarray(timestamps, np.float64)
    if tf_cfg.get("type") != "simple":
        return ts
    scan_time = float(tf_cfg["scan_time"])
    max_diff = float(tf_cfg["max_diff"])
    margin = float(tf_cfg.get("margin", 1.5))
    total = scan_time * len(ts)
    return filter_timestamps_simple(ts, total * 0.5 + total * margin, max_diff)


def interpolate_timestamps(timestamps, to_interp: int, scantime: float
                           ) -> np.ndarray:
    """Expand one timestamp per scan into ``to_interp`` per-line timestamps
    centered on the scan time (ref satellite_raytracer.cpp
    try_interpolate_timestamps) — e.g. MSU-MR LRPT carries one timestamp per
    8-line strip; without the x8 expansion geolocation compresses along
    track."""
    ts = np.asarray(timestamps, np.float64)
    half = to_interp // 2
    offs = np.arange(-half, to_interp - half, dtype=np.float64) * scantime
    out = ts[:, None] + offs[None, :]
    out = np.where(ts[:, None] == -1, -1.0, out)
    return out.reshape(-1)


def prepare_proj_timestamps(proj_cfg: dict) -> dict:
    """Timefilter + interpolate the cfg's timestamps in place-semantics copy
    (ref get_satellite_raytracer preamble, satellite_raytracer.cpp:38-47)."""
    if "timestamps" not in proj_cfg:
        return proj_cfg
    cfg = dict(proj_cfg)
    ts = np.asarray(cfg["timestamps"], np.float64)
    if "timefilter" in cfg:
        ts = filter_timestamps_cfg(ts, cfg["timefilter"])
    if "interpolate_timestamps" in cfg:
        ts = interpolate_timestamps(ts, int(cfg["interpolate_timestamps"]),
                                    float(cfg["interpolate_timestamps_scantime"]))
    cfg["timestamps"] = ts
    return cfg


def make_raytracer(proj_cfg: dict, tle: Optional[TLE] = None):
    t = proj_cfg.get("type", "normal_line")
    if t not in RAYTRACERS:
        raise ValueError(f"unknown raytracer type '{t}'")
    if tle is None:
        tj = proj_cfg.get("tle")
        if not tj or "line1" not in tj:
            raise ValueError("proj cfg lacks a TLE")
        tle = TLE.parse(tj.get("name", "sat"), tj["line1"], tj["line2"])
    return RAYTRACERS[t](prepare_proj_timestamps(proj_cfg), tle)


def compute_gcps(proj_cfg: dict, width: int, height: int,
                 tle: Optional[TLE] = None, nx: int = 21, ny: int = 50
                 ) -> np.ndarray:
    """Sample ground control points over the image grid
    (ref projection/raytrace/gcp_compute.cpp). Returns (N, 4):
    img_x, img_y, lon, lat — NaN-filtered."""
    rt = make_raytracer(proj_cfg, tle)
    xs = np.linspace(0, width - 1, nx)
    ys = np.linspace(0, height - 1, min(ny, height))
    gx, gy = np.meshgrid(xs, ys)
    lat, lon = rt.get_latlon(gx.ravel(), gy.ravel())
    ok = np.isfinite(lat) & np.isfinite(lon)
    return np.stack([gx.ravel()[ok], gy.ravel()[ok], lon[ok], lat[ok]], axis=-1)


def load_proj_settings(name: str, **overrides) -> dict:
    """Load a projection-settings resource
    (resources/projections_settings/<name>.json — the reference's
    satellite-raytracer cfg files, src-core resources::getResourcePath
    usage across the instrument modules). Overrides merge on top (norad,
    timestamps, tle get attached by the caller)."""
    p = RESOURCES / "projections_settings" / f"{name}.json"
    cfg = json.loads(p.read_text())
    cfg.update(overrides)
    return cfg
