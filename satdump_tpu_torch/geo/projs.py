"""Standard map projections, forward/inverse, vectorized.

Reference: src-core/projection/standard/{equirect,geos,stereo,tmerc,webmerc,
tpers}.c (per-pixel C functions dispatched through proj.cpp). All functions
here broadcast over arrays: forward (lon, lat) degrees -> (x, y) projection
meters; inverse back. cfg schema mirrors the reference's proj JSON
({"type": ..., "lon0": ..., ...}).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

R_EARTH = 6378137.0          # spherical radius used by the reference's
                             # equirect/webmerc (WGS84 a)
GEO_ALT = 35786023.0         # geostationary height above ellipsoid


# --- equirectangular ---------------------------------------------------------
def equirect_forward(lon, lat, lon0=0.0, lat_ts=0.0):
    x = R_EARTH * np.radians(np.asarray(lon) - lon0) * np.cos(np.radians(lat_ts))
    y = R_EARTH * np.radians(np.asarray(lat))
    return x, y


def equirect_inverse(x, y, lon0=0.0, lat_ts=0.0):
    lon = np.degrees(np.asarray(x) / (R_EARTH * np.cos(np.radians(lat_ts)))) + lon0
    lat = np.degrees(np.asarray(y) / R_EARTH)
    return lon, lat


# --- web mercator ------------------------------------------------------------
def webmerc_forward(lon, lat, lon0=0.0):
    x = R_EARTH * np.radians(np.asarray(lon) - lon0)
    latr = np.radians(np.clip(np.asarray(lat), -85.06, 85.06))
    y = R_EARTH * np.log(np.tan(np.pi / 4 + latr / 2))
    return x, y


def webmerc_inverse(x, y, lon0=0.0):
    lon = np.degrees(np.asarray(x) / R_EARTH) + lon0
    lat = np.degrees(2 * np.arctan(np.exp(np.asarray(y) / R_EARTH)) - np.pi / 2)
    return lon, lat


# --- polar stereographic -----------------------------------------------------
def stereo_forward(lon, lat, lon0=0.0, lat0=90.0):
    sign = 1.0 if lat0 >= 0 else -1.0
    latr = np.radians(np.asarray(lat) * sign)
    lonr = np.radians(np.asarray(lon) - lon0)
    k = 2.0 * R_EARTH * np.tan(np.pi / 4 - latr / 2)
    x = k * np.sin(lonr)
    y = -sign * k * np.cos(lonr)
    return x, y


def stereo_inverse(x, y, lon0=0.0, lat0=90.0):
    sign = 1.0 if lat0 >= 0 else -1.0
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64) * -sign
    rho = np.hypot(x, y)
    lat = sign * np.degrees(np.pi / 2 - 2 * np.arctan(rho / (2 * R_EARTH)))
    lon = np.degrees(np.arctan2(x, y)) + lon0
    return lon, lat


# --- geostationary (GEOS) ----------------------------------------------------
def geos_forward(lon, lat, lon0=0.0, sweep_x=False):
    """Lon/lat -> GEOS scan-angle coordinates (m at the satellite plane),
    spherical earth (the reference's geos.c fallback)."""
    h = GEO_ALT + R_EARTH
    lonr = np.radians(np.asarray(lon) - lon0)
    latr = np.radians(np.asarray(lat))
    # geocentric on sphere
    cx = R_EARTH * np.cos(latr) * np.cos(lonr)
    cy = R_EARTH * np.cos(latr) * np.sin(lonr)
    cz = R_EARTH * np.sin(latr)
    dx = h - cx
    visible = (cx * (cx - h) + cy * cy + cz * cz) < 0
    if sweep_x:
        x = h * np.arctan2(cy, np.hypot(dx, cz))
        y = h * np.arctan2(cz, dx)
    else:
        x = h * np.arctan2(cy, dx)
        y = h * np.arctan2(cz, np.hypot(dx, cy))
    x = np.where(visible, x, np.nan)
    y = np.where(visible, y, np.nan)
    return x, y


def geos_inverse(x, y, lon0=0.0, sweep_x=False):
    h = GEO_ALT + R_EARTH
    a = np.asarray(x, np.float64) / h
    b = np.asarray(y, np.float64) / h
    # exact inverses of the forward's nested atan2 pairs:
    # sweep_y (default): a = atan2(vy, vx), b = atan2(vz, hypot(vx, vy))
    #   -> v = (cos b cos a, cos b sin a, sin b)
    # sweep_x:           a = atan2(vy, hypot(vx, vz)), b = atan2(vz, vx)
    #   -> v = (cos a cos b, sin a, cos a sin b)
    if sweep_x:
        vx = np.cos(a) * np.cos(b)
        vy = np.sin(a)
        vz = np.cos(a) * np.sin(b)
    else:
        vx = np.cos(b) * np.cos(a)
        vy = np.cos(b) * np.sin(a)
        vz = np.sin(b)
    # ray from (h,0,0) towards (-vx, vy, vz); intersect sphere radius R
    ox = h
    qa = vx * vx + vy * vy + vz * vz
    qb = 2 * (-vx) * ox
    qc = ox * ox - R_EARTH * R_EARTH
    disc = qb * qb - 4 * qa * qc
    t = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
    px = ox - vx * t
    py = vy * t
    pz = vz * t
    lat = np.degrees(np.arcsin(np.clip(pz / R_EARTH, -1, 1)))
    lon = np.degrees(np.arctan2(py, px)) + lon0
    lon = np.where(disc >= 0, lon, np.nan)
    lat = np.where(disc >= 0, lat, np.nan)
    return lon, lat


def tmerc_forward(lon, lat, lon0=0.0, lat0=0.0):
    """Transverse Mercator (spherical form, ref projection/standard/tmerc.c
    behavior). Returns meters."""
    lam = np.radians(np.asarray(lon, np.float64) - lon0)
    phi = np.radians(np.asarray(lat, np.float64))
    B = np.clip(np.cos(phi) * np.sin(lam), -1 + 1e-12, 1 - 1e-12)
    x = 0.5 * R_EARTH * np.log((1 + B) / (1 - B))
    y = R_EARTH * (np.arctan2(np.tan(phi), np.cos(lam))
                   - np.radians(lat0))
    return x, y


def tmerc_inverse(x, y, lon0=0.0, lat0=0.0):
    x = np.asarray(x, np.float64) / R_EARTH
    D = np.asarray(y, np.float64) / R_EARTH + np.radians(lat0)
    lat = np.degrees(np.arcsin(np.clip(np.sin(D) / np.cosh(x), -1, 1)))
    lon = lon0 + np.degrees(np.arctan2(np.sinh(x), np.cos(D)))
    return lon, lat


def tpers_forward(lon, lat, lon0=0.0, lat0=0.0, altitude=35785831.0,
                  tilt=0.0, azi=0.0):
    """Tilted/near-sided perspective (General Perspective, ref
    projection/standard/tpers.c semantics; GEOS is its nadir geostationary
    special case). Returns meters in the view plane; NaN where the point is
    on the far side."""
    phi = np.radians(np.asarray(lat, np.float64))
    lam = np.radians(np.asarray(lon, np.float64) - lon0)
    phi0 = np.radians(lat0)
    P = 1.0 + altitude / R_EARTH
    cosc = (np.sin(phi0) * np.sin(phi)
            + np.cos(phi0) * np.cos(phi) * np.cos(lam))
    k = (P - 1.0) / (P - cosc)
    x = R_EARTH * k * np.cos(phi) * np.sin(lam)
    y = R_EARTH * k * (np.cos(phi0) * np.sin(phi)
                       - np.sin(phi0) * np.cos(phi) * np.cos(lam))
    vis = cosc >= 1.0 / P
    if tilt or azi:
        w, g = np.radians(tilt), np.radians(azi)
        yt = y * np.cos(g) + x * np.sin(g)
        xt = x * np.cos(g) - y * np.sin(g)
        H = R_EARTH * (P - 1.0)
        A = (yt * np.sin(w) + H) / H
        x, y = xt * np.cos(w) / A, yt / A
    return np.where(vis, x, np.nan), np.where(vis, y, np.nan)


def tpers_inverse(x, y, lon0=0.0, lat0=0.0, altitude=35785831.0,
                  tilt=0.0, azi=0.0):
    """General Perspective inverse (Snyder 1987 eq. 25-11..25-15)."""
    x = np.asarray(x, np.float64).copy()
    y = np.asarray(y, np.float64).copy()
    if tilt or azi:
        w, g = np.radians(tilt), np.radians(azi)
        H = altitude
        yt = y * H / (H - y * np.sin(w))
        xt = x * (yt * np.sin(w) + H) / (H * np.cos(w))
        x = xt * np.cos(g) + yt * np.sin(g)
        y = yt * np.cos(g) - xt * np.sin(g)
    phi0 = np.radians(lat0)
    P = 1.0 + altitude / R_EARTH
    xr = x / R_EARTH
    yr = y / R_EARTH
    rho = np.hypot(xr, yr)
    disc = 1.0 - rho * rho * (P + 1.0) / (P - 1.0)
    valid = disc >= 0
    denom = (P - 1.0) / np.maximum(rho, 1e-30) + rho / (P - 1.0)
    sinc = (P - np.sqrt(np.maximum(disc, 0.0))) / denom
    c = np.arcsin(np.clip(sinc, -1.0, 1.0))
    with np.errstate(invalid="ignore", divide="ignore"):
        lat = np.degrees(np.arcsin(np.clip(
            np.cos(c) * np.sin(phi0)
            + yr * sinc * np.cos(phi0) / np.maximum(rho, 1e-30), -1, 1)))
        lon = lon0 + np.degrees(np.arctan2(
            xr * sinc,
            rho * np.cos(phi0) * np.cos(c) - yr * np.sin(phi0) * sinc))
    lat = np.where(rho < 1e-12, lat0, lat)
    lon = np.where(rho < 1e-12, lon0, lon)
    return (np.where(valid, lon, np.nan), np.where(valid, lat, np.nan))


_FORWARD = {"equirectangular": equirect_forward, "equirect": equirect_forward,
            "webmerc": webmerc_forward, "mercator": webmerc_forward,
            "stereo": stereo_forward, "geos": geos_forward,
            "tmerc": tmerc_forward, "tpers": tpers_forward}
_INVERSE = {"equirectangular": equirect_inverse, "equirect": equirect_inverse,
            "webmerc": webmerc_inverse, "mercator": webmerc_inverse,
            "stereo": stereo_inverse, "geos": geos_inverse,
            "tmerc": tmerc_inverse, "tpers": tpers_inverse}


def _kwargs(cfg: dict, fn=None) -> dict:
    out = {}
    for k in ("lon0", "lat0", "lat_ts", "sweep_x", "altitude", "tilt", "azi"):
        if k in cfg:
            out[k] = cfg[k]
    if fn is not None:  # drop params the projection doesn't take
        import inspect
        allowed = set(inspect.signature(fn).parameters)
        out = {k: v for k, v in out.items() if k in allowed}
    return out


def forward(cfg: dict, lon, lat) -> Tuple[np.ndarray, np.ndarray]:
    t = cfg.get("type", "equirectangular")
    if t not in _FORWARD:
        raise ValueError(f"unknown projection '{t}'")
    return _FORWARD[t](lon, lat, **_kwargs(cfg, _FORWARD[t]))


def inverse(cfg: dict, x, y) -> Tuple[np.ndarray, np.ndarray]:
    t = cfg.get("type", "equirectangular")
    if t not in _INVERSE:
        raise ValueError(f"unknown projection '{t}'")
    return _INVERSE[t](x, y, **_kwargs(cfg, _INVERSE[t]))
