"""WGS84 geodetic transforms + look angles (ref src-core/common/geodetic/
{geodetic_coordinates,euler_raytrace,vincentys_calculations}.cpp, vectorized).

All functions are NumPy-vectorized over leading axes so whole passes of
scanline geometry evaluate in one call. A copy of
satdump_tpu/geo/geodetic.py.
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378.137               # km, semi-major
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
EARTH_ROT = 7.292115855e-5       # rad/s sidereal


def lla_to_ecef(lat_deg, lon_deg, alt_km=0.0) -> np.ndarray:
    """Geodetic lat/lon/alt -> ECEF (km). Returns (..., 3)."""
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.radians(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt_km, np.float64)
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(xyz: np.ndarray) -> np.ndarray:
    """ECEF (km) -> geodetic (lat_deg, lon_deg, alt_km), Bowring iteration.
    Returns (..., 3)."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(5):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + alt)))
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    alt = p / np.cos(lat) - n
    return np.stack([np.degrees(lat), np.degrees(lon), alt], axis=-1)


def gmst(jd_ut1) -> np.ndarray:
    """Greenwich Mean Sidereal Time (radians) from Julian date (UT1)."""
    jd = np.asarray(jd_ut1, np.float64)
    t = (jd - 2451545.0) / 36525.0
    g = (67310.54841 + (876600.0 * 3600.0 + 8640184.812866) * t
         + 0.093104 * t * t - 6.2e-6 * t ** 3)
    return np.mod(np.radians(g / 240.0), 2.0 * np.pi)


def unix_to_jd(t_unix) -> np.ndarray:
    return np.asarray(t_unix, np.float64) / 86400.0 + 2440587.5


def eci_to_ecef(r_eci: np.ndarray, t_unix) -> np.ndarray:
    """TEME/ECI -> ECEF by GMST rotation. r_eci (..., 3) km."""
    th = gmst(unix_to_jd(t_unix))
    c, s = np.cos(th), np.sin(th)
    x = c * r_eci[..., 0] + s * r_eci[..., 1]
    y = -s * r_eci[..., 0] + c * r_eci[..., 1]
    return np.stack([x, y, r_eci[..., 2]], axis=-1)


def look_angles(obs_lat, obs_lon, obs_alt_km, sat_ecef: np.ndarray
                ) -> np.ndarray:
    """Observer -> satellite (az_deg, el_deg, range_km). sat_ecef (..., 3)."""
    obs = lla_to_ecef(obs_lat, obs_lon, obs_alt_km)
    d = np.asarray(sat_ecef, np.float64) - obs
    lat = np.radians(obs_lat)
    lon = np.radians(obs_lon)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    # ECEF -> ENU
    e = -so * d[..., 0] + co * d[..., 1]
    n = (-sl * co * d[..., 0] - sl * so * d[..., 1] + cl * d[..., 2])
    u = (cl * co * d[..., 0] + cl * so * d[..., 1] + sl * d[..., 2])
    rng = np.sqrt(e * e + n * n + u * u)
    az = np.degrees(np.arctan2(e, n)) % 360.0
    el = np.degrees(np.arcsin(np.clip(u / np.maximum(rng, 1e-9), -1, 1)))
    return np.stack([az, el, rng], axis=-1)


def vincenty_distance(lat1, lon1, lat2, lon2, iterations: int = 50):
    """Geodesic distance (km) on the WGS84 ellipsoid (Vincenty inverse)."""
    la1, la2 = np.radians(lat1), np.radians(lat2)
    dl = np.radians(np.asarray(lon2) - np.asarray(lon1))
    u1 = np.arctan((1 - WGS84_F) * np.tan(la1))
    u2 = np.arctan((1 - WGS84_F) * np.tan(la2))
    su1, cu1 = np.sin(u1), np.cos(u1)
    su2, cu2 = np.sin(u2), np.cos(u2)
    lam = dl
    for _ in range(iterations):
        sl, cl = np.sin(lam), np.cos(lam)
        ss = np.sqrt((cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2)
        cs = su1 * su2 + cu1 * cu2 * cl
        sig = np.arctan2(ss, cs)
        sa = np.where(ss != 0, cu1 * cu2 * sl / np.where(ss == 0, 1, ss), 0.0)
        c2a = 1.0 - sa * sa
        c2m = np.where(c2a != 0, cs - 2 * su1 * su2 / np.where(c2a == 0, 1, c2a), 0.0)
        C = WGS84_F / 16 * c2a * (4 + WGS84_F * (4 - 3 * c2a))
        lam_new = dl + (1 - C) * WGS84_F * sa * (
            sig + C * ss * (c2m + C * cs * (-1 + 2 * c2m ** 2)))
        if np.all(np.abs(lam_new - lam) < 1e-12):
            lam = lam_new
            break
        lam = lam_new
    u2_ = c2a * (WGS84_A ** 2 - WGS84_B ** 2) / WGS84_B ** 2
    A = 1 + u2_ / 16384 * (4096 + u2_ * (-768 + u2_ * (320 - 175 * u2_)))
    B = u2_ / 1024 * (256 + u2_ * (-128 + u2_ * (74 - 47 * u2_)))
    dsig = B * ss * (c2m + B / 4 * (cs * (-1 + 2 * c2m ** 2)
                                    - B / 6 * c2m * (-3 + 4 * ss ** 2)
                                    * (-3 + 4 * c2m ** 2)))
    return WGS84_B * A * (sig - dsig)
