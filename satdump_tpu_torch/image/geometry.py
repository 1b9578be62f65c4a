"""Geometric image corrections: earth curvature and bowtie.

Reference behavior: src-core/image/earth_curvature.cpp (per-row LUT resample
derived from the satellite viewing geometry) and image/bowtie.cpp (per-column
scan compression toward the swath edges). Both are re-expressed as single
vectorized index-map applications over the whole image (one take per channel
instead of the reference's per-pixel loops), on the host in NumPy, as in
satdump_tpu/image/geometry.py."""

from __future__ import annotations

from typing import Tuple

import numpy as np

EARTH_RADIUS_KM = 6371.0


def earth_curvature_table(width: int, satellite_height: float, swath: float,
                          resolution_km: float) -> np.ndarray:
    """Fractional source column for every output column
    (earth_curvature.cpp:21-36)."""
    orbit_r = EARTH_RADIUS_KM + satellite_height
    corrected_width = int(round(swath / resolution_km))
    view_angle = swath / EARTH_RADIUS_KM
    edge_angle = -np.arctan(
        EARTH_RADIUS_KM * np.sin(view_angle / 2)
        / (np.cos(view_angle / 2) * EARTH_RADIUS_KM - orbit_r))
    i = np.arange(corrected_width, dtype=np.float64)
    angle = (i / corrected_width - 0.5) * view_angle
    sat_angle = -np.arctan(
        EARTH_RADIUS_KM * np.sin(angle)
        / (np.cos(angle) * EARTH_RADIUS_KM - orbit_r))
    return width * ((sat_angle / edge_angle + 1.0) / 2.0)


def correct_earth_curvature(img: np.ndarray, satellite_height: float,
                            swath: float, resolution_km: float
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """img (..., H, W) -> (corrected (..., H, W'), reverse_table (W',)).

    Linear interpolation between the two source columns (the reference's
    per-pixel lerp, earth_curvature.cpp:52-66) in float64, vectorized over
    all rows and channels at once, then cast back to img's dtype."""
    img = np.asarray(img)
    w = img.shape[-1]
    cf = earth_curvature_table(w, satellite_height, swath, resolution_km)
    i0 = np.clip(cf.astype(np.int64), 0, w - 1)
    i1 = np.clip(i0 + 1, 0, w - 1)
    frac = (cf - i0).astype(np.float64)
    a = img[..., i0].astype(np.float64)
    b = img[..., i1].astype(np.float64)
    out = a * (1.0 - frac) + b * frac
    return out.astype(img.dtype), i0


def bowtie_index_map(width: int, scan_height: int, alpha: float, beta: float
                     ) -> np.ndarray:
    """(width, scan_height) source line index per (column, output line)
    (bowtie.cpp:60-72)."""
    half = width // 2
    col = np.arange(width)
    center_counts = (((half - np.abs(col - half)) / float(half)) * alpha
                     + beta) * scan_height
    center_counts = np.minimum(center_counts.astype(np.int64), scan_height)
    padding = (scan_height - center_counts) // 2
    i = np.arange(scan_height)
    pxpos = padding[:, None] + (
        (i[None, :] / float(scan_height)) * center_counts[:, None]
    ).astype(np.int64)
    return np.clip(pxpos, 0, scan_height - 1)


def correct_generic_bowtie(img: np.ndarray, scan_height: int, alpha: float,
                           beta: float) -> np.ndarray:
    """img (..., H, W) with H a multiple of scan_height -> corrected image
    (the MODIS/VIIRS-style per-scan bowtie resample, bowtie.cpp)."""
    img = np.asarray(img)
    h, w = img.shape[-2], img.shape[-1]
    n_scans = h // scan_height
    pxpos = bowtie_index_map(w, scan_height, alpha, beta)   # (W, scanH)
    lead = img.shape[:-2]
    x = img[..., : n_scans * scan_height, :].reshape(
        lead + (n_scans, scan_height, w))
    # out[..., s, i, c] = x[..., s, pxpos[c, i], c]
    idx = pxpos.T[None, :, :]                               # (1, scanH, W)
    out = np.take_along_axis(
        x, np.broadcast_to(idx, x.shape[:-2] + (scan_height, w)), axis=-2)
    return out.reshape(lead + (n_scans * scan_height, w))
