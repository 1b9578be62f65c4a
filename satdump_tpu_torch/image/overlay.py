"""Map / grid overlays on raster images.

Reference behavior: src-core/common/map/map_drawer.cpp (project polyline
vertices, draw segments shorter than max_length) and the GUI's lat/lon grid.
The rasterizer is vectorized: every segment of every polyline is densified
into sample points in one batch (no per-pixel Bresenham loop)."""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def draw_segments(img: np.ndarray, xy0: np.ndarray, xy1: np.ndarray,
                  color: Sequence[float], thickness: int = 1) -> None:
    """Draw line segments in place. img (H, W) or (H, W, C);
    xy0/xy1 (N, 2) pixel endpoints (x, y). Batched densification."""
    if len(xy0) == 0:
        return
    h, w = img.shape[0], img.shape[1]
    d = xy1 - xy0
    steps = np.maximum(np.abs(d).max(axis=1).astype(np.int64), 1)
    total = int(steps.sum() + len(steps))
    xs = np.empty(total, np.float64)
    ys = np.empty(total, np.float64)
    o = 0
    # per-segment linspace lengths differ; assemble with a repeat+cumsum trick
    reps = steps + 1
    seg_id = np.repeat(np.arange(len(steps)), reps)
    local = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
    t = local / np.maximum(reps[seg_id] - 1, 1)
    xs = xy0[seg_id, 0] + d[seg_id, 0] * t
    ys = xy0[seg_id, 1] + d[seg_id, 1] * t
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    for dy in range(-(thickness // 2), thickness // 2 + 1):
        for dx in range(-(thickness // 2), thickness // 2 + 1):
            xx = xi + dx
            yy = yi + dy
            m = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            img[yy[m], xx[m]] = color if img.ndim == 3 else color[0]


def draw_polylines(img: np.ndarray,
                   latlon_to_xy: Callable[[np.ndarray, np.ndarray], tuple],
                   polylines: List[np.ndarray], color: Sequence[float],
                   max_length: float = 2000.0, thickness: int = 1) -> None:
    """Project each polyline's lon/lat vertices with `latlon_to_xy(lon, lat)
    -> (x, y)` and draw the in-range segments (map_drawer.cpp semantics:
    skip segments longer than max_length pixels or with invalid ends)."""
    starts, ends = [], []
    for line in polylines:
        x, y = latlon_to_xy(line[:, 0], line[:, 1])
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        ok = np.isfinite(x) & np.isfinite(y)
        p0x, p0y, p1x, p1y = x[:-1], y[:-1], x[1:], y[1:]
        seg_ok = ok[:-1] & ok[1:]
        seg_len = np.hypot(p1x - p0x, p1y - p0y)
        seg_ok &= seg_len < max_length
        if seg_ok.any():
            starts.append(np.stack([p0x[seg_ok], p0y[seg_ok]], axis=1))
            ends.append(np.stack([p1x[seg_ok], p1y[seg_ok]], axis=1))
    if starts:
        draw_segments(img, np.concatenate(starts), np.concatenate(ends),
                      color, thickness)


def draw_map_overlay(img: np.ndarray,
                     latlon_to_xy: Callable[[np.ndarray, np.ndarray], tuple],
                     map_path: str, color: Sequence[float],
                     thickness: int = 1) -> None:
    """Overlay a shapefile (.shp) or GeoJSON map onto img in place."""
    from satdump_tpu_torch.geo.shapefile import read_geojson, read_shapefile
    if str(map_path).lower().endswith((".json", ".geojson")):
        lines = read_geojson(map_path)
    else:
        _, lines = read_shapefile(map_path)
    draw_polylines(img, latlon_to_xy, lines, color, thickness=thickness)


def draw_latlon_grid(img: np.ndarray,
                     latlon_to_xy: Callable[[np.ndarray, np.ndarray], tuple],
                     color: Sequence[float], spacing_deg: float = 10.0,
                     thickness: int = 1) -> None:
    """Graticule overlay (the GUI map grid's headless equivalent)."""
    lines = []
    for lon in np.arange(-180.0, 180.1, spacing_deg):
        lat = np.linspace(-89.9, 89.9, 181)
        lines.append(np.stack([np.full_like(lat, lon), lat], axis=1))
    for lat in np.arange(-80.0, 80.1, spacing_deg):
        lon = np.linspace(-180.0, 180.0, 361)
        lines.append(np.stack([lon, np.full_like(lon, lat)], axis=1))
    draw_polylines(img, latlon_to_xy, lines, color, thickness=thickness)
