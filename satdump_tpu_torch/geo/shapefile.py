"""Minimal ESRI shapefile + GeoJSON geometry readers.

Reference behavior: src-core/common/map/shapefile.{h,cpp} (record-walking
.shp parser for Point/PolyLine/Polygon) and map_drawer.cpp's GeoJSON
feature walk. Output is a flat list of polylines (each an (N, 2) lon/lat
array) ready for the overlay rasterizer; points come back as (N, 2)."""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, Tuple

import numpy as np

SHAPE_NULL = 0
SHAPE_POINT = 1
SHAPE_POLYLINE = 3
SHAPE_POLYGON = 5


def read_shapefile(path: str | Path) -> Tuple[int, List[np.ndarray]]:
    """Parse a .shp file. Returns (shape_type, geometries):
    Point -> one (N, 2) array of lon/lat;
    PolyLine/Polygon -> list of (Ni, 2) part arrays."""
    data = Path(path).read_bytes()
    (file_len,) = struct.unpack(">i", data[24:28])
    shape_type = struct.unpack("<i", data[32:36])[0]
    pos = 100
    points: List[Tuple[float, float]] = []
    parts_out: List[np.ndarray] = []
    end = min(len(data), file_len * 2)
    while pos + 12 <= end:
        (_recno, content_len) = struct.unpack(">ii", data[pos: pos + 8])
        rec = data[pos + 8: pos + 8 + content_len * 2]
        pos += 8 + content_len * 2
        if len(rec) < 4:
            break
        (stype,) = struct.unpack("<i", rec[:4])
        if stype == SHAPE_NULL:
            continue
        if stype == SHAPE_POINT:
            x, y = struct.unpack("<dd", rec[4:20])
            points.append((x, y))
        elif stype in (SHAPE_POLYLINE, SHAPE_POLYGON):
            num_parts, num_points = struct.unpack("<ii", rec[36:44])
            parts = struct.unpack(f"<{num_parts}i", rec[44: 44 + 4 * num_parts])
            coords = np.frombuffer(
                rec, "<f8", count=num_points * 2,
                offset=44 + 4 * num_parts).reshape(num_points, 2)
            bounds = list(parts) + [num_points]
            for a, b in zip(bounds[:-1], bounds[1:]):
                if b - a >= 2:
                    parts_out.append(coords[a:b].copy())
    if shape_type == SHAPE_POINT:
        return shape_type, [np.asarray(points, np.float64)]
    return shape_type, parts_out


def read_geojson(path: str | Path) -> List[np.ndarray]:
    """GeoJSON features -> list of (N, 2) lon/lat polylines
    (map_drawer.cpp drawProjectedMapGeoJson geometry walk)."""
    body = json.loads(Path(path).read_text())
    out: List[np.ndarray] = []

    def add_ring(coords):
        a = np.asarray(coords, np.float64)
        if a.ndim == 2 and len(a) >= 2:
            out.append(a[:, :2])

    for feat in body.get("features", []):
        if feat.get("type") != "Feature":
            continue
        geom = feat.get("geometry", {})
        t = geom.get("type")
        c = geom.get("coordinates", [])
        if t == "LineString":
            add_ring(c)
        elif t in ("Polygon", "MultiLineString"):
            for ring in c:
                add_ring(ring)
        elif t == "MultiPolygon":
            for poly in c:
                for ring in poly:
                    add_ring(ring)
    return out
