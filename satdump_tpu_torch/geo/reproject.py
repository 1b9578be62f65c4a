"""Reprojector: equirect-georeferenced images -> any standard projection.

Reference: src-core/projection/reprojector.{h,cpp} + per-pair OpenCL
kernels (resources/opencl/reproj_image_*.cl). Here, on the host: the
target grid inverse-projects to lon/lat in one vectorized pass, maps into
source pixel coordinates, and bilinear-samples — whole image at once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from satdump_tpu_torch.geo import projs


def bilinear_sample(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                    fill=0) -> np.ndarray:
    """Sample img (H, W[, C]) at float coords; outside -> fill."""
    H, W = img.shape[:2]
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1) \
        & np.isfinite(sx) & np.isfinite(sy)
    sx = np.where(inside, sx, 0.0)
    sy = np.where(inside, sy, 0.0)
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    p00 = img[y0, x0].astype(np.float64)
    p01 = img[y0, x0 + 1].astype(np.float64)
    p10 = img[y0 + 1, x0].astype(np.float64)
    p11 = img[y0 + 1, x0 + 1].astype(np.float64)
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    if img.ndim == 3:
        out[~inside] = fill
    else:
        out = np.where(inside, out, fill)
    return out.astype(img.dtype)


def reproject_equirect(img: np.ndarray, georef: dict, target_cfg: dict,
                       out_width: int = 1024, out_height: int = 0
                       ) -> Tuple[np.ndarray, dict]:
    """Reproject an equirect-georeferenced image (as produced by
    geo.warp.warp_to_equirect) onto `target_cfg`. Returns (image, georef)."""
    lon0, lon1 = georef["lon_min"], georef["lon_max"]
    lat0, lat1 = georef["lat_min"], georef["lat_max"]

    # target extent: project the bounding box corners
    cor_lon = np.array([lon0, lon1, lon0, lon1])
    cor_lat = np.array([lat0, lat0, lat1, lat1])
    cx, cy = projs.forward(target_cfg, cor_lon, cor_lat)
    ok = np.isfinite(cx) & np.isfinite(cy)
    if not ok.any():
        raise ValueError("extent not visible in target projection")
    x0, x1 = np.nanmin(cx), np.nanmax(cx)
    y0, y1 = np.nanmin(cy), np.nanmax(cy)
    if not out_height:
        out_height = max(int(round(out_width * (y1 - y0) / max(x1 - x0, 1e-9))), 8)

    gx = np.linspace(x0, x1, out_width)
    gy = np.linspace(y1, y0, out_height)
    mx, my = np.meshgrid(gx, gy)
    lon, lat = projs.inverse(target_cfg, mx, my)

    H, W = img.shape[:2]
    sx = (lon - lon0) / max(lon1 - lon0, 1e-12) * (W - 1)
    sy = (lat1 - lat) / max(lat1 - lat0, 1e-12) * (H - 1)
    out = bilinear_sample(img, sx, sy)
    tgt_georef = dict(target_cfg)
    tgt_georef.update({"x_min": float(x0), "x_max": float(x1),
                       "y_min": float(y0), "y_max": float(y1),
                       "width": out_width, "height": out_height})
    return out, tgt_georef


def src_pixel_coords(src_cfg: dict, lon, lat):
    """Lon/lat -> fractional pixel coordinates of a proj-cfg-georeferenced
    image (offset/scalar convention shared by the GEO product emitters,
    ref projection/reprojector.cpp proj_offset_*/proj_scalar_*)."""
    x, y = projs.forward(src_cfg, lon, lat)
    sx = (x - src_cfg.get("offset_x", 0.0)) / src_cfg.get("scalar_x", 1.0)
    sy = (y - src_cfg.get("offset_y", 0.0)) / src_cfg.get("scalar_y", 1.0)
    return sx, sy


def reproject(img: np.ndarray, src, target_cfg: dict,
              out_width: int = 1024, out_height: int = 0
              ) -> Tuple[np.ndarray, dict]:
    """Any-pair reprojection (ref src-core/projection/reprojector.cpp:
    source may be ANY standard projection, not just equirect). `src` is
    either an equirect georef ({lon_min..lat_max}, legacy path) or a
    product proj cfg ({type, lon0, scalar_x, offset_x, ...}). The target
    grid inverse-projects to lon/lat, forward-projects into source pixels,
    and bilinear-samples — one vectorized pass, no per-pixel dispatch."""
    if "lon_min" in src:
        return reproject_equirect(img, src, target_cfg, out_width, out_height)

    H, W = img.shape[:2]
    # target extent from the source footprint: sample the source grid,
    # push through src-inverse -> target-forward, take the finite bounds
    mu, mv = np.meshgrid(np.linspace(0, W - 1, 64), np.linspace(0, H - 1, 64))
    px = mu * src.get("scalar_x", 1.0) + src.get("offset_x", 0.0)
    py = mv * src.get("scalar_y", 1.0) + src.get("offset_y", 0.0)
    lon, lat = projs.inverse(src, px, py)
    cx, cy = projs.forward(target_cfg, lon, lat)
    ok = np.isfinite(cx) & np.isfinite(cy)
    if not ok.any():
        raise ValueError("source footprint not visible in target projection")
    x0, x1 = float(np.min(cx[ok])), float(np.max(cx[ok]))
    y0, y1 = float(np.min(cy[ok])), float(np.max(cy[ok]))
    if not out_height:
        out_height = max(int(round(out_width * (y1 - y0)
                                   / max(x1 - x0, 1e-9))), 8)

    gx = np.linspace(x0, x1, out_width)
    gy = np.linspace(y1, y0, out_height)
    mx, my = np.meshgrid(gx, gy)
    tlon, tlat = projs.inverse(target_cfg, mx, my)
    sx, sy = src_pixel_coords(src, tlon, tlat)
    out = bilinear_sample(img, sx, sy)
    tgt_georef = dict(target_cfg)
    tgt_georef.update({"x_min": x0, "x_max": x1, "y_min": y0, "y_max": y1,
                       "width": out_width, "height": out_height})
    return out, tgt_georef
