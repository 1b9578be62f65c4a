"""Thin-plate-spline warp: GCPs -> geo-referenced image.

Reference: src-core/projection/thinplatespline.cpp (VizGeorefSpline2D) +
projection/warp/warp.cpp (OpenCL fp32/fp64 per-pixel kernels with CPU
fallback). The TPS solve is one small dense linear system (host LAPACK,
float64). Evaluating the spline over the output raster is a (points, GCPs)
distance matrix and two products: below 2^20 entries on the host in
float64, from there on `device`, in bands of output points so that no
band's (points, GCPs) block passes `BAND_BYTES`. The bilinear sample stays
float64 on the host.

The device evaluation runs in float64, as the host's does. In float32
the product U @ w cancels (its terms, for a pass's thousand GCPs, are two
orders of magnitude above the pixel coordinates they sum to), and so does
the |q|^2 - 2 q.s + |s|^2 form of the distances that the JAX package's
float32 device evaluation uses: pixels land whole pixels off (chip_smoke.py
phase 18 measures this on the card). The distances here are formed from
the differences, as on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from satdump_tpu_torch.utils.device import resolve_device

DEVICE_ENTRIES = 1 << 20    # points x GCPs from which `device` evaluates
BAND_BYTES = 1 << 30        # one band's (points, GCPs) block


class ThinPlateSpline:
    """2-D -> 2-D TPS interpolator fit on control points. Large
    evaluations run on `device` (default ``cuda``)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, reg: float = 0.0,
                 device: str | torch.device | None = None):
        """src (N,2) -> dst (N,2)."""
        src = np.asarray(src, np.float64)
        dst = np.asarray(dst, np.float64)
        n = src.shape[0]
        if n < 3:
            raise ValueError("TPS needs >= 3 control points")
        d2 = np.sum((src[:, None, :] - src[None, :, :]) ** 2, axis=-1)
        K = 0.5 * d2 * np.log(np.maximum(d2, 1e-20))
        if reg:
            K += np.eye(n) * reg
        P = np.concatenate([np.ones((n, 1)), src], axis=1)      # (N,3)
        A = np.zeros((n + 3, n + 3))
        A[:n, :n] = K
        A[:n, n:] = P
        A[n:, :n] = P.T
        b = np.zeros((n + 3, 2))
        b[:n] = dst
        sol, *_ = np.linalg.lstsq(A, b, rcond=None)
        self.w = sol[:n]          # (N,2)
        self.a = sol[n:]          # (3,2)
        self.src = src
        self.device = device
        self.device_ms = 0.0      # CUDA-event time of the last evaluation

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        """pts (..., 2) -> mapped (..., 2). On `device` when large."""
        pts = np.asarray(pts, np.float64)
        flat = pts.reshape(-1, 2)
        if flat.shape[0] * self.src.shape[0] < DEVICE_ENTRIES:
            out = self._eval_np(flat)
        else:
            out = self._eval_torch(flat)
        return out.reshape(pts.shape)

    def _eval_np(self, flat: np.ndarray) -> np.ndarray:
        d2 = np.sum((flat[:, None, :] - self.src[None, :, :]) ** 2, axis=-1)
        U = 0.5 * d2 * np.log(np.maximum(d2, 1e-20))
        return (U @ self.w + self.a[0]
                + flat[:, :1] * self.a[1] + flat[:, 1:2] * self.a[2])

    def _eval_torch(self, flat: np.ndarray,
                    band: Optional[int] = None) -> np.ndarray:
        """float64 evaluation on `device`, `band` points at a time
        (default: as many as fit BAND_BYTES)."""
        dev = resolve_device(self.device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float64)
                                    ).to(dev)

        q_all, src, w, a = (put(flat), put(self.src.T), put(self.w),
                            put(self.a))
        band = band or max(1, BAND_BYTES // (8 * src.shape[1]))
        out = torch.empty((flat.shape[0], 2), dtype=torch.float64,
                          device=dev)
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        for i in range(0, flat.shape[0], band):
            q = q_all[i: i + band]
            d2 = (q[:, :1] - src[:1]) ** 2 + (q[:, 1:] - src[1:]) ** 2
            U = 0.5 * d2 * torch.log(torch.clamp(d2, min=1e-20))
            out[i: i + band] = (U @ w + a[0] + q[:, :1] * a[1]
                                + q[:, 1:2] * a[2])
        if dev.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
            self.device_ms = ev[0].elapsed_time(ev[1])
        return out.cpu().numpy()


def warp_to_equirect(image: np.ndarray, gcps: np.ndarray,
                     out_width: int = 2048, margin: float = 0.05,
                     reg: float = 1e-6,
                     device: str | torch.device | None = None
                     ) -> Tuple[np.ndarray, dict]:
    """Inverse-TPS warp an image onto an equirectangular lat/lon grid
    (ref warp::performSmartWarp's simple path); the spline is evaluated on
    `device` (default ``cuda``).

    image (H, W) or (H, W, C); gcps (N, 4) = img_x, img_y, lon, lat.
    Returns (warped (Hout, Wout[, C]) same dtype, georef dict with the
    lat/lon bounding box)."""
    img = np.asarray(image)
    gx, gy, lon, lat = gcps[:, 0], gcps[:, 1], gcps[:, 2], gcps[:, 3]

    # guard the antimeridian: recenter lon if the spread demands it
    if lon.max() - lon.min() > 180.0:
        lon = np.mod(lon + 360.0, 360.0)

    lon0, lon1 = lon.min(), lon.max()
    lat0, lat1 = lat.min(), lat.max()
    dlon = (lon1 - lon0) * margin
    dlat = (lat1 - lat0) * margin
    lon0, lon1 = lon0 - dlon, lon1 + dlon
    lat0, lat1 = lat0 - dlat, lat1 + dlat

    out_height = max(int(round(out_width * (lat1 - lat0)
                               / max(lon1 - lon0, 1e-9))), 8)

    # inverse mapping: (lon, lat) -> (img_x, img_y)
    tps = ThinPlateSpline(np.stack([lon, lat], -1),
                          np.stack([gx, gy], -1), reg=reg, device=device)
    glon = np.linspace(lon0, lon1, out_width)
    glat = np.linspace(lat1, lat0, out_height)   # north-up
    mg = np.stack(np.meshgrid(glon, glat), axis=-1)   # (Hout, Wout, 2)
    src_xy = tps(mg)

    sx = src_xy[..., 0]
    sy = src_xy[..., 1]
    H, W = img.shape[:2]
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    fx = np.clip(sx - x0, 0, 1)[..., None] if img.ndim == 3 else np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)[..., None] if img.ndim == 3 else np.clip(sy - y0, 0, 1)
    p00 = img[y0, x0].astype(np.float64)
    p01 = img[y0, x0 + 1].astype(np.float64)
    p10 = img[y0 + 1, x0].astype(np.float64)
    p11 = img[y0 + 1, x0 + 1].astype(np.float64)
    interp = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
              + p10 * (1 - fx) * fy + p11 * fx * fy)
    if img.ndim == 3:
        interp[~inside] = 0
    else:
        interp = np.where(inside, interp, 0)
    warped = interp.astype(img.dtype)

    georef = {"projection": "equirectangular",
              "lon_min": float(lon0), "lon_max": float(lon1),
              "lat_min": float(lat0), "lat_max": float(lat1),
              "width": out_width, "height": out_height}
    return warped, georef


def smart_warp_to_equirect(image: np.ndarray, gcps: np.ndarray,
                           out_width: int = 8192, tile: int = 1024,
                           margin: float = 0.05, reg: float = 1e-6,
                           gcps_per_tile: int = 120,
                           device: str | torch.device | None = None
                           ) -> Tuple[np.ndarray, dict]:
    """Tiled TPS warp for huge outputs (ref projection/warp/smart_warp.cpp
    performSmartWarp): the output raster is processed in `tile`-sized
    blocks; each block solves a LOCAL spline from the GCPs nearest to the
    block (distance-ranked), bounding both the dense solve (O(N^3) in GCPs)
    and the per-block evaluation memory — the pattern that lets multi-GB
    composites warp without materializing a global evaluation. Each
    block's spline is evaluated on `device` (default ``cuda``)."""
    img = np.asarray(image)
    gx, gy, lon, lat = gcps[:, 0], gcps[:, 1], gcps[:, 2], gcps[:, 3]
    if lon.max() - lon.min() > 180.0:
        lon = np.mod(lon + 360.0, 360.0)
    lon0, lon1 = lon.min(), lon.max()
    lat0, lat1 = lat.min(), lat.max()
    dlon = (lon1 - lon0) * margin
    dlat = (lat1 - lat0) * margin
    lon0, lon1 = lon0 - dlon, lon1 + dlon
    lat0, lat1 = lat0 - dlat, lat1 + dlat
    out_height = max(int(round(out_width * (lat1 - lat0)
                               / max(lon1 - lon0, 1e-9))), 8)

    shape = (out_height, out_width) + img.shape[2:]
    warped = np.zeros(shape, img.dtype)
    glon = np.linspace(lon0, lon1, out_width)
    glat = np.linspace(lat1, lat0, out_height)
    H, W = img.shape[:2]
    pts = np.stack([lon, lat], -1)

    for ty in range(0, out_height, tile):
        for tx in range(0, out_width, tile):
            tl_lon = glon[tx: tx + tile]
            tl_lat = glat[ty: ty + tile]
            c = np.array([tl_lon.mean(), tl_lat.mean()])
            d = np.hypot(pts[:, 0] - c[0], pts[:, 1] - c[1])
            sel = np.argsort(d)[: gcps_per_tile]
            # skip tiles with no nearby geometry (beyond ~2 tile spans)
            span = max(float(np.ptp(tl_lon)), float(np.ptp(tl_lat)), 1e-9)
            if d[sel].min() > 4 * span:
                continue
            tps = ThinPlateSpline(pts[sel],
                                  np.stack([gx[sel], gy[sel]], -1), reg=reg,
                                  device=device)
            mg = np.stack(np.meshgrid(tl_lon, tl_lat), axis=-1)
            src = tps(mg)
            sx, sy = src[..., 0], src[..., 1]
            inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
            x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
            y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
            fx = np.clip(sx - x0, 0, 1)
            fy = np.clip(sy - y0, 0, 1)
            if img.ndim == 3:
                fx = fx[..., None]
                fy = fy[..., None]
            p = (img[y0, x0].astype(np.float64) * (1 - fx) * (1 - fy)
                 + img[y0, x0 + 1].astype(np.float64) * fx * (1 - fy)
                 + img[y0 + 1, x0].astype(np.float64) * (1 - fx) * fy
                 + img[y0 + 1, x0 + 1].astype(np.float64) * fx * fy)
            if img.ndim == 3:
                p[~inside] = 0
            else:
                p = np.where(inside, p, 0)
            warped[ty: ty + len(tl_lat), tx: tx + len(tl_lon)] = \
                p.astype(img.dtype)

    georef = {"projection": "equirectangular",
              "lon_min": float(lon0), "lon_max": float(lon1),
              "lat_min": float(lat0), "lat_max": float(lat1),
              "width": out_width, "height": out_height}
    return warped, georef
