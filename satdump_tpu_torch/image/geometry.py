"""Geometric image correction: bowtie.

Reference behavior: src-core/image/bowtie.cpp (per-column scan compression
toward the swath edges), re-expressed as one vectorized index-map
application over the whole image (one take per channel instead of the
reference's per-pixel loops). The earth-curvature correction comes with
the image slice."""

from __future__ import annotations

import numpy as np


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
