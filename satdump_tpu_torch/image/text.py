"""Text overlays on raster images.

Reference: src-core/image/text.h (stb-truetype glyph rendering for map
labels and composite annotations). The port draws with a 6 x 11 bitmap
font of its own (image/font6x11.py: Pillow's bitmap default font, kept as
data), since the card's machine has no Pillow and no FreeType; a TrueType
`font_path` raises. Characters outside printable ASCII draw as '?'.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.image import font6x11 as font

_GLYPHS = np.unpackbits(
    np.frombuffer(font.GLYPHS, np.uint8).reshape(-1, font.HEIGHT, 1),
    axis=2)[:, :, 8 - font.WIDTH:].astype(bool)     # (95, 11, 6)


def text_mask(text: str) -> np.ndarray:
    """(11, 6 * len(text)) bool mask of `text` in the bitmap font."""
    idx = [ord(c) - font.FIRST if font.FIRST <= ord(c) < font.FIRST
           + len(_GLYPHS) else ord("?") - font.FIRST for c in text]
    if not idx:
        return np.zeros((font.HEIGHT, 0), bool)
    return np.concatenate(_GLYPHS[idx], axis=1)


def draw_text(img: np.ndarray, text: str, xy: Tuple[int, int],
              color: Sequence[int], font_path: Optional[str] = None,
              size: int = 12) -> np.ndarray:
    """Draw `text` with its top-left corner at pixel (x, y); returns a copy
    of `img` (uint8 or uint16, H/W or H/W/C) with the text in `color` (8-bit
    values, shifted up by 8 bits for a uint16 image). Pixels outside the
    image are clipped. `size` is kept for the reference's signature: the
    bitmap font has one size."""
    if font_path:
        raise SatdumpError(
            f"font_path '{font_path}': TrueType fonts are not supported "
            "(the port draws its bitmap font only)")
    out = np.array(img, copy=True)
    mask = text_mask(text)
    x, y = int(xy[0]), int(xy[1])
    h, w = out.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + mask.shape[1], w), min(y + mask.shape[0], h)
    if x1 <= x0 or y1 <= y0:
        return out
    m = mask[y0 - y: y1 - y, x0 - x: x1 - x]
    shift = 8 if out.dtype == np.uint16 else 0
    c = np.asarray([int(v) << shift for v in color], out.dtype)
    region = out[y0:y1, x0:x1]
    region[m] = c if out.ndim == 3 else c[0]
    return out


def draw_city_labels(img: np.ndarray, latlon_to_xy, points: np.ndarray,
                     names: Sequence[str], color: Sequence[int],
                     max_labels: int = 50) -> np.ndarray:
    """Label projected points (the populated-places overlay the reference
    draws from its shapefile, common/map/map_drawer.cpp)."""
    x, y = latlon_to_xy(points[:, 0], points[:, 1])
    h, w = img.shape[0], img.shape[1]
    out = img
    n = 0
    for xi, yi, name in zip(np.asarray(x), np.asarray(y), names):
        if not (np.isfinite(xi) and np.isfinite(yi)):
            continue
        if 0 <= xi < w and 0 <= yi < h:
            out = draw_text(out, name, (int(xi), int(yi)), color)
            n += 1
            if n >= max_labels:
                break
    return out
