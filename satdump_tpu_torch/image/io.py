"""Image IO: unified load/save (ref: src-core/image/io.h:22-172).

PNG goes through the package's own codec (image/png.py: zlib and struct,
8/16-bit grayscale, gray+alpha, RGB and RGBA); QOI and PGM/PPM are native
as well. JPEG/TIFF/J2K come with the image slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from satdump_tpu_torch.core.exceptions import FormatError


def save_img(img: np.ndarray, path: str | Path) -> None:
    """img: (H,W) or (H,W,C) uint8/uint16. Format from the extension:
    PNG, QOI and PBM/PGM/PPM (io.h:22-172 surface)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise FormatError(f"save_img: dtype {img.dtype} unsupported (use uint8/uint16)")
    ext = Path(path).suffix.lower()
    if ext == ".qoi":
        from satdump_tpu_torch.image.qoi import save_qoi
        return save_qoi(img.astype(np.uint8) if img.dtype == np.uint8
                        else (img >> 8).astype(np.uint8), path)
    if ext in (".pbm", ".pgm", ".ppm"):
        return _save_pnm(img, path)
    if ext == ".png":
        from satdump_tpu_torch.image.png import save_png
        return save_png(img, path)
    raise FormatError(f"save_img: format '{ext}' not carried (png, qoi, pnm)")


def load_img(path: str | Path) -> np.ndarray:
    ext = Path(path).suffix.lower()
    if ext == ".qoi":
        from satdump_tpu_torch.image.qoi import load_qoi
        return load_qoi(path)
    if ext in (".pbm", ".pgm", ".ppm"):
        return _load_pnm(path)
    if ext == ".png":
        from satdump_tpu_torch.image.png import load_png
        return load_png(path)
    raise FormatError(f"load_img: format '{ext}' not carried (png, qoi, pnm)")


def _save_pnm(img: np.ndarray, path: str | Path) -> None:
    """Binary PGM (P5, grayscale) / PPM (P6, RGB), 8/16-bit."""
    img = np.asarray(img)
    maxval = 255 if img.dtype == np.uint8 else 65535
    if img.ndim == 2:
        hdr = f"P5\n{img.shape[1]} {img.shape[0]}\n{maxval}\n"
    elif img.ndim == 3 and img.shape[2] == 3:
        hdr = f"P6\n{img.shape[1]} {img.shape[0]}\n{maxval}\n"
    else:
        raise FormatError("PNM: grayscale or RGB only")
    body = img.astype(">u2" if maxval == 65535 else np.uint8).tobytes()
    Path(path).write_bytes(hdr.encode() + body)


def _load_pnm(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    parts = data.split(maxsplit=4)
    magic, w, h, maxval = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    body = parts[4]
    dt = ">u2" if maxval > 255 else np.uint8
    arr = np.frombuffer(body, dt)
    if magic == b"P5":
        out = arr[: w * h].reshape(h, w)
    elif magic == b"P6":
        out = arr[: w * h * 3].reshape(h, w, 3)
    else:
        raise FormatError(f"PNM magic {magic}")
    return out.astype(np.uint16) if maxval > 255 else out
