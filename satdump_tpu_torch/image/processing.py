"""Image processing ops (ref src-core/image/processing.h,
brightness_contrast.cpp, histogram_utils.cpp, image_lut.cpp, median blur in
image_utils.cpp) — whole-image float32 tensor ops on `device` (default
``cuda``). Each takes and returns a host numpy image.

The arithmetic follows the JAX package's op for op: uint8/uint16 images
scale to [0,1] by division, and back by a clip, a multiply and a round half
to even; `equalize` bins on edges i/1024 (jnp.linspace) with the value 1.0
in the last bin and float32 counts; `white_balance`'s percentile forms its
index as XLA does, p * (1/100 * (n-1)), and combines the two neighbours
with one fused multiply-add, as XLA does (see `_percentile`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from satdump_tpu_torch.utils.device import div, resolve_device, to_numpy

_F32 = torch.float32
_NBINS = 1024


def _as_float(img: np.ndarray, dev: torch.device) -> tuple[torch.Tensor, float]:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        t = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        return div(t.to(_F32), 255.0), 255.0
    if img.dtype == np.uint16:          # torch's uint16 lacks CUDA kernels
        t = torch.from_numpy(img.astype(np.int32)).to(dev)
        return div(t.to(_F32), 65535.0), 65535.0
    return torch.from_numpy(np.asarray(img, np.float32).copy()).to(dev), 1.0


def _from_float(x: torch.Tensor, scale: float, dtype) -> np.ndarray:
    y = torch.round(torch.clamp(x, 0.0, 1.0) * scale)
    if dtype == np.uint8:
        return to_numpy(y.to(torch.uint8))
    if dtype == np.uint16:
        return to_numpy(y.to(torch.int32)).astype(np.uint16)
    return to_numpy(y).astype(dtype)


def brightness_contrast(img: np.ndarray, brightness: float, contrast: float,
                        device: str | torch.device | None = None
                        ) -> np.ndarray:
    """ref brightness_contrast.cpp (GIMP-style): both in [-1, 1]."""
    x, scale = _as_float(img, resolve_device(device))
    b = brightness / 2.0
    x = torch.where(torch.tensor(b < 0, device=x.device),
                    x * (1.0 + b), x + (1.0 - x) * b)
    # the slope in float32 on the host, so that every device uses one value
    slant = torch.tan(torch.tensor((contrast + 1.0) * np.pi / 4.0,
                                   dtype=_F32)).to(x.device)
    x = (x - 0.5) * slant + 0.5
    return _from_float(x, scale, img.dtype)


def histogram_edges(device: str | torch.device | None = None) -> torch.Tensor:
    """The (1025,) float32 bin edges of jnp.histogram(bins=1024,
    range=(0, 1)): jnp.linspace's start * (1 - step) + stop * step with
    step = i / 1024, then the stop."""
    dev = resolve_device(device)
    step = div(torch.arange(_NBINS, dtype=_F32, device=dev), float(_NBINS))
    edges = 0.0 * (1.0 - step) + 1.0 * step
    return torch.cat([edges, torch.ones(1, dtype=_F32, device=dev)])


def _equalize1(ch: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    flat = ch.reshape(-1).contiguous()
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], _NBINS, idx)
    # bins 1..1024 of jnp.histogram's scatter; values above 1 fall out
    hist = torch.bincount(idx, minlength=_NBINS + 2)[1: _NBINS + 1].to(_F32)
    cdf = torch.cumsum(hist, 0)
    # reference scaling: cum * (nlevels-1)/size, no cdf_min subtraction
    lut = div(torch.round(cdf * float(np.float32((_NBINS - 1) / ch.numel()))),
              float(_NBINS - 1))
    lidx = torch.clamp((ch * float(_NBINS - 1)).to(torch.int32), 0,
                       _NBINS - 1)
    return lut[lidx.long()]


def equalize(img: np.ndarray, per_channel: bool = False,
             device: str | torch.device | None = None) -> np.ndarray:
    """Histogram equalization matching the reference formula exactly
    (ref image/processing.cpp:176-216): ``scaling[i] = round(cum_hist[i] *
    (nlevels-1)/size)``, ONE joint histogram over all channels unless
    per_channel — computed with a 1024-bin histogram on the device. The
    counts are exact while each stays below 2^24."""
    dev = resolve_device(device)
    x, scale = _as_float(img, dev)
    edges = histogram_edges(dev)
    if x.ndim == 3 and per_channel:
        y = torch.stack([_equalize1(x[..., c], edges)
                         for c in range(x.shape[-1])], dim=-1)
    elif x.ndim == 3:
        # joint histogram over the full RGB stack (reference per_channel=false)
        y = _equalize1(x.reshape(-1), edges).reshape(x.shape)
    else:
        y = _equalize1(x, edges)
    return _from_float(y, scale, img.dtype)


def _percentile_weights(p: float, n: int):
    """(low index, high index, low weight, high weight) of jnp.percentile's
    linear method for `n` sorted values, in float32 as XLA forms them."""
    f = np.float32
    qn = f(p) * (f(f(1.0) / f(100.0)) * f(n - 1))
    low, high = np.floor(qn), np.ceil(qn)
    hw = f(qn - low)
    lw = f(f(1.0) - hw)
    low = int(min(max(low, 0), n - 1))
    high = int(min(max(high, 0), n - 1))
    return low, high, float(lw), float(hw)


def _percentile(x: torch.Tensor, p: float) -> torch.Tensor:
    """jnp.percentile(x, p, axis=(0, 1)) of an (H, W) or (H, W, C) float32
    tensor: a scalar or one value per channel."""
    v = x.reshape(-1) if x.ndim == 2 else x.reshape(-1, x.shape[-1]).T
    n = v.shape[-1]
    s = torch.sort(v, dim=-1).values
    low, high, lw, hw = _percentile_weights(p, n)
    v_lo, v_hi = s[..., low], s[..., high]
    # XLA fuses one of the two products into the add: the high one for a
    # single result, the low one for one result per channel
    if v_lo.numel() == 1:
        out = (v_hi.double() * hw + (v_lo * lw).double()).to(_F32)
    else:
        out = (v_lo.double() * lw + (v_hi * hw).double()).to(_F32)
    # jnp.quantile: a NaN anywhere along the axis makes the result NaN
    return torch.where(torch.isnan(v).any(dim=-1),
                       torch.full_like(out, float("nan")), out)


def white_balance(img: np.ndarray, percentile: float = 0.05,
                  device: str | torch.device | None = None) -> np.ndarray:
    """Per-channel percentile stretch (ref image processing white_balance)."""
    x, scale = _as_float(img, resolve_device(device))
    lo = _percentile(x, percentile * 100)
    hi = _percentile(x, 100 - percentile * 100)
    y = (x - lo) / torch.clamp_min(hi - lo, 1e-6)
    return _from_float(y, scale, img.dtype)


# jnp.asarray's dtype for a host LUT (64-bit types narrow), and the tensor
# type that carries it (torch lacks CUDA kernels for uint16/uint32)
_LUT_DTYPE = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32}
_LUT_CARRIER = {np.dtype(np.uint16): np.int64, np.dtype(np.uint32): np.int64}


def apply_lut(img: np.ndarray, lut: np.ndarray,
              device: str | torch.device | None = None) -> np.ndarray:
    """Map a grayscale image through a (N,) or (N,3) LUT
    (ref image_lut.cpp). The result has the LUT's type as JAX holds it
    (float64 and int64 narrow to 32 bits)."""
    dev = resolve_device(device)
    x, _ = _as_float(img, dev)
    lut = np.asarray(lut)
    lj = lut.astype(_LUT_DTYPE.get(lut.dtype, lut.dtype))
    lt = torch.from_numpy(lj.astype(_LUT_CARRIER.get(lj.dtype, lj.dtype))
                          ).to(dev)
    n = lut.shape[0]
    idx = torch.clamp((x * float(n - 1)).to(torch.int32), 0, n - 1)
    y = lt[idx.long()]
    return to_numpy(y).astype(lj.dtype)


def _median_blur_t(x: torch.Tensor, ksize: int) -> torch.Tensor:
    pad = ksize // 2
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    h, w = x.shape[0], x.shape[1]
    xp = F.pad(x.permute(2, 0, 1)[None], (pad, pad, pad, pad),
               mode="replicate")[0].permute(1, 2, 0)
    wins = [xp[dy: dy + h, dx: dx + w]
            for dy in range(ksize) for dx in range(ksize)]
    # an odd count of values: the middle one, as jnp.median's midpoint
    y = torch.stack(wins, dim=0).median(dim=0).values
    return y[..., 0] if squeeze else y


def median_blur(img: np.ndarray, ksize: int = 3,
                device: str | torch.device | None = None) -> np.ndarray:
    """Median filter (ref image median_blur): windowed sort on device."""
    assert ksize % 2 == 1
    x, scale = _as_float(img, resolve_device(device))
    return _from_float(_median_blur_t(x, ksize), scale, img.dtype)


def despeckle(img: np.ndarray, threshold: float = 0.1,
              device: str | torch.device | None = None) -> np.ndarray:
    """Replace pixels deviating from the local median by > threshold with the
    median (ref image despeckle)."""
    dev = resolve_device(device)
    x, scale = _as_float(img, dev)
    med_u = _as_float(median_blur(img, 3, dev), dev)[0]
    y = torch.where(torch.abs(x - med_u) > threshold, med_u, x)
    return _from_float(y, scale, img.dtype)


def linear_invert(img: np.ndarray, device: str | torch.device | None = None
                  ) -> np.ndarray:
    x, scale = _as_float(img, resolve_device(device))
    return _from_float(1.0 - x, scale, img.dtype)


def normalize(img: np.ndarray, device: str | torch.device | None = None
              ) -> np.ndarray:
    x, scale = _as_float(img, resolve_device(device))
    lo, hi = torch.min(x), torch.max(x)
    return _from_float((x - lo) / torch.clamp_min(hi - lo, 1e-9), scale,
                       img.dtype)
