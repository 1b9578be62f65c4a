"""Analog image modes: SSTV decoder (audio WAV -> image).

Reference behavior: plugins/analog_support/sstv/ — band-limit, Hilbert +
quadrature FM discriminator, 1200 Hz line-sync acquisition, per-mode line
slicing (grayscale / Robot YUV-interlace / PD two-Y), YUV->RGB. Mode
timing tables follow the published SSTV specs (resources/sstv.json in the
reference). TPU-native form: the whole recording is demodulated in one
vectorized pass (FFT Hilbert), sync is acquired by folding the sync
indicator over the line period, and every line/pixel is sampled with one
gather — no per-sample state machine.

A copy of satdump_tpu/pipeline/modules/analog.py, its imports rewritten to the port.
"""

from __future__ import annotations

import wave

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module

# Published SSTV mode timings (seconds); ref resources/sstv.json.
SSTV_MODES = {
    "BW8": {"mode": "grayscale", "line_time": 0.066875, "sync_time": 0.005,
            "img_offset": 0.00687, "img_time": 0.060, "img_width": 120},
    "FAX480": {"mode": "grayscale", "line_time": 0.26726415052316954,
               "sync_time": 0.00512, "img_offset": 0.00512,
               "img_time": 0.262144, "img_width": 512},
    "Robot36": {"mode": "robot", "line_time": 0.150, "sync_time": 0.0105,
                "color_sync_offset": 0.1005, "color_sync_time": 0.0045,
                "color_offset_y": 0.0105, "color_offset_uv": 0.105,
                "color_time_y": 0.090, "color_time_uv": 0.045,
                "img_width": 320},
    "PD120": {"mode": "yuv_2y", "line_time": 0.50848, "sync_time": 0.020,
              "color_offset_y1": 0.02208, "color_offset_y2": 0.38660,
              "color_offset_u": 0.26528, "color_offset_v": 0.14368,
              "color_time_y1": 0.1216, "color_time_y2": 0.1216,
              "color_time_u": 0.1216, "color_time_v": 0.1216,
              "img_width": 640},
}

FREQ_SYNC, FREQ_BLACK, FREQ_WHITE = 1200.0, 1500.0, 2300.0


def instantaneous_freq(audio: np.ndarray, samplerate: float) -> np.ndarray:
    """FFT Hilbert analytic signal -> per-sample frequency in Hz (the
    vectorized equivalent of HilbertBlock + QuadratureDemodBlock)."""
    n = len(audio)
    spec = np.fft.fft(audio.astype(np.float64))
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    analytic = np.fft.ifft(spec * h)
    dphi = np.angle(analytic[1:] * np.conj(analytic[:-1]))
    f = dphi * samplerate / (2 * np.pi)
    return np.concatenate([f[:1], f])


def acquire_line_sync(freq: np.ndarray, samplerate: float, line_time: float,
                      sync_time: float) -> float:
    """Best line-start phase: fold the sync indicator (freq near 1200 Hz)
    over the line period, maximize the windowed sum."""
    line_len = line_time * samplerate
    sync = (freq < (FREQ_SYNC + FREQ_BLACK) / 2).astype(np.float64)
    n_lines = int(len(freq) // line_len)
    if n_lines < 1:
        return 0.0
    offs = np.arange(int(line_len))
    starts = np.round(np.arange(n_lines) * line_len).astype(np.int64)
    idx = np.minimum(starts[:, None] + offs[None, :], len(sync) - 1)
    folded = sync[idx].sum(axis=0)
    win = int(max(sync_time * samplerate, 1))
    c = np.concatenate([folded, folded])  # circular window
    score = np.convolve(c, np.ones(win), "valid")[:len(offs)]
    return float(np.argmax(score))


def _sample_lines(v: np.ndarray, start0: float, line_len: float,
                  n_lines: int, offset_t: float, time_t: float,
                  line_time: float, width: int) -> np.ndarray:
    """getLine() over all lines at once (lineproc.h:19-30 vectorized):
    value[l, x] at start_l + ((offset + p*img_time)/line_time)*line_len."""
    p = np.arange(width) / max(width - 1, 1)
    frac = (offset_t + p * time_t) / line_time
    idx = (start0 + np.arange(n_lines)[:, None] * line_len
           + frac[None, :] * line_len)
    idx = np.clip(np.round(idx).astype(np.int64), 0, len(v) - 1)
    return v[idx]


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 studio-range, matching lineproc.h:42-49."""
    Y = y.astype(np.int64) - 16
    U = u.astype(np.int64) - 128
    V = v.astype(np.int64) - 128
    r = (298 * Y + 409 * V + 128) >> 8
    g = (298 * Y - 100 * U - 208 * V + 128) >> 8
    b = (298 * Y + 516 * U + 128) >> 8
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_sstv(audio: np.ndarray, samplerate: float, mode: str) -> np.ndarray:
    """Audio (f32, -1..1) -> decoded image (H, W) u8 or (H, W, 3) u8."""
    cfg = SSTV_MODES[mode]
    freq = instantaneous_freq(audio, samplerate)
    v = np.clip((freq - FREQ_BLACK) / (FREQ_WHITE - FREQ_BLACK), 0.0, 1.0)

    lt = cfg["line_time"]
    line_len = lt * samplerate
    start0 = acquire_line_sync(freq, samplerate, lt, cfg["sync_time"])
    n_lines = max(int((len(v) - start0) // line_len), 0)
    w = cfg["img_width"]

    def lines(off_key, time_key):
        return _sample_lines(v, start0, line_len, n_lines,
                             cfg[off_key], cfg[time_key], lt, w)

    if cfg["mode"] == "grayscale":
        return (lines("img_offset", "img_time") * 255).astype(np.uint8)

    if cfg["mode"] == "robot":
        l_y = (lines("color_offset_y", "color_time_y") * 255).astype(np.uint8)
        l_uv = (lines("color_offset_uv", "color_time_uv")
                * 255).astype(np.uint8)
        cs = _sample_lines(v, start0, line_len, n_lines,
                           cfg["color_sync_offset"], cfg["color_sync_time"],
                           lt, 16)
        is_u = np.median(cs, axis=1) > 0.5  # high sep tone: line carries U
        rows = []
        prev_y = prev_v = None
        for i in range(n_lines):
            if is_u[i]:
                if prev_y is not None:
                    rows.append(yuv_to_rgb(prev_y, l_uv[i], prev_v))
                    rows.append(yuv_to_rgb(l_y[i], l_uv[i], prev_v))
                prev_y = prev_v = None
            else:
                prev_y, prev_v = l_y[i], l_uv[i]
        if not rows:
            return np.zeros((0, w, 3), np.uint8)
        return np.stack(rows)

    # yuv_2y (PD modes): each transmitted line = Y1 U V Y2 -> two rows
    l_y1 = (lines("color_offset_y1", "color_time_y1") * 255).astype(np.uint8)
    l_y2 = (lines("color_offset_y2", "color_time_y2") * 255).astype(np.uint8)
    l_u = (lines("color_offset_u", "color_time_u") * 255).astype(np.uint8)
    l_v = (lines("color_offset_v", "color_time_v") * 255).astype(np.uint8)
    out = np.empty((n_lines * 2, w, 3), np.uint8)
    out[0::2] = yuv_to_rgb(l_y1, l_u, l_v)
    out[1::2] = yuv_to_rgb(l_y2, l_u, l_v)
    return out


@register_module
class SSTVDecoderModule(ProcessingModule):
    """WAV audio -> SSTV image (ref module_sstv_decoder.cpp)."""

    id = "sstv_decoder"

    def process(self):
        mode = self.param("sstv_mode", required=True)
        if mode not in SSTV_MODES:
            raise ValueError(f"invalid SSTV mode {mode!r}; "
                             f"have {sorted(SSTV_MODES)}")
        with wave.open(self.d_input_file, "rb") as wf:
            sr = wf.getframerate()
            nch = wf.getnchannels()
            raw = wf.readframes(wf.getnframes())
        pcm = np.frombuffer(raw, np.int16).reshape(-1, nch)[:, 0]
        audio = pcm.astype(np.float32) / 32767.0
        logger.info(f"SSTV {mode}: {len(audio)} samples at {sr} Hz"
                    + (" (stereo, using ch 0)" if nch == 2 else ""))

        img = decode_sstv(audio, float(sr), mode)
        out = self.d_output_file_hint + ".png"
        from satdump_tpu_torch.image.io import save_img
        save_img(img, out)
        self.d_output_file = out
        self.stats = {"lines": int(img.shape[0]), "mode": mode}
        logger.info(f"SSTV image {img.shape[1]}x{img.shape[0]} -> {out}")
