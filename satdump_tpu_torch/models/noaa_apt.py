"""NOAA APT decoder: 50 kHz FM audio -> synced APT image product — port of
satdump_tpu/models/noaa_apt.py.

Reference: plugins/analog_support/noaa_apt/module_noaa_apt_decoder.cpp —
audio -> real-to-complex -> freq shift -2.4 kHz -> resample to 4x word rate
(16640 Hz) -> magnitude (AM envelope) -> line framing at 2080 words/line x4
oversampling -> per-line sync-A correlation -> 2080-wide image (A+B channels).

The front end (shift, resample, envelope) runs in torch on `torch_device`
(default ``cuda``) over the whole audio, with int64 resampler positions
(the reference's int32 ones wrap after 206 s of 50 kHz audio, ROADMAP.md
§3). Line sync is a vectorized correlation over all lines at once on the
host, as in the reference. The PNGs go through the port's own codec.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image.io import save_img
from satdump_tpu_torch.ops import firdes, resamp, stages
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

APT_IMG_WIDTH = 2080
APT_OVERS = 4
APT_WORD_RATE = 4160.0  # words/s (2 lines/s * 2080)

# sync A: 7 cycles of 1040 Hz square wave pattern (ref :1015)
SYNC_A = np.array([0, 0, 0, 255, 255, 0, 0, 255, 255, 0, 0, 255, 255, 0, 0,
                   255, 255, 0, 0, 255, 255, 0, 0, 255, 255, 0, 0, 255, 255,
                   0, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=np.float32)


@register_module
class NOAAAPTDecoderModule(ProcessingModule):
    id = "noaa_apt_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.audio_rate = float(self.param("audio_samplerate", 50e3))
        self.save_unsynced = bool(self.param("save_unsynced", True))
        self.device = resolve_device(self.param("torch_device", "cuda"))

    def _envelope(self, audio: np.ndarray) -> np.ndarray:
        """audio (float32) -> AM envelope at 4x word rate (16640 Hz)."""
        target = APT_WORD_RATE * APT_OVERS
        interp, decim = resamp.make_rational(self.audio_rate, target)
        bank = firdes.polyphase_bank(
            resamp.design_resampler_taps(interp, decim), interp)
        dev = self.device
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
        # real -> complex, shift the 2.4 kHz subcarrier to baseband
        _, xc = stages.freq_shift(stages.freq_shift_init(dev),
                                  x.to(torch.complex64),
                                  -2 * np.pi * 2400.0 / self.audio_rate)
        n_out = (x.shape[0] * interp) // decim
        _, y, valid = resamp.rational_resampler(
            resamp.rational_resampler_init(interp, bank.shape[1], device=dev),
            xc, bank, interp, decim, out_cap=n_out + 1)
        return to_numpy(stages.abs64(y[valid]))

    def _sync_lines(self, env: np.ndarray) -> np.ndarray:
        """env at 4x word rate -> (lines, 2080) synced image, uint8."""
        lw = APT_IMG_WIDTH * APT_OVERS
        nlines = len(env) // lw
        if nlines < 2:
            return np.zeros((0, APT_IMG_WIDTH), np.uint8)
        img = env[: nlines * lw].reshape(nlines, lw)
        # normalize to 0..255 using robust percentiles
        lo, hi = np.percentile(img, [1, 99])
        img8 = np.clip((img - lo) / max(hi - lo, 1e-9) * 255.0, 0, 255)

        # sync pattern at 4x oversampling (ref :1017-1021)
        pat = np.repeat(SYNC_A, APT_OVERS).astype(np.float32)
        pat_c = pat - pat.mean()
        # correlate every line against the pattern at all offsets
        m = len(pat)
        from numpy.lib.stride_tricks import sliding_window_view
        wins = sliding_window_view(img8, m, axis=1)           # (L, lw-m+1, m)
        scores = wins @ pat_c                                  # (L, lw-m+1)
        best = np.argmax(scores, axis=1)                       # per-line offset

        idx = (best[:, None] + np.arange(APT_IMG_WIDTH)[None, :] * APT_OVERS)
        idx = np.minimum(idx, lw - 1)
        return np.take_along_axis(img8, idx, axis=1).astype(np.uint8)

    def process(self):
        with wave.open(self.d_input_file, "rb") as w:
            self.audio_rate = float(w.getframerate())
            raw = w.readframes(w.getnframes())
        audio = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32767.0
        logger.info(f"APT decode: {len(audio)} samples @ {self.audio_rate} Hz"
                    f" on {self.device}")

        env = self._envelope(audio)
        img = self._sync_lines(env)
        logger.info(f"APT image: {img.shape[0]} lines")

        out_dir = Path(self.d_output_file_hint).parent
        main_dir = out_dir / "AVHRR"
        main_dir.mkdir(parents=True, exist_ok=True)
        if self.save_unsynced:
            lw = APT_IMG_WIDTH * APT_OVERS
            nl = len(env) // lw
            if nl:
                raw_img = env[: nl * lw].reshape(nl, lw)
                lo, hi = np.percentile(raw_img, [1, 99])
                raw8 = np.clip((raw_img - lo) / max(hi - lo, 1e-9) * 255, 0,
                               255).astype(np.uint8)
                save_img(raw8[:, ::APT_OVERS], str(main_dir / "raw_unsync.png"))
        save_img(img, str(main_dir / "raw_sync.png"))

        # an ImageProduct + DataSet, so the products processor renders the
        # APT output as every other mission's (ref
        # module_noaa_apt_decoder.cpp products assembly)
        sat_name = f"NOAA-{self.param('satellite_number', '19')}"
        start_ts = float(self.param("start_timestamp", -1))
        p = ImageProduct()
        p.instrument_name = "avhrr_apt"
        p.add_channel(img, "APT", bit_depth=8)
        # APT frame: channel A = words 0..1039, channel B = 1040..2079 (each
        # with its own sync+space+telemetry margins)
        if img.shape[0]:
            p.add_channel(img[:, 86:86 + 909], "A", bit_depth=8)
            p.add_channel(img[:, 1126:1126 + 909], "B", bit_depth=8)
        if start_ts > 0:
            p.set_product_timestamp(start_ts)
        p.set_product_source(sat_name)
        p.save(str(main_dir))

        ds = DataSet(sat_name, start_ts)
        ds.products_list.append("AVHRR")
        self.d_output_file = ds.save(str(out_dir))
        self.stats = {"lines": int(img.shape[0])}
