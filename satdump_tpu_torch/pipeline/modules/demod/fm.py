"""FM, AM and SSB demodulators: baseband -> mono int16 WAV — port of
satdump_tpu/pipeline/modules/demod/fm.py.

Reference: plugins/analog_support/noaa_apt/module_noaa_apt_demod.cpp —
baseband [dc] -> AGC -> rational resample to the audio rate -> quadrature
demod (gain pi for APT: hz_to_rad(sr/2, sr)) -> clamp +-1 -> WAV. The
chain runs on `torch_device` (default ``cuda``), its state kept there.
"""

from __future__ import annotations

import math
import wave

import numpy as np
import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import firdes, resamp, stages
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.modules.demod.base import BaseDemodModule
from satdump_tpu_torch.utils.device import to_numpy


@register_module
class FMDemodModule(BaseDemodModule):
    """Generic FM -> WAV demodulator (audio_samplerate = symbolrate param)."""

    id = "fm_demod"
    MIN_SPS = 1.0
    MAX_SPS = 1000.0

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.block_base = int(self.param("buffer_size", 0) or (1 << 18))

    def _setup_resampler(self):
        """Rates, the block (aligned so the audio resampler emits a constant
        count a block) and the resampler's bank, interp and decim."""
        self.compute_rates()
        self.audio_rate = self.d_symbolrate
        self._interp, self._decim = resamp.make_rational(
            self.final_samplerate, self.audio_rate)
        self.block_size = self.choose_block_size(self.block_base)
        if (self.block_size * self._interp) % self._decim:
            self.block_size *= self._decim // math.gcd(self.block_size,
                                                       self._decim)
        self._r_bank = torch.as_tensor(firdes.polyphase_bank(
            resamp.design_resampler_taps(self._interp, self._decim),
            self._interp), device=self.torch_device)
        self.out_n = self.block_size * self._interp // self._decim

    def _resample(self, st, x):
        return resamp.rational_resampler(st, x, self._r_bank, self._interp,
                                         self._decim, out_cap=self.out_n)[:2]

    def _build(self):
        self._setup_resampler()
        dev = self.torch_device
        agc_rate = self.d_agc_rate
        dc_block = self.d_dc_block
        # QuadratureDemodBlock(gain = hz_to_rad(sr/2, sr)) multiplies by 1/gain
        quad_gain = 1.0 / np.pi

        def step(state, x):
            dc_st, agc_st, rs_st, qd_st = state
            if dc_block:
                dc_st, x = stages.dc_block(dc_st, x, alpha=1e-4)
            agc_st, x = stages.agc_block(agc_st, x, rate=agc_rate)
            rs_st, x = self._resample(rs_st, x)
            qd_st, y = stages.quadrature_demod(qd_st, x, gain=quad_gain)
            return (dc_st, agc_st, rs_st, qd_st), y.clamp(-1.0, 1.0)

        self._step = step
        self._state = (
            stages.dc_block_init(device=dev),
            stages.agc_init(device=dev),
            resamp.rational_resampler_init(self._interp, device=dev),
            stages.quadrature_demod_init(dev),
        )

    def process(self):
        self._build()
        out_path = self.d_output_file_hint + ".wav"
        self.d_output_file = out_path
        reader = self.open_input(self.block_size)
        logger.info(f"FM demod {self.d_samplerate} Hz -> {self.audio_rate} "
                    f"Hz audio on {self.torch_device}")
        n_out = 0
        with wave.open(out_path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(self.audio_rate))
            for blk in reader.blocks():
                x = torch.from_numpy(np.ascontiguousarray(
                    blk.samples, np.complex64)).to(self.torch_device)
                self._state, y = self._step(self._state, x)
                audio = to_numpy(y)
                if blk.last and blk.valid < self.block_size:
                    keep = int(len(audio) * blk.valid / self.block_size)
                    audio = audio[:keep]
                pcm = np.clip(audio * 32767.0, -32767, 32767).astype(np.int16)
                w.writeframes(pcm.tobytes())
                n_out += len(pcm)
        self.stats = {"audio_samples": n_out}
        logger.info(f"Wrote {n_out} audio samples to {out_path}")


@register_module
class NOAAAPTDemodModule(FMDemodModule):
    id = "noaa_apt_demod"


@register_module
class AMDemodModule(FMDemodModule):
    """AM envelope -> WAV (ref plugins/analog_support/generic/
    analog_am_demod.cpp: AGC -> resample -> carrier PLL -> |x|; the
    envelope is carrier-phase invariant, so the feedforward chain here is
    AGC -> resample -> |x| -> DC block)."""

    id = "am_demod"

    def _build(self):
        self._setup_resampler()
        dev = self.torch_device
        agc_rate = self.d_agc_rate

        def step(state, x):
            agc_st, rs_st, dc_st = state
            agc_st, x = stages.agc_block(agc_st, x, rate=agc_rate)
            rs_st, x = self._resample(rs_st, x)
            env = stages.abs64(x).to(torch.complex64)
            dc_st, env = stages.dc_block(dc_st, env, alpha=1e-3)
            return (agc_st, rs_st, dc_st), env.real.clamp(-1.0, 1.0)

        self._step = step
        self._state = (
            stages.agc_init(device=dev),
            resamp.rational_resampler_init(self._interp, device=dev),
            stages.dc_block_init(device=dev),
        )


@register_module
class SSBDemodModule(FMDemodModule):
    """SSB (USB/LSB) -> WAV (ref analog_ssb_demod.cpp: resample -> shift
    by -+bw/2 -> band filter -> Re). parameter `sideband`: usb|lsb."""

    id = "ssb_demod"

    def _build(self):
        self._setup_resampler()
        dev = self.torch_device
        agc_rate = self.d_agc_rate
        sideband = str(self.param("sideband", "usb")).lower()
        sign = -1.0 if sideband == "usb" else 1.0
        # shift the wanted sideband's center down to baseband audio
        phase_delta = sign * np.pi * 0.5  # bw/2 = audio_rate/4 at audio rate

        def step(state, x):
            agc_st, rs_st, fs_st = state
            agc_st, x = stages.agc_block(agc_st, x, rate=agc_rate)
            rs_st, x = self._resample(rs_st, x)
            fs_st, x = stages.freq_shift(fs_st, x, phase_delta)
            return (agc_st, rs_st, fs_st), x.real.clamp(-1.0, 1.0)

        self._step = step
        self._state = (
            stages.agc_init(device=dev),
            resamp.rational_resampler_init(self._interp, device=dev),
            stages.freq_shift_init(dev),
        )
