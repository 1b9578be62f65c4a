"""PSK demodulator module: baseband -> .soft int8 symbols — port of
satdump_tpu/pipeline/modules/demod/psk.py, feedforward (`fast`) path only.

Reference: src-core/pipeline/modules/demod/module_psk_demod.cpp. Per block,
in the reference's order: [Doppler pre-correction] -> [freq_shift] ->
[dc_block] -> [rational resample to the final rate] -> AGC -> RRC ->
carrier (FFT of x^M + V&V) -> [OQPSK delay] -> O&M timing + polyphase
symbol pick (ops/ffsync.py) -> int8 quantize (x50 real-only for BPSK, x100
interleaved IQ otherwise, module_psk_demod.cpp:196-213).

The chain runs on `torch_device` (default ``cuda``). Options of the
reference that the port does not carry yet raise a PipelineError saying
so: `fast: false` (the classic Costas/M&M scan chain) and `multichip`.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import ffsync, firdes, resamp, stages
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.modules.demod.base import BaseDemodModule
from satdump_tpu_torch.utils.device import to_numpy

_ORDER = {"bpsk": 2, "qpsk": 4, "oqpsk": 4, "8psk": 8}


@register_module
class PSKDemodModule(BaseDemodModule):
    id = "psk_demod"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.constellation = str(self.param("constellation", required=True))
        if self.constellation not in _ORDER:
            raise PipelineError(f"unknown constellation {self.constellation}")
        self.rrc_alpha = float(self.param("rrc_alpha", required=True))
        self.rrc_taps = int(self.param("rrc_taps", 31))
        self.loop_bw = float(self.param("pll_bw", required=True))
        self.is_bpsk = self.constellation == "bpsk"
        self.is_oqpsk = self.constellation == "oqpsk"
        if self.is_oqpsk:
            self.MIN_SPS, self.MAX_SPS = 1.6, 2.4
        self.block_base = int(self.param("buffer_size", 0) or (1 << 18))
        unported = [name for name, on in (
            ("fast: false (classic Costas/M&M chain)",
             not bool(self.param("fast", True))),
            ("multichip", bool(self.param("multichip", False))),
        ) if on]
        if unported:
            raise PipelineError(f"{self.id}: {', '.join(unported)} not yet "
                                "ported to satdump_tpu_torch")
        # Doppler pre-correction (ref module_demod_base.h doppler option +
        # doppler_correct.h): a provider fn(sample_pos, n) -> Hz (a scalar
        # or one value a sample), set by a live/autotrack layer and mixed
        # out on the device before the sync chain
        self.doppler_provider = None

    def _build(self):
        self.compute_rates()
        self.block_size = self.choose_block_size(self.block_base)
        dev = self.torch_device
        self._order = _ORDER[self.constellation]
        self._rrc = firdes.root_raised_cosine(
            1.0, self.final_samplerate, self.d_symbolrate, self.rrc_alpha,
            self.rrc_taps)
        self._bank = torch.as_tensor(firdes.mm_interpolator_bank(),
                                     device=dev)
        self._shift_delta = 2 * np.pi * self.d_frequency_shift / self.d_samplerate
        self._out_n = self.block_size
        if self.resample:      # choose_block_size set r_interp, r_decim
            self._r_bank = torch.as_tensor(firdes.polyphase_bank(
                resamp.design_resampler_taps(self.r_interp, self.r_decim),
                self.r_interp), device=dev)
            self._rs_state = resamp.rational_resampler_init(self.r_interp,
                                                            device=dev)
            self._out_n = self.block_size * self.r_interp // self.r_decim
        self._ff_cap = int(np.ceil(self._out_n / (self.final_sps * 0.99))) + 2
        self._state = ffsync.ff_clock_init(rrc_ntaps=len(self._rrc),
                                           device=dev)
        self._fs_state = stages.freq_shift_init(dev)
        self._dc_state = stages.dc_block_init(device=dev)
        self._dp_state = stages.freq_shift_init(dev)
        self._sample_pos = 0

    def _doppler_block(self):
        """The block's predicted Doppler (Hz) from the provider, advancing
        the absolute sample position; None when Doppler is off."""
        if self.doppler_provider is None:
            return None
        pos = self._sample_pos
        dop = np.asarray(self.doppler_provider(pos, self.block_size),
                         np.float32)
        self._sample_pos = pos + self.block_size
        return dop

    def _condition(self, x: torch.Tensor) -> torch.Tensor:
        """The input stages before the sync chain, each where enabled:
        Doppler -> freq_shift -> dc_block -> rational resample."""
        dop = self._doppler_block()
        if dop is not None:
            self._dp_state, x = stages.doppler_correct(
                self._dp_state, x, dop, self.d_samplerate)
        if self.d_frequency_shift != 0:
            self._fs_state, x = stages.freq_shift(self._fs_state, x,
                                                  self._shift_delta)
        if self.d_dc_block:
            self._dc_state, x = stages.dc_block(self._dc_state, x,
                                                alpha=1e-4)
        if self.resample:
            self._rs_state, x, _ = resamp.rational_resampler(
                self._rs_state, x, self._r_bank, self.r_interp, self.r_decim,
                out_cap=self._out_n)
        return x

    # -- streaming interface ------------------------------------------------
    def stream_start(self) -> None:
        self._build()
        self._nsyms = 0
        self._peak_snr = -100.0
        self._snr = -100.0
        logger.info(f"Constellation: {self.constellation}; samplerate "
                    f"{self.d_samplerate} -> {self.final_samplerate} (sps "
                    f"{self.final_sps:.2f}); block {self.block_size}; device "
                    f"{self.torch_device}")

    def stream_work(self, samples: np.ndarray, valid: int | None = None,
                    last: bool = False) -> np.ndarray:
        """One fixed-size complex64 block (pad the tail with zeros) ->
        int8 soft symbols."""
        x = torch.from_numpy(np.ascontiguousarray(samples, np.complex64)
                             ).to(self.torch_device)
        x = self._condition(x)
        self._state, syms, vmask, snr = ffsync.ff_psk_demod_block(
            self._state, x, order=self._order, sps=self.final_sps,
            rrc_taps=self._rrc, bank=self._bank, out_cap=self._ff_cap,
            oqpsk=self.is_oqpsk)
        s = syms[vmask]
        if last and valid is not None and valid < self.block_size:
            # padded tail: drop symbols sourced from the zero padding
            keep = int(len(s) * valid / self.block_size) + 2
            s = s[:min(keep, len(s))]
        self._snr = float(snr)
        self._peak_snr = max(self._peak_snr, self._snr)
        if self.is_bpsk:
            out = to_numpy(stages.bpsk_soft(s, 50.0))
        else:
            s = to_numpy(s)
            out = np.empty(2 * len(s), np.int8)
            out[0::2] = np.clip(s.real * 100.0, -127, 127).astype(np.int8)
            out[1::2] = np.clip(s.imag * 100.0, -127, 127).astype(np.int8)
        self._nsyms += len(s)
        self.stats = {"snr": self._snr, "peak_snr": self._peak_snr,
                      "symbols": self._nsyms}
        return out

    def process(self):
        self.stream_start()
        out_path = self.d_output_file_hint + ".soft"
        self.d_output_file = out_path
        reader = self.open_input(self.block_size)
        with open(out_path, "wb") as f:
            for blk in reader.blocks():
                out = self.stream_work(blk.samples, valid=blk.valid,
                                       last=blk.last)
                f.write(out.tobytes())
        logger.info(f"Demodulated {self._nsyms} symbols, "
                    f"SNR {self._snr:.1f} dB")
