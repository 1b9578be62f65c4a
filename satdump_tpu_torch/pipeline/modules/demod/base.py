"""Base demodulator plumbing (ref: src-core/pipeline/modules/demod/module_demod_base.{h,cpp})
— port of satdump_tpu/pipeline/modules/demod/base.py.

Handles baseband file input, the samples-per-symbol decision (with the
input-rate resampling when samples-per-symbol is out of the demodulator's
range) and the device the chain runs on (`torch_device`, default
``cuda``). Blocks have a fixed size so every block runs the same tensor
shapes.
"""

from __future__ import annotations

import math

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io.baseband import BasebandReader
from satdump_tpu_torch.ops import resamp
from satdump_tpu_torch.pipeline.module import ProcessingModule
from satdump_tpu_torch.utils.device import resolve_device


class BaseDemodModule(ProcessingModule):
    MIN_SPS = 1.1
    MAX_SPS = 4.0

    def __init__(self, input_file: str, output_file_hint: str, parameters: dict):
        super().__init__(input_file, output_file_hint, parameters)
        self.d_samplerate = float(self.param("samplerate", required=True))
        self.d_symbolrate = float(self.param("symbolrate", 0))
        self.d_agc_rate = float(self.param("agc_rate", 1e-2) or 1e-2)
        self.d_dc_block = bool(self.param("dc_block", False))
        self.d_frequency_shift = float(self.param("freq_shift", 0))
        self.d_iq_swap = bool(self.param("iq_swap", False))
        self.d_format = str(self.param("baseband_format", "cf32"))
        self.MIN_SPS = float(self.param("min_sps", self.MIN_SPS))
        self.MAX_SPS = float(self.param("max_sps", self.MAX_SPS))
        # where the chain runs: "cuda" (default) or "cpu"; raises if CUDA
        # is asked for and not available
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))

    def compute_rates(self) -> None:
        """final_samplerate / resample decision (ref module_demod_base.cpp:60-97)."""
        if self.d_symbolrate <= 0:
            self.final_samplerate = self.d_samplerate
            self.resample = False
            self.final_sps = 0.0
            return
        input_sps = self.d_samplerate / self.d_symbolrate
        self.resample = input_sps > self.MAX_SPS or input_sps < self.MIN_SPS
        rng = 10 ** (len(str(int(self.d_symbolrate))) - 1)  # "avoid complex resampling"
        final = self.d_samplerate
        if self.param("custom_samplerate") is not None:
            final = float(self.param("custom_samplerate"))
        elif self.MAX_SPS == self.MIN_SPS:
            final = self.d_symbolrate * self.MAX_SPS
        elif input_sps > self.MAX_SPS:
            final = (round(self.d_symbolrate / rng) * rng) * self.MAX_SPS if self.resample else self.d_samplerate
        elif input_sps < self.MIN_SPS:
            final = self.d_symbolrate * self.MIN_SPS if self.resample else self.d_samplerate
        if input_sps < 1.0:
            raise PipelineError("sampling rate too low for symbolrate")
        self.final_samplerate = float(final)
        self.final_sps = self.final_samplerate / self.d_symbolrate
        logger.debug(f"input sps {input_sps:.3f} resample={self.resample} "
                     f"final_samplerate={self.final_samplerate} final_sps={self.final_sps:.3f}")

    def choose_block_size(self, base: int = 1 << 18) -> int:
        """Fixed device block size; aligned so the rational resampler emits
        a constant number of samples per block (block*interp divisible by
        decim)."""
        if not self.resample:
            return base
        interp, decim = resamp.make_rational(self.d_samplerate,
                                             self.final_samplerate)
        self.r_interp, self.r_decim = interp, decim
        block = base
        if (block * interp) % decim:
            block *= decim // math.gcd(block, decim)
        return block

    def open_input(self, block_size: int) -> BasebandReader:
        return BasebandReader(self.d_input_file, self.d_format,
                              block_size=block_size, iq_swap=self.d_iq_swap)
