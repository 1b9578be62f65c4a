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

import numpy as np
import torch

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io.baseband import BasebandReader
from satdump_tpu_torch.ops import clock_recovery, firdes, resamp, stages
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

    # -- the pieces the PSK, PM and FSK chains share --------------------------
    def read_clock_params(self) -> None:
        """M&M clock recovery's parameters (module_psk_demod.cpp:43-47)."""
        clock_alpha = float(self.param("clock_alpha", 8.7e-3))
        self.clock_gain_omega = float(
            self.param("clock_gain_omega", clock_alpha ** 2 / 4.0))
        self.clock_mu = float(self.param("clock_mu", 0.5))
        self.clock_gain_mu = float(self.param("clock_gain_mu", clock_alpha))
        self.clock_omega_limit = float(
            self.param("clock_omega_relative_limit", 0.005))

    def init_input_stages(self) -> int:
        """After compute_rates and choose_block_size: the states of
        freq_shift, dc_block and the rational resampler on torch_device;
        returns the samples a block gives the chain after them."""
        dev = self.torch_device
        self._shift_delta = 2 * np.pi * self.d_frequency_shift / self.d_samplerate
        self._fs_state = stages.freq_shift_init(dev)
        self._dc_state = stages.dc_block_init(device=dev)
        self._out_n = self.block_size
        if self.resample:      # choose_block_size set r_interp, r_decim
            self._r_bank = torch.as_tensor(firdes.polyphase_bank(
                resamp.design_resampler_taps(self.r_interp, self.r_decim),
                self.r_interp), device=dev)
            self._rs_state = resamp.rational_resampler_init(self.r_interp,
                                                            device=dev)
            self._out_n = self.block_size * self.r_interp // self.r_decim
        return self._out_n

    def input_stages(self, x: torch.Tensor, dc_block: bool) -> torch.Tensor:
        """[freq_shift] -> [dc_block] -> [rational resample], each where
        enabled (`dc_block`: the module's dc_block option, where its chain
        has one)."""
        if self.d_frequency_shift != 0:
            self._fs_state, x = stages.freq_shift(self._fs_state, x,
                                                  self._shift_delta)
        if dc_block:
            self._dc_state, x = stages.dc_block(self._dc_state, x,
                                                alpha=1e-4)
        if self.resample:
            self._rs_state, x, _ = resamp.rational_resampler(
                self._rs_state, x, self._r_bank, self.r_interp, self.r_decim,
                out_cap=self._out_n)
        return x

    def init_clock(self) -> None:
        """The M&M state, bank and output capacity for blocks of _out_n."""
        sps = self.final_sps
        self._bank = torch.as_tensor(firdes.mm_interpolator_bank(),
                                     device=self.torch_device)
        # the walker's packed state, kept on the device from block to block
        st = clock_recovery.mm_init(omega=sps, mu=self.clock_mu,
                                    device=self.torch_device)
        self._mm_vec, self._mm_hist = clock_recovery._pack(st), st.history
        self._mm_cap = int(np.ceil(
            self._out_n / (sps * (1 - self.clock_omega_limit)))) + 2

    def clock(self, x: torch.Tensor, complex_mode: bool = True):
        """One block of M&M clock recovery: (symbols out_cap, valid)."""
        self._mm_vec, self._mm_hist, syms, valid = (
            clock_recovery.mm_clock_recovery_packed(
                self._mm_vec, self._mm_hist, x, omega_mid=self.final_sps,
                gain_omega=self.clock_gain_omega,
                gain_mu=self.clock_gain_mu,
                omega_relative_limit=self.clock_omega_limit, bank=self._bank,
                out_cap=self._mm_cap, complex_mode=complex_mode))
        return syms, valid

    def keep_valid(self, syms: torch.Tensor, vmask: torch.Tensor,
                   valid: int | None, last: bool) -> torch.Tensor:
        """The valid symbols of a block; of a padded last block, only those
        sourced from its `valid` samples (+2)."""
        s = syms[vmask]
        if last and valid is not None and valid < self.block_size:
            keep = int(len(s) * valid / self.block_size) + 2
            s = s[:min(keep, len(s))]
        return s

    def process(self):
        """Every block of the input through stream_work into the .soft;
        each block's read and write are host spans `<id>.read` and
        `<id>.write`."""
        self.stream_start()
        out_path = self.d_output_file_hint + ".soft"
        self.d_output_file = out_path
        blocks = self.open_input(self.block_size).blocks()
        read, write = f"{self.id}.read", f"{self.id}.write"
        with open(out_path, "wb") as f:
            while True:
                with trace.span(read, "host"):
                    blk = next(blocks, None)
                if blk is None:
                    break
                soft = self.stream_work(blk.samples, valid=blk.valid,
                                        last=blk.last)
                with trace.span(write, "host"):
                    f.write(soft.tobytes())
        logger.info(f"{self.id}: demodulated {self._nsyms} symbols")

    def to_device(self, samples: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            samples, np.complex64)).to(self.torch_device)
