"""PM demodulator module: baseband -> .soft (BPSK softs) — port of
satdump_tpu/pipeline/modules/demod/pm.py.

Reference: src-core/pipeline/modules/demod/module_pm_demod.cpp — chain:
[freq_shift] -> [dc_block] -> [resample] -> AGC -> carrier-tracking PLL
(locks to the residual carrier) -> PM->BPSK (keep the quadrature arm, mix
the subcarrier down, common/dsp/demod/pm_to_bpsk.cpp) -> RRC -> Costas(2)
-> M&M clock recovery -> int8 x50 real softs. The AGC, PLL, Costas and M&M
recurrences run on the hand kernels of ops/cuda/{sample_walk,mm_clock}.py,
the chain on `torch_device` (default ``cuda``) with its state kept there.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import costas, fir, firdes, stages
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.modules.demod.base import BaseDemodModule
from satdump_tpu_torch.utils.device import to_numpy


@register_module
class PMDemodModule(BaseDemodModule):
    id = "pm_demod"

    MAX_SPS = 10.0  # ref: do NOT resample unless really necessary

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.pll_bw = float(self.param("pll_bw", required=True))
        self.pll_max_offset = float(self.param("pll_max_offset", 0.5))
        self.rrc_alpha = float(self.param("rrc_alpha", required=True))
        self.rrc_taps = int(self.param("rrc_taps", 31))
        self.costas_bw = float(self.param("costas_bw", 0.004))
        self.read_clock_params()
        self.subcarrier_offset = float(self.param("subcarrier_offset", 0))
        self.block_base = int(self.param("buffer_size", 0) or (1 << 18))

    def _build(self):
        self.compute_rates()
        self.block_size = self.choose_block_size(self.block_base)
        dev = self.torch_device
        self._rrc = firdes.root_raised_cosine(
            1.0, self.final_samplerate, self.d_symbolrate, self.rrc_alpha,
            self.rrc_taps)
        sub_rate = self.subcarrier_offset or self.d_symbolrate
        self._sub_delta = 2 * np.pi * sub_rate / self.final_samplerate
        self.init_input_stages()
        self.init_clock()
        self._agc_state = stages.agc_init(device=dev)
        self._pll_state = costas.pll_init(dev)
        self._sub_state = stages.freq_shift_init(dev)
        self._fir_state = fir.fir_init(len(self._rrc), device=dev)
        self._cs_state = costas.costas_init(dev)

    def stream_start(self) -> None:
        self._build()
        self._nsyms = 0
        self._snr = -100.0
        self._peak_snr = -100.0
        logger.info(f"PM demod; samplerate {self.d_samplerate} -> "
                    f"{self.final_samplerate} (sps {self.final_sps:.2f}); "
                    f"device {self.torch_device}")

    def stream_work(self, samples: np.ndarray, valid: int | None = None,
                    last: bool = False) -> np.ndarray:
        x = self.input_stages(self.to_device(samples), self.d_dc_block)
        self._agc_state, x = stages.agc_scan(self._agc_state, x,
                                             rate=self.d_agc_rate)
        self._pll_state, x = costas.pll_carrier_scan(
            self._pll_state, x, self.pll_bw, max_offset=self.pll_max_offset)
        # PM -> BPSK: keep the quadrature (phase) arm, mix the BPSK
        # subcarrier at sub_rate down to baseband (pm_to_bpsk.cpp)
        x = torch.complex(torch.zeros_like(x.imag), x.imag)
        self._sub_state, x = stages.freq_shift(self._sub_state, x,
                                               self._sub_delta)
        self._fir_state, x = fir.fir_apply(self._fir_state, x, self._rrc)
        self._cs_state, x = costas.costas_scan(self._cs_state, x,
                                               self.costas_bw, 2)
        syms, vmask = self.clock(x)
        s = self.keep_valid(syms, vmask, valid, last)
        self._snr = float(stages.snr_m2m4(syms))
        self._peak_snr = max(self._peak_snr, self._snr)
        self._nsyms += len(s)
        self.stats = {"snr": self._snr, "peak_snr": self._peak_snr,
                      "symbols": self._nsyms}
        return to_numpy(stages.bpsk_soft(s, 50.0))
