"""FSK and SDPSK demodulator modules: baseband -> .soft (real int8) — port
of satdump_tpu/pipeline/modules/demod/fsk.py.

Reference: src-core/pipeline/modules/demod/module_fsk_demod.cpp — chain:
[freq_shift] -> [resample] -> AGC -> quadrature demod -> DC block -> AGC2
-> RRC (or a boxcar when basic_shaping) -> M&M clock recovery (real) ->
int8 x50. The AGCs and M&M run on the hand kernels of
ops/cuda/{sample_walk,mm_clock}.py, the chain on `torch_device` (default
``cuda``) with its state kept there.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import fir, firdes, stages
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.modules.demod.base import BaseDemodModule
from satdump_tpu_torch.utils.device import to_numpy


@register_module
class FSKDemodModule(BaseDemodModule):
    id = "fsk_demod"

    MAX_SPS = 8.0
    OUT_SCALE = 50.0
    USE_AGC2 = True

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.rrc_alpha = float(self.param("rrc_alpha", 0.5))
        self.rrc_taps = int(self.param("rrc_taps", 31))
        self.basic_shaping = bool(self.param("basic_shaping", False))
        self.read_clock_params()
        self.block_base = int(self.param("buffer_size", 0) or (1 << 18))

    def _build(self):
        self.compute_rates()
        self.block_size = self.choose_block_size(self.block_base)
        dev = self.torch_device
        if self.basic_shaping:
            self._taps = np.full(max(int(self.final_sps), 1), 0.1, np.float32)
        else:
            self._taps = firdes.root_raised_cosine(
                1.0, self.final_samplerate, self.d_symbolrate,
                self.rrc_alpha, self.rrc_taps)
        self.init_input_stages()
        self.init_clock()
        self._agc_state = stages.agc_init(device=dev)
        self._qd_state = stages.quadrature_demod_init(dev)
        self._fdc_state = stages.dc_block_init(device=dev)
        self._agc2_state = stages.agc_init(device=dev)
        self._fir_state = fir.fir_init(len(self._taps), device=dev)

    def stream_start(self) -> None:
        self._build()
        self._nsyms = 0
        logger.info(f"{self.id}; samplerate {self.d_samplerate} -> "
                    f"{self.final_samplerate} (sps {self.final_sps:.2f}); "
                    f"device {self.torch_device}")

    def stream_work(self, samples: np.ndarray, valid: int | None = None,
                    last: bool = False) -> np.ndarray:
        # the reference's FSK chain has no DC block before the resampler
        x = self.input_stages(self.to_device(samples), False)
        self._agc_state, x = stages.agc_scan(self._agc_state, x,
                                             rate=self.d_agc_rate)
        self._qd_state, f = stages.quadrature_demod(self._qd_state, x, 1.0)
        fc = f.to(torch.complex64)
        self._fdc_state, fc = stages.dc_block(self._fdc_state, fc, alpha=1e-3)
        if self.USE_AGC2:
            self._agc2_state, fc = stages.agc_scan(self._agc2_state, fc,
                                                   rate=0.1)
        self._fir_state, fc = fir.fir_apply(self._fir_state, fc, self._taps)
        syms, vmask = self.clock(fc, complex_mode=False)
        s = self.keep_valid(syms, vmask, valid, last)
        self._nsyms += len(s)
        self.stats = {"symbols": self._nsyms}
        return to_numpy(stages.to_soft_int8(s.real, self.OUT_SCALE))


@register_module
class SDPSKDemodModule(FSKDemodModule):
    """SDPSK: quadrature demod -> DC block -> RRC -> M&M on the real
    frequency signal, x400 soft scale (module_sdpsk_demod.cpp:60-122).
    SDPSK's +-pi/2-per-symbol phase steps make the discriminator output a
    binary waveform, so the FSK chain applies verbatim minus its second AGC.
    """

    id = "sdpsk_demod"
    OUT_SCALE = 400.0
    USE_AGC2 = False
