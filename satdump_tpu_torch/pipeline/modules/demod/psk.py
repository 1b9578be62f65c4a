"""PSK demodulator module: baseband -> .soft int8 symbols — port of
satdump_tpu/pipeline/modules/demod/psk.py, feedforward (`fast`) path only.

Reference: src-core/pipeline/modules/demod/module_psk_demod.cpp. Per block:
AGC -> RRC -> carrier (FFT of x^M + V&V) -> [OQPSK delay] -> O&M timing +
polyphase symbol pick (ops/ffsync.py) -> int8 quantize (x50 real-only for
BPSK, x100 interleaved IQ otherwise, module_psk_demod.cpp:196-213).

The chain runs on `torch_device` (default ``cuda``). Options of the
reference that the port does not carry yet raise a PipelineError saying
so: `fast: false` (the classic Costas/M&M scan chain), `multichip`,
`freq_shift`, `dc_block`, input resampling and Doppler correction.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import ffsync, firdes
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
            ("freq_shift", self.d_frequency_shift != 0),
            ("dc_block", self.d_dc_block),
        ) if on]
        if unported:
            raise PipelineError(f"{self.id}: {', '.join(unported)} not yet "
                                "ported to satdump_tpu_torch")
        # Doppler pre-correction provider (set by the live/autotrack layer
        # in the reference); not yet ported, so it must stay None
        self.doppler_provider = None

    def _build(self):
        if self.doppler_provider is not None:
            raise PipelineError(f"{self.id}: Doppler correction not yet "
                                "ported to satdump_tpu_torch")
        self.compute_rates()
        self.block_size = self.choose_block_size(self.block_base)
        dev = self.torch_device
        self._order = _ORDER[self.constellation]
        self._rrc = firdes.root_raised_cosine(
            1.0, self.final_samplerate, self.d_symbolrate, self.rrc_alpha,
            self.rrc_taps)
        self._bank = torch.as_tensor(firdes.mm_interpolator_bank(),
                                     device=dev)
        self._ff_cap = int(np.ceil(self.block_size / (self.final_sps * 0.99))) + 2
        self._state = ffsync.ff_clock_init(rrc_ntaps=len(self._rrc),
                                           device=dev)

    # -- streaming interface ------------------------------------------------
    def stream_start(self) -> None:
        self._build()
        self._nsyms = 0
        self._peak_snr = -100.0
        self._snr = -100.0
        logger.info(f"Constellation: {self.constellation}; samplerate "
                    f"{self.d_samplerate} (sps {self.final_sps:.2f}); block "
                    f"{self.block_size}; device {self.torch_device}")

    def stream_work(self, samples: np.ndarray, valid: int | None = None,
                    last: bool = False) -> np.ndarray:
        """One fixed-size complex64 block (pad the tail with zeros) ->
        int8 soft symbols."""
        x = torch.from_numpy(np.ascontiguousarray(samples, np.complex64)
                             ).to(self.torch_device)
        self._state, syms, vmask, snr = ffsync.ff_psk_demod_block(
            self._state, x, order=self._order, sps=self.final_sps,
            rrc_taps=self._rrc, bank=self._bank, out_cap=self._ff_cap,
            oqpsk=self.is_oqpsk)
        s = to_numpy(syms[vmask])
        if last and valid is not None and valid < self.block_size:
            # padded tail: drop symbols sourced from the zero padding
            keep = int(len(s) * valid / self.block_size) + 2
            s = s[:min(keep, len(s))]
        self._snr = float(snr)
        self._peak_snr = max(self._peak_snr, self._snr)
        if self.is_bpsk:
            out = np.clip(s.real * 50.0, -127, 127).astype(np.int8)
        else:
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
