"""PSK demodulator module: baseband -> .soft int8 symbols — port of
satdump_tpu/pipeline/modules/demod/psk.py.

Reference: src-core/pipeline/modules/demod/module_psk_demod.cpp. Two chains
per block, after the input stages [freq_shift] -> [dc_block] -> [rational
resample to the final rate]:
* `fast` (the default): [Doppler pre-correction first] -> AGC -> RRC ->
  carrier (FFT of x^M + V&V) -> [OQPSK delay] -> O&M timing + polyphase
  symbol pick (ops/ffsync.py);
* `fast: false`, the classic per-sample chain: AGC -> RRC -> Costas (order
  2/4/8) -> [post-Costas DC block] -> [OQPSK delay] -> M&M clock recovery,
  its recurrences on the hand kernels of ops/cuda/{sample_walk,mm_clock}.py;
then int8 quantize (x50 real-only for BPSK, x100 interleaved IQ otherwise,
module_psk_demod.cpp:196-213).

The chain runs on `torch_device` (default ``cuda``). `multichip: true`
shards the whole recording's consecutive time-blocks over a (1 × n) mesh of
ranks (parallel/timeshard.py: halo exchange and seam phase stitching over
torch.distributed) when the chain is `fast`, there is more than one device
(`parallel.device_count`, which `parallel.set_virtual_devices` can raise),
no input resampling, no frequency shift, and the constellation is not
BPSK; otherwise, as the reference, it logs and runs on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io.baseband import read_baseband
from satdump_tpu_torch.ops import costas, ffsync, fir, firdes, stages
from satdump_tpu_torch.parallel import timeshard
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
        self.post_costas_dc = bool(self.param("post_costas_dc", False))
        self.read_clock_params()
        self.is_bpsk = self.constellation == "bpsk"
        self.is_oqpsk = self.constellation == "oqpsk"
        if self.is_oqpsk:
            self.MIN_SPS, self.MAX_SPS = 1.6, 2.4
        self.block_base = int(self.param("buffer_size", 0) or (1 << 18))
        # `fast` selects the feedforward sync chain (the default); `fast:
        # false` the classic per-sample Costas/M&M chain
        self.fast = bool(self.param("fast", True))
        # `multichip: true` shards consecutive time-blocks of the stream
        # over ranks (parallel/timeshard.py); needs fast + >1 device
        self.multichip = bool(self.param("multichip", False))
        # Doppler pre-correction (ref module_demod_base.h doppler option +
        # doppler_correct.h): a provider fn(sample_pos, n) -> Hz (a scalar
        # or one value a sample), set by a live/autotrack layer and mixed
        # out on the device before the fast chain (the classic chain, as
        # the reference's, does not read it)
        self.doppler_provider = None

    def _build(self):
        self.compute_rates()
        self.block_size = self.choose_block_size(self.block_base)
        dev = self.torch_device
        self._order = _ORDER[self.constellation]
        self._rrc = firdes.root_raised_cosine(
            1.0, self.final_samplerate, self.d_symbolrate, self.rrc_alpha,
            self.rrc_taps)
        out_n = self.init_input_stages()
        if self.fast:
            # the host bank; its device tables are uploaded here, once
            self._bank = firdes.mm_interpolator_bank()
            ffsync.interp_tables(self._bank, self.final_sps, dev)
            self._ff_cap = int(np.ceil(out_n / (self.final_sps * 0.99))) + 2
            self._state = ffsync.ff_clock_init(rrc_ntaps=len(self._rrc),
                                               device=dev)
            self._dp_state = stages.freq_shift_init(dev)
            self._sample_pos = 0
            return
        self.init_clock()
        self._agc_state = stages.agc_init(device=dev)
        self._fir_state = fir.fir_init(len(self._rrc), device=dev)
        self._cs_state = costas.costas_init(dev)
        self._pdc_state = stages.dc_block_init(device=dev)
        self._dly_state = stages.delay_one_imag_init(dev)

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

    def _fast_block(self, x: torch.Tensor):
        dop = self._doppler_block()
        if dop is not None:
            self._dp_state, x = stages.doppler_correct(
                self._dp_state, x, dop, self.d_samplerate)
        x = self.input_stages(x, self.d_dc_block)
        self._state, syms, vmask, snr = ffsync.ff_psk_demod_block(
            self._state, x, order=self._order, sps=self.final_sps,
            rrc_taps=self._rrc, bank=self._bank, out_cap=self._ff_cap,
            oqpsk=self.is_oqpsk)
        return syms, vmask, snr

    def _classic_block(self, x: torch.Tensor):
        """The reference's classic chain (satdump_tpu/pipeline/modules/
        demod/psk.py:197-218)."""
        x = self.input_stages(x, self.d_dc_block)
        self._agc_state, x = stages.agc_scan(self._agc_state, x,
                                             rate=self.d_agc_rate)
        self._fir_state, x = fir.fir_apply(self._fir_state, x, self._rrc)
        self._cs_state, x = costas.costas_scan(self._cs_state, x,
                                               self.loop_bw, self._order)
        if self.post_costas_dc:
            self._pdc_state, x = stages.dc_block(self._pdc_state, x,
                                                 alpha=1e-4)
        if self.is_oqpsk:
            self._dly_state, x = stages.delay_one_imag(self._dly_state, x)
        syms, vmask = self.clock(x)
        return syms, vmask, stages.snr_m2m4(syms)

    # -- streaming interface ------------------------------------------------
    def stream_start(self) -> None:
        self._build()
        self._nsyms = 0
        self._peak_snr = -100.0
        self._snr = -100.0
        logger.info(f"Constellation: {self.constellation}; samplerate "
                    f"{self.d_samplerate} -> {self.final_samplerate} (sps "
                    f"{self.final_sps:.2f}); block {self.block_size}; "
                    f"{'feedforward' if self.fast else 'classic'} chain; "
                    f"device {self.torch_device}")

    def stream_work(self, samples: np.ndarray, valid: int | None = None,
                    last: bool = False) -> np.ndarray:
        """One fixed-size complex64 block (pad the tail with zeros) ->
        int8 soft symbols: the span `psk_demod.block`, holding one span
        for each of its parts and for each wait on the card."""
        with trace.span("psk_demod.block"):
            with trace.span("psk_demod.to_device", "wait"):
                x = self.to_device(samples)
            with trace.span("psk_demod.chain"):
                syms, vmask, snr = (self._fast_block if self.fast
                                    else self._classic_block)(x)
            with trace.span("psk_demod.pick", "wait"):
                s = self.keep_valid(syms, vmask, valid, last)
            with trace.span("psk_demod.snr", "wait"):
                self._snr = float(snr)
            self._peak_snr = max(self._peak_snr, self._snr)
            if self.is_bpsk:
                soft = stages.bpsk_soft(s, 50.0)
                with trace.span("psk_demod.to_host", "wait"):
                    out = to_numpy(soft)
            else:
                with trace.span("psk_demod.to_host", "wait"):
                    s = to_numpy(s)
                with trace.span("psk_demod.quantize", "host"):
                    out = np.empty(2 * len(s), np.int8)
                    out[0::2] = np.clip(s.real * 100.0, -127,
                                        127).astype(np.int8)
                    out[1::2] = np.clip(s.imag * 100.0, -127,
                                        127).astype(np.int8)
        self._nsyms += len(s)
        self.stats = {"snr": self._snr, "peak_snr": self._peak_snr,
                      "symbols": self._nsyms}
        return out

    # -- multichip: time-sharded demod over ranks -------------------------
    def _build_multichip(self) -> bool:
        if not self.fast or timeshard.device_count(self.torch_device) < 2 \
                or self.resample or self.d_frequency_shift or self.is_bpsk:
            return False
        self._mesh = timeshard.make_mesh(n_ch=1, device=self.torch_device)
        self._n_t = self._mesh.n_t
        return True

    def _process_multichip(self):
        out_path = self.d_output_file_hint + ".soft"
        self.d_output_file = out_path
        data, _ = read_baseband(self.d_input_file, self.d_format)
        # one sharded step over the whole recording: the seam stitching
        # keeps every shard's rotation consistent with shard 0. +64 samples
        # of margin: the interpolator emits no symbol within ntaps/2 of the
        # last sample, so a recording that divides exactly into shards
        # would lose its last symbols without trailing zeros.
        block = -(-(len(data) + 64) // (self._n_t * 4096)) * 4096
        halo = min(8192, block // 4)
        super_n = self._n_t * block
        logger.info(f"multichip: mesh(t={self._n_t}), shard block {block}, "
                    f"halo {halo}")
        chunk = np.concatenate(
            [data, np.zeros(super_n - len(data), np.complex64)]) \
            if len(data) < super_n else data[:super_n]
        res = timeshard.run_sharded(
            chunk.reshape(1, super_n), self._mesh, self.torch_device,
            sps=self.final_sps, block=block, halo=halo,
            rrc_alpha=self.rrc_alpha, rrc_ntaps=self.rrc_taps,
            order=_ORDER[self.constellation])
        nsyms = 0
        with open(out_path, "wb") as f:
            for t in range(self._n_t):
                s = res.soft[t, 0].reshape(-1, 2)[res.valid[t, 0]]
                f.write(s.astype(np.int8).tobytes())
                nsyms += len(s)
        self.stats = {"symbols": nsyms, "mesh_t": self._n_t,
                      "sharded": res.stats}
        logger.info(f"multichip demodulated {nsyms} symbols "
                    f"over {self._n_t} t-shards")

    def process(self):
        if self.multichip:
            self.compute_rates()
            self.block_size = self.choose_block_size(self.block_base)
            if self._build_multichip():
                return self._process_multichip()
            logger.warning("multichip requested but unavailable "
                           "(need fast + >1 device + no resample); "
                           "falling back to single-device path")
        super().process()
        logger.info(f"SNR {self._snr:.1f} dB")
