"""DVB-S2 demodulator module: baseband -> .bbframe — port of
satdump_tpu/pipeline/modules/dvbs2/demod.py.

Reference: plugins/dvb_support/dvbs2/module_dvbs2_demod.{h,cpp} — its chain
is AGC -> RRC -> freq shift -> PL sync (own thread) -> pilot PLL -> clock
recovery -> per-frame soft demap -> LDPC (repeated trials) -> BCH (optional
own thread) -> BBFrame out. Parameter surface matches (symbolrate, rrc_alpha,
modcod, shortframes, pilots, ldpc_trials/iters...).

The front end runs block by block on `torch_device` (default ``cuda``):
[freq_shift] -> [dc_block] -> [rational resample to 2 sps] -> AGC (the
walker kernel agc_walk on the card) -> RRC -> feedforward O&M timing and
symbol pick (ops/ffsync.py), its state carried from block to block. The
valid symbols of a block go to the host, where the PL layer
(ops/dvbs2/rx.DVBS2Demod) finds PLFRAMEs by differential correlation and
recovers each frame's CFO and phase; the soft demap and LDPC run on the
same device, BCH on the host. `pll_bw` and `freq_prop_factor` are
accepted and unused, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import ffsync, fir, firdes, stages
from satdump_tpu_torch.ops.dvbs2.rx import DVBS2Demod
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.modules.demod.base import BaseDemodModule
from satdump_tpu_torch.utils.device import to_numpy


@register_module
class DVBS2DemodModule(BaseDemodModule):
    id = "dvbs2_demod"

    # DVB-S2 front end resamples to exactly 2 samples/symbol
    MIN_SPS = 2.0
    MAX_SPS = 2.0

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.rrc_alpha = float(self.param("rrc_alpha", required=True))
        self.rrc_taps = int(self.param("rrc_taps", 31))
        self.modcod = int(self.param("modcod", required=True))
        self.shortframes = bool(self.param("shortframes", False))
        self.pilots = bool(self.param("pilots", False))
        self.ldpc_iters = int(self.param("ldpc_iters", 0) or
                              10 * int(self.param("ldpc_trials", 3)))
        self.block_base = int(self.param("buffer_size", 0) or (1 << 18))

    def _build(self):
        self.compute_rates()
        self.block_size = self.choose_block_size(self.block_base)
        dev = self.torch_device
        self._rrc = firdes.root_raised_cosine(
            1.0, self.final_samplerate, self.d_symbolrate, self.rrc_alpha,
            self.rrc_taps)
        self._bank = torch.as_tensor(firdes.mm_interpolator_bank(),
                                     device=dev)
        out_n = self.init_input_stages()
        self._ff_cap = int(np.ceil(out_n / (self.final_sps * 0.99))) + 2
        self._agc_state = stages.agc_init(device=dev)
        self._fir_state = fir.fir_init(len(self._rrc), device=dev)
        self._ck_state = ffsync.ff_clock_init(device=dev)

    def front_end(self, x: torch.Tensor):
        """One block on the device: (symbols (ff_cap,), valid mask).
        Timing only: carrier recovery belongs to the PL layer
        (header/pilot-anchored, per frame)."""
        x = self.input_stages(x, self.d_dc_block)
        self._agc_state, x = stages.agc_scan(self._agc_state, x,
                                             rate=self.d_agc_rate)
        self._fir_state, x = fir.fir_apply(self._fir_state, x, self._rrc)
        self._ck_state, syms, valid = ffsync.ff_clock_recovery(
            self._ck_state, x, sps=self.final_sps, bank=self._bank,
            out_cap=self._ff_cap)
        return syms, valid

    def process(self):
        self._build()
        out_path = self.d_output_file_hint + ".bbframe"
        self.d_output_file = out_path
        reader = self.open_input(self.block_size)
        dem = DVBS2Demod(self.modcod, self.shortframes, self.pilots,
                         ldpc_iters=self.ldpc_iters,
                         device=self.torch_device)
        logger.info(f"DVB-S2 MODCOD {self.modcod} "
                    f"({dem.cfg.constellation} {dem.cfg.rate} "
                    f"{'short' if self.shortframes else 'normal'}"
                    f"{' +pilots' if self.pilots else ''}); "
                    f"samplerate {self.d_samplerate} -> "
                    f"{self.final_samplerate} (sps {self.final_sps:.2f}); "
                    f"device {self.torch_device}")
        nframes = 0
        with open(out_path, "wb") as f:
            for blk in reader.blocks():
                syms, valid = self.front_end(self.to_device(blk.samples))
                s = to_numpy(self.keep_valid(syms, valid, blk.valid,
                                             blk.last))
                frames = dem.process(s)
                if frames.shape[0]:
                    f.write(frames.tobytes())
                    nframes += frames.shape[0]
        self.stats = dict(dem.stats)
        self.stats["bbframes"] = nframes
        logger.info(f"Decoded {nframes} BBFrames "
                    f"(LDPC ok {dem.stats['ldpc_ok']}/{dem.stats['frames']}, "
                    f"BCH ok {dem.stats['bch_ok']})")
