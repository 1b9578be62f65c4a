"""VFO splitter/channelizer: one wideband stream -> N narrowband DDCs —
port of satdump_tpu/ops/vfo.py.

Reference: common/dsp/path/splitter_vfo.h (the recorder/autotrack per-VFO
DDC: copy + freq shift + resample per VFO, each on its own thread). Here
each VFO is a freq_shift then a decimating overlap-save FIR with carried
state, plain torch ops on `device` (the JAX package leaves both to XLA);
every VFO runs from the same host loop on the one copy of the wideband
block put on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from satdump_tpu_torch.ops import fir, firdes, stages
from satdump_tpu_torch.utils.device import resolve_device, to_numpy


@dataclass
class VFO:
    name: str
    freq_offset: float        # Hz from stream center
    decim: int
    taps: np.ndarray          # float32 low-pass
    delta: float              # rad/sample of the shift to baseband
    state: tuple              # (FreqShiftState, FIRState)


class VFOChannelizer:
    def __init__(self, samplerate: float, block_size: int = 1 << 18,
                 device: str | torch.device | None = None):
        self.samplerate = samplerate
        self.block_size = block_size
        self.device = resolve_device(device)
        self.vfos: Dict[str, VFO] = {}
        self.blocks = 0
        self.host_s = 0.0         # wall of `work`, copies both ways included

    def add_vfo(self, name: str, freq_offset: float, out_samplerate: float
                ) -> float:
        """Add a DDC; out rate is samplerate/decim for the nearest integer
        decimation. Returns the actual output samplerate."""
        decim = max(int(round(self.samplerate / out_samplerate)), 1)
        # fixed shapes: snap decim down to a divisor of the block
        while self.block_size % decim:
            decim -= 1
        actual = self.samplerate / decim
        taps = firdes.low_pass(1.0, self.samplerate, actual * 0.4,
                               actual * 0.2).astype(np.float32)
        delta = 2 * np.pi * freq_offset / self.samplerate
        self.vfos[name] = VFO(name, freq_offset, decim, taps, delta,
                              (stages.freq_shift_init(self.device),
                               fir.fir_init(len(taps), device=self.device)))
        return actual

    def del_vfo(self, name: str) -> None:
        self.vfos.pop(name, None)

    def work(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        """One block (block_size samples) -> per-VFO decimated baseband."""
        t = time.perf_counter()
        xd = torch.from_numpy(np.ascontiguousarray(x, np.complex64)
                              ).to(self.device)
        out = {}
        for name, vfo in self.vfos.items():
            fs_st, fir_st = vfo.state
            fs_st, y = stages.freq_shift(fs_st, xd, -vfo.delta)
            fir_st, y = fir.decimating_fir_apply(fir_st, y, vfo.taps,
                                                 vfo.decim)
            vfo.state = (fs_st, fir_st)
            out[name] = to_numpy(y.contiguous())
        self.blocks += 1
        self.host_s += time.perf_counter() - t
        return out

    @property
    def stats(self) -> dict:
        return {"blocks": self.blocks, "host_s": self.host_s}
