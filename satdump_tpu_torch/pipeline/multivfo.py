"""Multi-VFO live: N simultaneous per-VFO live pipelines from ONE stream —
port of satdump_tpu/pipeline/multivfo.py.

The reference's recorder attaches live pipelines and recorders to VFOs
split off the SDR stream (src-interface/recorder/recorder.h:174-178
add_vfo_live/add_vfo_reco, backed by the splitter/VFO DSP path). Here the
channelizer (ops/vfo.py: freq shift + decimating FIR DDCs on `device`)
feeds one LivePipeline per VFO; each VFO can also be recorded raw.

    mv = MultiVFOLive(samplerate=2.4e6, output_dir="out",
                      user_params={"torch_device": "cuda"})
    mv.add_vfo("noaa", -120e3, pipeline, {"symbolrate": 72e3})
    mv.add_vfo("meteor", 300e3, pipeline2, {"symbolrate": 72e3})
    for blk in source:
        mv.push(blk)
    outs = mv.stop()
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io.baseband import BasebandWriter
from satdump_tpu_torch.ops.vfo import VFOChannelizer
from satdump_tpu_torch.pipeline.live import LivePipeline
from satdump_tpu_torch.pipeline.pipeline import Pipeline


class MultiVFOLive:
    def __init__(self, samplerate: float, output_dir: str,
                 block_size: int = 1 << 18,
                 user_params: Optional[dict] = None):
        """`user_params` are every VFO pipeline's defaults; their
        `torch_device` (default cuda) places the channelizer as well."""
        self.samplerate = samplerate
        self.out_dir = Path(output_dir)
        self.user_params = dict(user_params or {})
        self.chan = VFOChannelizer(
            samplerate, block_size,
            self.user_params.get("torch_device", "cuda"))
        self.block_size = block_size
        self.pipes: Dict[str, LivePipeline] = {}
        self.recorders: Dict[str, BasebandWriter] = {}
        self._buf = np.zeros(0, np.complex64)

    def add_vfo(self, name: str, freq_offset: float, pipeline: Pipeline,
                user_params: Optional[dict] = None,
                vfo_samplerate: Optional[float] = None) -> float:
        """Attach a live pipeline to a new VFO (ref add_vfo_live). The DDC
        output rate defaults to ~2.4x the pipeline's symbolrate (nearest
        integer decimation); returns the actual VFO samplerate."""
        params = dict(self.user_params, **(user_params or {}))
        if vfo_samplerate is None:
            sr = float(params.get("symbolrate", 0) or 0)
            if not sr:
                for st in pipeline.steps:
                    sr = float(st.parameters.get("symbolrate", 0) or sr)
            vfo_samplerate = sr * 2.4 if sr else self.samplerate
        actual = self.chan.add_vfo(name, freq_offset, vfo_samplerate)
        params["samplerate"] = actual
        lp = LivePipeline(pipeline, str(self.out_dir / name),
                          user_params=params)
        lp.start()
        self.pipes[name] = lp
        logger.info(f"VFO '{name}' @ {freq_offset:+.0f} Hz -> "
                    f"{pipeline.id} ({actual:.0f} sps)")
        return actual

    def add_vfo_recorder(self, name: str, freq_offset: float,
                         vfo_samplerate: float, fmt: str = "cf32") -> float:
        """Attach a raw baseband recorder to a new VFO (ref add_vfo_reco)."""
        actual = self.chan.add_vfo(name, freq_offset, vfo_samplerate)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.recorders[name] = BasebandWriter(
            self.out_dir / f"{name}.{fmt}", fmt, actual)
        return actual

    def del_vfo(self, name: str) -> None:
        self.chan.del_vfo(name)
        lp = self.pipes.pop(name, None)
        if lp is not None:
            lp.stop()
        rec = self.recorders.pop(name, None)
        if rec is not None:
            rec.close()

    def _fan_out(self, outs: Dict[str, np.ndarray]) -> None:
        for name, y in outs.items():
            if name in self.pipes:
                self.pipes[name].push(y)
            if name in self.recorders:
                self.recorders[name].write(y)

    def push(self, samples: np.ndarray) -> None:
        """Feed wideband samples; each full channelizer block fans out to
        every VFO's pipeline/recorder."""
        buf = np.concatenate([self._buf, np.asarray(samples, np.complex64)])
        while len(buf) >= self.block_size:
            self._fan_out(self.chan.work(buf[: self.block_size]))
            buf = buf[self.block_size:]
        self._buf = buf

    def stop(self) -> Dict[str, List[str]]:
        """Drain the tail and stop every VFO pipeline. Returns per-VFO
        output file lists."""
        buf = self._buf
        if len(buf):
            pad = np.zeros(self.block_size - len(buf), np.complex64)
            outs = self.chan.work(np.concatenate([buf, pad]))
            self._fan_out({name: y[: int(np.ceil(len(buf) /
                                                 self.chan.vfos[name].decim))]
                           for name, y in outs.items()})
        self._buf = np.zeros(0, np.complex64)
        result = {}
        for name, lp in self.pipes.items():
            result[name] = lp.stop()
        for name, rec in self.recorders.items():
            rec.close()
            result.setdefault(name, [])
        return result

    @property
    def stats(self) -> dict:
        return {name: lp.stats for name, lp in self.pipes.items()}
