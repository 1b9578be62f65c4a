"""Live pipeline: streaming IQ source -> chained modules, host-driven —
port of satdump_tpu/pipeline/live.py.

Reference: src-core/pipeline/live_pipeline.cpp:45-110 — module 0 gets the
DSP stream, the rest chain through ring-buffer FIFOs, each process() on a
pool thread. Here the chain runs block-synchronously on the host loop: the
demod's fixed block size sets the cadence and the source buffers into it.
The modules run on their `torch_device` (default ``cuda``; pass
``torch_device: cpu`` in the user parameters for the CPU); the /status
spectrum tap is host NumPy, as in the JAX package.

Modules participate by exposing the streaming interface:
    stream_start()
    stream_work(chunk, ...) -> output array / frames written

When the stream ends on a block boundary no block goes through with
last=True, as in the JAX class; the decoders then lose no whole frame (a
frame is held back at a seam only while it is incomplete).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.ops.cuda import launch_counts
from satdump_tpu_torch.pipeline.module import (module_registry,
                                               register_all_modules)
from satdump_tpu_torch.pipeline.pipeline import Pipeline

# the parts of a block's host time that `times` accumulates (seconds),
# each the span `live.<part>`
TIMED_PARTS = ("rebuffer", "fft_tap", "demod", "decoder", "soft_write")


class LivePipeline:
    """Streams complex64 blocks through pipeline steps `live_cfg` (defaults
    to every step after baseband)."""

    def __init__(self, pipeline: Pipeline, output_dir: str,
                 user_params: Optional[dict] = None):
        self.pipeline = pipeline
        self.out_dir = Path(output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        idxs = pipeline.live_cfg or list(range(1, len(pipeline.steps)))
        self.steps = [pipeline.steps[i] for i in idxs
                      if i < len(pipeline.steps)]
        if not self.steps:
            raise PipelineError(f"pipeline {pipeline.id} has no live steps")
        register_all_modules()
        self.modules = []
        hint = str(self.out_dir / pipeline.id)
        for st in self.steps:
            cls = module_registry.get(st.module_id)
            params = pipeline.prepare_parameters(st, user_params or {})
            self.modules.append(cls("", hint, params))
        self.stats: dict = {}

    def set_doppler(self, tracker, frequency_hz: float,
                    samplerate: float, t0: Optional[float] = None) -> None:
        """Install tracker-driven Doppler pre-correction on the demod
        (ref module_demod_base.h doppler option): the provider maps the
        absolute sample position to the predicted shift through the SGP4
        tracker (tracking/tracker.py doppler_shift). Call before start()."""
        start_t = time.time() if t0 is None else t0

        def provider(pos: int, n: int) -> np.ndarray:
            # one prediction per 4096 samples, linearly interpolated —
            # Doppler varies at ~Hz/s, far below this granularity
            step = 4096
            tpts = start_t + (pos + np.arange(0, n + step, step)) / samplerate
            d = np.asarray([tracker.doppler_shift(t, frequency_hz)
                            for t in tpts], np.float64)
            x = np.arange(0, n + step, step)
            return np.interp(np.arange(n), x, d).astype(np.float32)

        if hasattr(self.modules[0], "doppler_provider"):
            self.modules[0].doppler_provider = provider

    def start(self) -> None:
        demod = self.modules[0]
        if not hasattr(demod, "stream_start") or \
                not hasattr(demod, "stream_work"):
            raise PipelineError(
                f"module {self.steps[0].module_id} has no streaming interface")
        demod.stream_start()
        self.block_size = demod.block_size
        # downstream decoder modules write their level files as they go
        for st, mod in zip(self.steps[1:], self.modules[1:]):
            if not hasattr(mod, "stream_work"):
                raise PipelineError(
                    f"module {st.module_id} has no streaming interface")
            mod.stream_start()
        # soft tap + decoder outputs
        self._soft_f = open(str(self.out_dir / f"{self.pipeline.id}.soft"),
                            "wb")
        self._dec_f = [
            open(str(self.out_dir / f"{self.pipeline.id}{_ext(st.level)}"),
                 "wb")
            for st in self.steps[1:]]
        self._buf = np.zeros(0, np.complex64)
        self._t0 = time.time()
        self._nsamples = 0
        self._fft_avg = None
        self.blocks = 0
        self.times = dict.fromkeys(TIMED_PARTS, 0.0)
        self._laps = trace.Laps(self.times, "live.")
        # kernel launches of this pipeline's blocks, by wrapper
        self.launches = dict.fromkeys(launch_counts(), 0)

    def push(self, samples: np.ndarray, last: bool = False) -> None:
        """Feed source samples; runs the chain on every full block. Each
        part of a block's host time is a span `live.<part>`."""
        lap = self._laps.lap
        lap("rebuffer")
        try:
            self._buf = np.concatenate(
                [self._buf, np.asarray(samples, np.complex64)])
            self._nsamples += len(samples)
            while len(self._buf) >= self.block_size or \
                    (last and len(self._buf)):
                blk = self._buf[: self.block_size]
                self._buf = self._buf[self.block_size:]
                valid = len(blk)
                if valid < self.block_size:
                    blk = np.concatenate(
                        [blk, np.zeros(self.block_size - valid,
                                       np.complex64)])
                is_last = last and len(self._buf) == 0
                lap("fft_tap")
                counts = launch_counts()
                self._fft_tap(blk)
                lap("demod")
                out = self.modules[0].stream_work(blk, valid=valid,
                                                  last=is_last)
                lap("soft_write")
                self._soft_f.write(out.tobytes())
                # only the first decoder is fed: chained decoders past it
                # read from files (the reference's demod + decoder fusion,
                # live_pipeline.cpp); the later steps' files stay empty
                if len(self.modules) > 1:
                    lap("decoder")
                    self.modules[1].stream_work(out, self._dec_f[0],
                                                last=is_last)
                lap()
                for k, v in launch_counts().items():
                    self.launches[k] += v - counts[k]
                self.blocks += 1
                self._update_stats()
                lap("rebuffer")
                if is_last:
                    break
        finally:
            lap()

    def _update_stats(self) -> None:
        self.stats = {
            "samples": self._nsamples,
            "uptime_s": round(time.time() - self._t0, 1),
            "modules": {st.module_id: mod.getModuleStats()
                        for st, mod in zip(self.steps, self.modules)},
            "blocks": self.blocks,
            "host_s": dict(self.times),
            "launches": dict(self.launches),
        }
        if self._fft_avg is not None:
            db = 20.0 * np.log10(np.maximum(self._fft_avg, 1e-12))
            self.stats["fft_db"] = np.round(db, 1).tolist()

    def _fft_tap(self, blk: np.ndarray, nbins: int = 256,
                 rate: float = 0.2) -> None:
        """Host-side averaged-spectrum tap for /status (the recorder's
        FFTPanBlock display path, webserver.cpp's FFT endpoint)."""
        nseg = min(len(blk) // nbins, 8)
        if nseg < 1:
            return
        segs = blk[: nseg * nbins].reshape(nseg, nbins)
        m = np.abs(np.fft.fftshift(np.fft.fft(segs, axis=-1),
                                   axes=-1)).mean(0) / nbins
        if self._fft_avg is None:
            self._fft_avg = m
        else:
            self._fft_avg = self._fft_avg * (1 - rate) + m * rate

    def stop(self) -> List[str]:
        self.push(np.zeros(0, np.complex64), last=True)
        self._soft_f.close()
        outs = []
        for f in self._dec_f:
            outs.append(f.name)
            f.close()
        self._update_stats()
        return [self._soft_f.name] + outs

    def run_source(self, blocks: Iterable[np.ndarray]) -> List[str]:
        """Drain a block iterator (file reader, RemoteIQClient...)."""
        self.start()
        for blk in blocks:
            self.push(blk)
        return self.stop()


def _ext(level: str) -> str:
    return {"cadu": ".cadu", "frm": ".frm", "bbframe": ".bbframe",
            "ts": ".ts"}.get(level, f".{level}")
