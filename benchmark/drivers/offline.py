"""Offline traffic: a recording written once in set-up and decoded by whole
`run_pipeline` calls, baseband -> the last level, back to back (a closed
loop), each call building its modules as a user's call does. Calls start
until the window's seconds have passed; the window ends with the last of
them.

The configuration's `levels` name the pipeline's three levels (baseband,
the middle level, frames). In a traced run each call runs the levels one at
a time, as the runner does, with the host clock around each level (the
per-layer spans), and after the window `trace_calls` more calls run with
each level in a profiler session of its own. The first level's span and
session are named by the middle level's module (`psk_demod`), the second's
`decoder`. Set-up's warm-up runs level by level too, and the files that it
gets back from the pipeline name the files each call writes, which the
reference's `check` reads through `outputs()`.

The traffic file gives `warmup_samples` (the recording's prefix that set-up
decodes through the same entry), `trace_calls`, and `tail_guard` (samples:
a CADU that ends this close to the recording's end has too little code after
it for the Viterbi decoder to finish it, and is not due).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from harness import program, trace, tx

DECODER = "decoder"


def recording_samples(cfg: dict, tr: dict, seconds: float) -> int:
    """The recording's length: the configuration's `recording_s`."""
    return tr.get("samples", int(cfg["recording_s"]
                                 * cfg["signal"]["samplerate"]))


class Driver:
    def __init__(self, run):
        from satdump_tpu_torch.pipeline.runner import run_pipeline
        self.run, self.cfg = run, run.cell.cfg
        self.tr = {**run.cell.traffic, **run.sizes}
        self._run_pipeline = run_pipeline
        self.params = program.user_params(run.device)
        base, self.mid, last = self.cfg["levels"]
        self.layer = self.cfg["pipeline_parameters"][self.mid]["module"]
        self.full = program.pipeline(self.cfg, base, last)
        self.mid_pipe = program.pipeline(self.cfg, base, self.mid)
        self.last_pipe = program.pipeline(self.cfg, self.mid, last)
        self.n = recording_samples(self.cfg, self.tr, run.seconds)
        self.air_s = self.n / self.cfg["signal"]["samplerate"]
        t0 = time.perf_counter()
        rec = run.cell.code.make_recording(self.cfg, self.n, run.seed,
                                           run.device)
        self.iq = rec.iq.cpu().numpy()
        self.sent = rec.cadus
        self.due = rec.cadu_end + self.tr["tail_guard"] <= self.n
        del rec
        fmt = self.cfg["format"]
        self.path = run.work / f"pass.{fmt}"
        self.iq.tofile(self.path)
        warm = run.work / f"warm.{fmt}"
        self.iq[: self.tr["warmup_samples"]].tofile(warm)
        t1 = time.perf_counter()
        files = self._call(warm, run.work / "warm", self._spans())
        self.names = [Path(f).name for f in files]
        self.calls = []
        print(f"benchmark: recording of {self.n} samples made and written in "
              f"{t1 - t0:.1f} s, warm-up {time.perf_counter() - t1:.1f} s",
              file=sys.stderr)

    def _spans(self) -> dict:
        return dict.fromkeys((self.layer, DECODER), 0.0)

    def _call(self, src, out, spans=None):
        """One call, baseband -> the last level; with `spans`, level by
        level with the host clock around each, ended by a synchronize, and
        then the files of the middle and the last level."""
        dev = self.run.device
        if spans is None:
            self._run_pipeline(self.full, str(src), str(out), self.params)
            program.sync(dev)
            return None
        t0 = time.perf_counter()
        mid = self._run_pipeline(self.mid_pipe, str(src), str(out),
                                 self.params)
        program.sync(dev)
        t1 = time.perf_counter()
        last = self._run_pipeline(self.last_pipe, mid, str(out), self.params,
                                  start_level=self.mid)
        program.sync(dev)
        spans[self.layer] += t1 - t0
        spans[DECODER] += time.perf_counter() - t1
        return mid, last

    def window(self, seconds: float) -> None:
        spans = self._spans() if self.run.trace else None
        t0 = time.perf_counter()
        walls = []
        while time.perf_counter() - t0 < seconds:
            out = self.run.work / f"call{len(self.calls)}"
            t1 = time.perf_counter()
            self._call(self.path, out, spans)
            walls.append(time.perf_counter() - t1)
            self.calls.append(out)
        print("benchmark: call walls, s: "
              + " ".join(f"{w:.3f}" for w in walls), file=sys.stderr)
        rec = self.run.record
        air = len(self.calls) * self.air_s
        rec["window"] = {"air_s": air, "wall_s": time.perf_counter() - t0,
                         "calls": len(self.calls)}
        if spans is not None:
            rec["spans"] = {k: {"s": v, "air_s": air}
                            for k, v in spans.items()}

    def traced(self) -> list:
        sessions, dev = [], self.run.device
        for _ in range(self.tr["trace_calls"]):
            out = self.run.work / f"call{len(self.calls)}"
            with trace.session(self.layer, self.air_s, dev) as s1:
                mid = self._run_pipeline(self.mid_pipe, str(self.path),
                                         str(out), self.params)
            with trace.session(DECODER, self.air_s, dev) as s2:
                self._run_pipeline(self.last_pipe, mid, str(out),
                                   self.params, start_level=self.mid)
            self.calls.append(out)
            sessions += [s1, s2]
        return sessions

    def finish(self) -> None:
        """Every call has ended: nothing to flush."""

    def outputs(self):
        """Per call: (the middle level's file, samples of the stream it
        demodulated, the last level's bytes, due mask over the CADUs
        sent)."""
        mid, last = self.names
        for c in self.calls:
            yield (c / mid, self.n, np.fromfile(c / last, np.uint8),
                   self.due)

    def stream(self, device) -> torch.Tensor:
        """The recording as the program's reader scales it, complex64."""
        return tx.cs16_to_complex(torch.from_numpy(self.iq).to(device))

    def close(self) -> None:
        """The program keeps no state between calls."""
