"""Live traffic: one continuous recording held in host RAM as complex64 and
handed to `LivePipeline.push` in chunks of `chunk_samples`, as an SDR source
hands them over. Set-up pushes the first `warmup_chunks` chunks; the window
then pushes until its seconds have passed, or the recording runs out.

`pace` 0 is a closed loop: each chunk goes as soon as the last `push` has
returned (a pass replayed through the live path as fast as it goes). `pace`
p > 0 is an open loop at p times the stream's sample rate: chunk k of the
window is due k * chunk / (p * samplerate) seconds after its start, waits
for that time, and goes late, at once, where the program is behind.

A CADU is due when the window handed over its last sample. Its latency runs
from the due time of that chunk (closed loop: the start of its `push`) to
the return of the `push` after which the decoder had written it. The count
of CADUs written comes from a counting wrapper around the first decoder's
`stream_work` (which `push` calls and whose return value it drops), held at
the end to the `.cadu` file's length. After the window, pushes go on until
every due CADU is out or `flush_chunks` more chunks have gone; a traced run
then profiles `trace_sessions` sessions of `pushes_per_session` pushes each
(again, up to `trace.TRIES` times, where a session lost records). `stop()`
ends the stream.

The recording holds `recording_factor` times the window's air time beyond
the warm-up, and the flush and traced chunks beyond that, which the window
leaves alone. A window that reaches the end of that air before its seconds
have passed ends there, and says so on standard error and in the run's
record (`window.ran_out`): its rate stands, over a shorter window.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import program, trace, tx


def recording_samples(cfg: dict, tr: dict, seconds: float) -> int:
    """The recording's length: the warm-up, `recording_factor` times the
    window's air time, the flush and traced chunks, in whole chunks."""
    n = (tr["warmup_chunks"] + _reserve_chunks(tr)) * tr["chunk_samples"] \
        + int(tr["recording_factor"] * seconds * cfg["signal"]["samplerate"])
    return -(-n // tr["chunk_samples"]) * tr["chunk_samples"]


def _reserve_chunks(tr: dict) -> int:
    """Chunks kept after the window's air: the flush and every try of the
    traced sessions."""
    return tr["flush_chunks"] + trace.TRIES * tr["trace_sessions"] \
        * tr["pushes_per_session"]


def _rates(pushes, chunk: int, dt: float) -> list:
    """Msamp/s handed over in each whole interval of dt seconds of wall."""
    t = np.array([p[1] for p in pushes]) - pushes[0][0]
    k = (t // dt).astype(int)
    return [np.count_nonzero(k == i) * chunk / dt / 1e6
            for i in range(k.max())]


class Driver:
    def __init__(self, run):
        from satdump_tpu_torch.pipeline.live import LivePipeline
        self.run, self.cfg = run, run.cell.cfg
        self.tr = tr = {**run.cell.traffic, **run.sizes}
        self.fs = self.cfg["signal"]["samplerate"]
        self.chunk = tr["chunk_samples"]
        warm = tr["warmup_chunks"] * self.chunk
        self.reserve = _reserve_chunks(tr) * self.chunk
        n = recording_samples(self.cfg, tr, run.seconds)
        t0 = time.perf_counter()
        rec = run.cell.code.make_recording(self.cfg, n, run.seed,
                                           run.device)
        self.x = tx.cs16_to_complex(rec.iq).cpu().numpy()
        self.sent, self.end = rec.cadus, rec.cadu_end
        del rec
        t1 = time.perf_counter()
        levels = self.cfg["levels"]
        pipe = program.pipeline(self.cfg, levels[0], levels[-1])
        self.lp = LivePipeline(pipe, str(run.work / "live"),
                               user_params=program.user_params(run.device))
        self.lp.start()
        self.written = 0
        decoder = self.lp.modules[1]
        inner = decoder.stream_work

        def counted(*args, **kwargs):
            n_out = inner(*args, **kwargs)
            self.written += n_out
            return n_out
        decoder.stream_work = counted
        # per push: (due or start, return, samples handed over, CADUs out)
        self.pushes = []
        self.pos = 0
        while self.pos < warm:
            self._push()
        print(f"benchmark: recording of {n} samples made in {t1 - t0:.1f} s,"
              f" warm-up {time.perf_counter() - t1:.1f} s", file=sys.stderr)

    def _push(self, due=None) -> None:
        t0 = time.perf_counter()
        self.lp.push(self.x[self.pos: self.pos + self.chunk])
        program.sync(self.run.device)
        self.pos += self.chunk
        self.pushes.append((t0 if due is None else due, time.perf_counter(),
                            self.pos, self.written))

    def _stats(self):
        st = self.lp.stats           # empty until a block has run
        return st.get("host_s", {}).get("decoder", 0.0), st.get("blocks", 0)

    def window(self, seconds: float) -> None:
        dec0, blk0 = self._stats()
        first, warm_end = len(self.pushes), self.pos
        period = self.chunk / (self.tr["pace"] * self.fs) \
            if self.tr["pace"] else 0.0
        stop = len(self.x) - self.reserve
        lag = 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and \
                self.pos + self.chunk <= stop:
            due = None
            if period:
                due = t0 + (len(self.pushes) - first) * period
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                lag = max(lag, -wait)
            self._push(due)
        wall = time.perf_counter() - t0
        win_end = self.pos
        ran_out = wall < seconds
        if ran_out:
            print(f"benchmark: the recording's window air ran out after "
                  f"{wall:.1f} of {seconds} s: raise recording_factor",
                  file=sys.stderr)
        dec1, blk1 = self._stats()
        self.due = (self.end > warm_end) & (self.end <= win_end)
        need = int(np.flatnonzero(self.due)[-1]) + 1 if self.due.any() else 0
        for _ in range(self.tr["flush_chunks"]):
            if self.written >= need:
                break
            self._push()
        if period:
            print(f"benchmark: pushes ran at most {lag * 1e3:.1f} ms behind "
                  "their due times", file=sys.stderr)
        took = np.array([p[1] - p[0] for p in self.pushes[first:]])
        print("benchmark: push ms, quartiles and max: " + " ".join(
            f"{v:.2f}" for v in np.percentile(took, [25, 50, 75, 100]) * 1e3)
            + "; Msamp/s in each 2 s: " + " ".join(
                f"{v:.2f}" for v in _rates(self.pushes[first:], self.chunk,
                                            2.0)),
            file=sys.stderr)
        rec = self.run.record
        rec["window"] = {"air_s": (win_end - warm_end) / self.fs,
                         "wall_s": wall, "pushes": len(self.pushes) - first,
                         "ran_out": ran_out}
        rec["live"] = {"decoder_s": dec1 - dec0, "blocks": blk1 - blk0}

    def traced(self) -> list:
        sessions = []
        per = self.tr["pushes_per_session"]
        for _ in range(self.tr["trace_sessions"]):
            with trace.session("live", per * self.chunk / self.fs,
                               self.run.device) as s:
                for _ in range(per):
                    self._push()
            sessions.append(s)
        return sessions

    def finish(self) -> None:
        t0 = time.perf_counter()
        self.mid_path, self.cadu_path = self.lp.stop()[:2]
        self.pushes.append((t0, time.perf_counter(), self.pos, self.written))
        self._latencies()

    def _latencies(self) -> None:
        """Each due CADU's latency, ms, into the run's record."""
        raw = np.fromfile(self.cadu_path, np.uint8)
        nb = self.sent.shape[1]
        if len(raw) != self.written * nb:
            print(f"benchmark: the decoder returned {self.written} CADUs, "
                  f"its file holds {len(raw) / nb}", file=sys.stderr)
        index = {row.tobytes(): i for i, row in enumerate(self.sent)}
        rows = [index.get(r.tobytes(), -1)
                for r in raw[: len(raw) // nb * nb].reshape(-1, nb)]
        due_t, ret_t, handed, out = (np.array(c) for c in zip(*self.pushes))
        lat = []
        for j, i in enumerate(rows):
            if i < 0 or not self.due[i]:
                continue
            q = int(np.searchsorted(handed, self.end[i]))   # handed it over
            p = int(np.searchsorted(out, j + 1))            # wrote it
            lat.append((ret_t[p] - due_t[q]) * 1e3)
        self.run.record["latencies_ms"] = lat

    def outputs(self):
        yield (self.mid_path, self.pos, np.fromfile(self.cadu_path,
                                                     np.uint8), self.due)

    def stream(self, device) -> torch.Tensor:
        return torch.from_numpy(self.x).to(device)

    def close(self) -> None:
        del self.lp
