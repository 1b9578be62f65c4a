"""Spans and counters of the hot layers, on the profiler's clock.

`span(name, kind)` marks one step of the program: a pipeline step, a
`psk_demod` block, a decoder chunk, a wait on the card inside them.
`count(name, n)` adds to a named counter (the CADUs the decoders write).
Both record only while tracing is on: between `enable()` and `disable()`,
or while a torch profiler records, with no call of the program's own.
Off, `span` returns one shared no-op after that check and `count` returns.

On, a span reads the host clock (`time.perf_counter_ns`) at its start and
its end, and each thread keeps a stack of its open spans, so that
`totals()` gives per name: calls, total ns, self ns (the total less the
part that its child spans on the same thread cover), its kind; and the
counters. Memory grows with the number of names, not with the run, so a
whole pass can be traced. While a profiler records, each span is also a
`record_function("satdump::<name>")` range: it sits in the profiler's trace
beside the kernels and copies it caused, on the profiler's clock, and the
card's idle gaps fall inside named program steps.

A span's `kind`:
* ``"host"``: host-only work that queues nothing on the card (NumPy, file
  reads and writes);
* ``"wait"``: the host blocks until the card is done: a copy to the host, a
  blocking copy from pageable host memory to the card, `float()` / `int()`
  / `.item()` of a card tensor, a boolean-mask index;
* None: a span that encloses others, or queues work on the card.

`timed(name, kind)` is a span that reads the clock whether tracing is on
or not (its `ns` once it has ended), for the timings that the program
reports anyway, such as a pipeline step's "done in" log. `Laps` chains
spans end to start, one clock read between two of them, and adds each one's
seconds to a dict: `LivePipeline.times`, which `/status` shows.
"""

from __future__ import annotations

import threading
import time

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "satdump::"
KINDS = (None, "host", "wait")

_on = False
_lock = threading.Lock()
_spans: dict = {}          # name: [calls, ns, self_ns, kind]
_counters: dict = {}       # name: total
_local = threading.local()


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Record them only while a profiler records."""
    global _on
    _on = False


def active() -> bool:
    """Whether spans and counters record now."""
    return _on or _profiler_enabled()


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()


def totals() -> dict:
    """{"spans": {name: {"calls", "ns", "self_ns", "kind"}}, "counters":
    {name: total}} of everything recorded since the last `reset()`."""
    with _lock:
        return {"spans": {k: {"calls": v[0], "ns": v[1], "self_ns": v[2],
                              "kind": v[3]} for k, v in _spans.items()},
                "counters": dict(_counters)}


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if active():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "kind", "t0", "ns", "child", "rf", "on")

    def __init__(self, name: str, kind: str | None = None):
        if kind not in KINDS:
            raise ValueError(f"span kind {kind!r} is not one of {KINDS}")
        self.name, self.kind, self.ns = name, kind, 0

    def begin(self, t0: int | None = None) -> "_Span":
        """Open the span; `t0`, a clock read the caller already made."""
        profiled = _profiler_enabled()
        self.on = _on or profiled
        if self.on:
            self.child, self.rf = 0, None
            if profiled:
                self.rf = record_function(PREFIX + self.name)
                self.rf.__enter__()
            _stack().append(self)
        self.t0 = time.perf_counter_ns() if t0 is None else t0
        return self

    def end(self, t1: int | None = None) -> int:
        """Close the span at `t1` (else now); returns that clock read."""
        if t1 is None:
            t1 = time.perf_counter_ns()
        self.ns = t1 - self.t0
        if self.on:
            st = _stack()
            if st and st[-1] is self:
                st.pop()
            elif self in st:
                st.remove(self)
            if st:
                st[-1].child += self.ns
            with _lock:
                rec = _spans.get(self.name)
                if rec is None:
                    _spans[self.name] = [1, self.ns, self.ns - self.child,
                                         self.kind]
                else:
                    rec[0] += 1
                    rec[1] += self.ns
                    rec[2] += self.ns - self.child
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
        return t1

    def __enter__(self) -> "_Span":
        return self.begin()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, kind: str | None = None):
    """A context manager that records `name` while tracing is on."""
    if not (_on or _profiler_enabled()):
        return _OFF
    return _Span(name, kind)


def timed(name: str, kind: str | None = None) -> _Span:
    """A span that reads the clock in any case: `.ns` once it has ended."""
    return _Span(name, kind)


class Laps:
    """Back-to-back spans named `prefix + part`: `lap(part)` ends the open
    span, adds its seconds to `times[its part]`, and starts the next one on
    the same clock read; `lap()` ends the open span and starts none."""

    def __init__(self, times: dict, prefix: str):
        self.times, self.prefix = times, prefix
        self._part, self._span = None, None

    def lap(self, part: str | None = None) -> None:
        now = time.perf_counter_ns()
        if self._span is not None:
            self._span.end(now)
            self.times[self._part] += self._span.ns / 1e9
        self._part = part
        self._span = None if part is None else \
            _Span(self.prefix + part).begin(now)
