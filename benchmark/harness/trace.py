"""Padded torch.profiler sessions around calls into the program, reduced to
what the per-layer metrics read.

Each session idles the host PAD_S at both ends inside the profiler: the
profiler keeps only the device records that fall inside its session on the
host clock, and its reading of the device clock jumps now and then by up to
~3 ms on an H100, so a session of a few short launches could lose them all
(the padding and its reason are copied from the port's `chip_smoke.py`).
The work itself sits in a `benchmark::<layer>` annotation whose start and end
bound the session's wall, busy time and idle gaps.

A session has lost device records where it holds fewer kernel records than
kernel launches inside its annotation (a driver-API launch inside a
runtime-API launch is that launch, counted once); `run.py` also holds each
kernel that has a roofline file to the launches seen through the program's
one launch path (`ops/cuda/_build.py::Kernel`) and to its wrapper's counter
(`ops.cuda.launch_counts()`). The first few kernel records of a session can
go missing on the card, so LEAD_LAUNCHES throwaway launches go ahead of the
annotation and their records are not counted. The device metrics of a
traced run read its sessions together, so one session that lost records
leaves every device metric out (the others alone would give another layer's
number): `run.py` then profiles the traced calls again, up to TRIES times,
and reports nothing rather than a low number where no try kept them all.
Device records are clipped to the annotation, whose ends the device clock's
jumps can cross.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

PAD_S = 0.25
LEAD_LAUNCHES = 32
TRIES = 3
SPAN = "benchmark::"


@dataclass
class Session:
    layer: str
    air_s: float
    wall_s: float = 0.0              # the annotation's length
    busy_s: float = 0.0              # union of kernel and copy intervals
    launches: int = 0                # kernel launches in the host records
    kernel_records: int = 0
    by_kernel: dict = field(default_factory=dict)   # name: [count, s]
    gaps: dict = field(default_factory=dict)        # host op: idle s
    args: dict = field(default_factory=dict)        # entry: [launch args]
    counters: dict = field(default_factory=dict)    # wrapper: launches
    lost: str = ""                   # why the records are not whole

    def kernel_s(self, device_name: str) -> tuple:
        """(records, seconds) of the kernels whose name holds
        `device_name`."""
        hits = [v for k, v in self.by_kernel.items() if device_name in k]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


def _kernel_launch_path():
    from satdump_tpu_torch.ops.cuda import _build
    return _build.Kernel


@contextlib.contextmanager
def session(layer: str, air_s: float, device_type: str):
    """Profile the body as one session of `layer`; yields the Session,
    filled in when the body has returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from satdump_tpu_torch.ops.cuda import launch_counts
    sess = Session(layer, air_s)
    Kernel = _kernel_launch_path()
    orig = Kernel.__call__

    def seen(self, device_index, *args):
        sess.args.setdefault(self.entry, []).append(args)
        return orig(self, device_index, *args)

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = launch_counts()
    Kernel.__call__ = seen
    try:
        with profile(activities=acts) as prof:
            if device_type == "cuda":
                # the first few kernel records of a session can go missing
                # (4 in every session on the card): let these take them
                x = torch.zeros(1, device=device_type)
                for _ in range(LEAD_LAUNCHES):
                    x.add_(1)
                torch.cuda.synchronize()
            time.sleep(PAD_S)
            with record_function(SPAN + layer):
                yield sess
                if device_type == "cuda":
                    torch.cuda.synchronize()
            time.sleep(PAD_S)
    finally:
        Kernel.__call__ = orig
    after = launch_counts()
    sess.counters = {k: after[k] - before[k] for k in after}
    _reduce(sess, prof.profiler.kineto_results.events())


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (starts, ends), sorted: (starts, ends)."""
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], np.maximum.accumulate(ends[o])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(s) - 1)
    return s[idx], e[last]


def _reduce(sess: Session, events) -> None:
    from torch.autograd import DeviceType
    span = None
    dev, host, launches = [], [], []
    for e in events:
        name = e.name()
        t = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            # the profiler also puts each annotation on the device's line
            if not name.startswith(SPAN) and not e.is_user_annotation():
                dev.append((name, *t, e.correlation_id()))
        elif name == SPAN + sess.layer:
            span = t
        elif not name.startswith(SPAN):
            host.append((name, *t))
            if "LaunchKernel" in name:
                launches.append((name, *t, e.correlation_id()))
    if span is None:
        sess.lost = "no span"
        return
    sess.wall_s = (span[1] - span[0]) / 1e9
    # a driver-API launch inside a runtime-API launch is that launch
    runtime = sorted(x[1:3] for x in launches if x[0].startswith("cuda"))
    rs = np.array([r[0] for r in runtime], np.int64)

    def nested(x):
        i = np.searchsorted(rs, x[1], side="right") - 1
        return not x[0].startswith("cuda") and i >= 0 and \
            runtime[i][1] >= x[2]
    before = {x[3] for x in launches if x[1] < span[0]}
    inside = [x for x in launches if span[0] <= x[1] <= span[1]
              and not nested(x)]
    dev = [d for d in dev if d[3] not in before]
    sess.launches = len(inside)
    sess.kernel_records = sum(not d[0].startswith(("Memcpy", "Memset"))
                              for d in dev)
    for name, s, e, _ in dev:
        rec = sess.by_kernel.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    if not dev:
        sess.lost = "no device records"
        return
    if sess.kernel_records < sess.launches:
        ids = {d[3] for d in dev}
        sess.lost = (f"{sess.kernel_records} kernel records for "
                     f"{sess.launches} launches; launches (s into the span) "
                     "without a record under their own id: " + str(
                         [(x[0], (x[1] - span[0]) / 1e9) for x in inside
                          if x[3] not in ids][:3]))
    ds = np.array([d[1] for d in dev], np.int64)
    de = np.array([d[2] for d in dev], np.int64)
    us, ue = _union(np.clip(ds, *span), np.clip(de, *span))
    sess.busy_s = float((ue - us).sum()) / 1e9
    _name_gaps(sess, span, us, ue, host)


def _name_gaps(sess: Session, span, us, ue, host) -> None:
    """Idle time between device intervals inside the span, summed by the
    host operation at each gap's midpoint: the latest-starting one of the
    32 that started last before it that covers it, else "after <the one
    that started last>"."""
    gs = np.concatenate([[span[0]], ue])
    ge = np.concatenate([us, [span[1]]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    if not len(gs) or not host:
        return
    host.sort(key=lambda h: h[1])
    hs = np.array([h[1] for h in host], np.int64)
    he = np.array([h[2] for h in host], np.int64)
    mid = (gs + ge) // 2
    last = np.searchsorted(hs, mid, side="right") - 1
    for i, m, g in zip(last, mid, ge - gs):
        name = "before any host op" if i < 0 else "after " + host[i][0]
        for j in range(i, max(i - 32, -1), -1):
            if he[j] >= m:
                name = host[j][0]
                break
        sess.gaps[name] = sess.gaps.get(name, 0.0) + g / 1e9


def roofline_share(sessions, mod):
    """% of the card's roofline that a kernel reached over the traced run's
    sessions: the least time its launches could take (`mod.bound_s` of each
    launch's arguments) over their device time. None where a session lost
    records or none launched it."""
    bound = dev = 0.0
    for s in kept(sessions):
        n, sec = s.kernel_s(mod.DEVICE_NAME)
        if not n:
            continue
        bound += sum(mod.bound_s(a) for a in s.args[mod.ENTRY])
        dev += sec
    return 100.0 * bound / dev if dev else None


def kept(sessions) -> list:
    """The sessions of a traced run where none lost records, else none."""
    return [] if any(s.lost for s in sessions) else list(sessions)
