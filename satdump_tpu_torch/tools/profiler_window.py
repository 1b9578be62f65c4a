"""Where torch.profiler's device records fall in its capture window, over
the life of one process.

    python3 -m satdump_tpu_torch.tools.profiler_window [--seconds 90]

Needs one NVIDIA GPU. Every round it launches the toolchain probe 2000 times
outside any profiler session, then profiles 20 more launches twice: once
with no host idle around them, once with `--pad` seconds of host idle at
each end of the session. For each session it prints the seconds since the
first session, how many probe kernels the trace holds, and where the first
kernel starts and the last one ends relative to the session's start, beside
the host's own idea of when the launches began and ended. A device record
placed outside the session's window is dropped by the profiler, so a drift
between the two clocks shows as a start that moves away from the host's
and as sessions that lose their records.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from satdump_tpu_torch.ops.cuda.probe import affine_probe

KERNEL = "probe_affine_kernel"


def session(x, reps: int, pad: float) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        time.sleep(pad)
        t1 = time.perf_counter()
        for _ in range(reps):
            affine_probe(x)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        time.sleep(pad)
    ev = sorted((e for e in prof.events()
                 if e.device_type == DeviceType.CUDA and KERNEL in e.name),
                key=lambda e: e.time_range.start)
    out = {"pad_s": pad, "seen": len(ev), "of": reps,
           "host_first_launch_us": round((t1 - t0) * 1e6, 1),
           "host_synced_us": round((t2 - t0) * 1e6, 1)}
    if ev:
        out["first_kernel_start_us"] = round(ev[0].time_range.start, 1)
        out["last_kernel_end_us"] = round(ev[-1].time_range.end, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--pad", type=float, default=0.25)
    ap.add_argument("--burst", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window: needs a CUDA device")
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda")
    affine_probe(x)
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    rounds = 0
    while time.perf_counter() - t_first < args.seconds:
        for _ in range(args.burst):
            affine_probe(x)
        torch.cuda.synchronize()
        t = time.perf_counter() - t_first
        for pad in (0.0, args.pad):
            r = session(x, 20, pad)
            r["t_s"] = round(t, 2)
            print(json.dumps(r), flush=True)
        rounds += 1
    print(f"rounds {rounds}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
