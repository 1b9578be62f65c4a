"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (`satdump_tpu_torch`) and
a CUDA card: set-up (imports, the card, the kernels' load, the recording made
from the seed, a warm-up of the cell's own shapes through its own entry),
then the measured window, then with `--trace 1` the profiler sessions, then
the check of what the window produced against the plain reference and the
CADUs sent. The last line of standard output is the result as JSON; the last
lines of standard error are the numbers compared, each beside its limit.
There is no CPU fallback: without a card, or with a JAX module loaded, the
run prints no result and exits nonzero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
CACHE = BENCH / "_cache"
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)

from harness import spec  # noqa: E402

TOP_OPS = 10


class Run:
    """One run of one cell: its arguments, its work directory and the
    record that the drivers fill and the metric readers read. `sizes`
    overrides the traffic file's parameters (and `samples`, the offline
    recording's length) for dry runs on the CPU."""

    def __init__(self, cell, seed, seconds, trace, device, sizes=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.sizes = sizes or {}
        self.work = BENCH / "_work" / cell.name
        shutil.rmtree(self.work, ignore_errors=True)
        self.work.mkdir(parents=True)
        self.record: dict = {"sessions": []}


def fail(msg: str, code: int = 1):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def guard(when: str) -> None:
    bad = spec.forbidden_modules()
    if bad:
        fail(f"{when}: modules {bad} are loaded; the benchmark measures "
             "satdump_tpu_torch alone", 3)


def held_to_counts(sessions, device_type: str) -> None:
    """Mark a session lost where a kernel with a roofline file has other
    than one device record per launch seen by the launch path, and per
    launch its wrapper counted where `ops.cuda.launch_counts()` has that
    wrapper."""
    if device_type != "cuda":
        return
    for s in sessions:
        for name, mod in spec.rooflines().items():
            records = s.kernel_s(mod.DEVICE_NAME)[0]
            seen = len(s.args.get(mod.ENTRY, []))
            counted = s.counters.get(name, seen)
            if not s.lost and not records == seen == counted:
                s.lost = (f"{name}: {records} device records, {seen} "
                          f"launches seen, counter {counted}")


def traced_sessions(driver, device_type: str) -> list:
    """The driver's traced calls, profiled again (up to `trace.TRIES`
    times) while a session loses records; the last try's sessions."""
    from harness import trace as tr
    for attempt in range(tr.TRIES):
        sessions = driver.traced()
        held_to_counts(sessions, device_type)
        for s in sessions:
            if s.lost:
                print(f"benchmark: try {attempt + 1}, session {s.layer} "
                      f"lost records: {s.lost}", file=sys.stderr)
        if device_type != "cuda" or not any(s.lost for s in sessions):
            return sessions
    return sessions


def breakdown(sessions) -> dict:
    ops, gaps = {}, {}
    for s in sessions:
        for k, (_, sec) in s.by_kernel.items():
            ops[k] = ops.get(k, 0.0) + sec
        for k, sec in s.gaps.items():
            gaps[k] = gaps.get(k, 0.0) + sec
    top = lambda d: [[k[:160], v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:TOP_OPS]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def verify(run, driver) -> dict:
    """The cell's reference's `check`: the numbers compared, each
    {"value", "limit"}, and attempted and failed frames. It runs after the
    program's state is freed, on the same device; the card's cache is freed
    after it."""
    import torch
    result = run.cell.reference.check(run, driver)
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return result


def run_cell(name, seed, seconds, trace, device="cuda", sizes=None,
             spec_dict=None) -> dict:
    """Set-up, window, traced sessions and check of one cell; returns the
    result object. `device` and `sizes` other than the defaults are for
    dry runs on the CPU at tiny sizes."""
    import torch
    from harness import program
    cell = spec.Cell(name, spec_dict)
    program.quiet()
    run = Run(cell, seed, seconds, trace, device, sizes)
    if trace and device == "cuda":
        from harness import trace as tr
        with tr.session("profiler warm-up", 0.0, device):
            torch.zeros(1, device=device).add_(1)
    driver = cell.driver.Driver(run)
    program.sync(device)
    guard("after set-up")
    run.record["setup_s"] = time.perf_counter() - T0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver.window(seconds)
    program.sync(device)
    guard("after the window")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    t_win = time.perf_counter()
    if trace:
        run.record["sessions"] = traced_sessions(driver, device)
    driver.finish()
    driver.close()
    gc.collect()
    t_check = time.perf_counter()
    result = verify(run, driver)
    print(f"benchmark: set-up {run.record['setup_s']:.1f} s, window "
          f"{t_win - T0 - run.record['setup_s']:.1f} s, traced and flushed "
          f"{t_check - t_win:.1f} s, check {time.perf_counter() - t_check:.1f}"
          " s", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m).read(run.record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = result.pop("checks")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, **result, "metrics": metrics, "device": dev}
    if trace:
        from harness.trace import kept
        # where every try lost records, the device metrics are missing and
        # busy and window come from the last try's sessions as they stand
        good = kept(run.record["sessions"]) or run.record["sessions"]
        dev["busy_s"] = sum(s.busy_s for s in good)
        dev["window_s"] = sum(s.wall_s for s in good)
        out["breakdown"] = breakdown(good)
    out["checks"] = checks
    guard("at the result")
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        cell = spec.Cell(a.workload)
    except (OSError, KeyError) as e:
        fail(f"no such cell: {e}")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        fail(f"the cell needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count()} available")
    try:
        import satdump_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    if a.trace:
        print(f"benchmark: card {power_limit()}", file=sys.stderr)
    out = run_cell(a.workload, a.seed, a.seconds, a.trace)
    for k, c in out["checks"].items():
        print(f"benchmark: {k} {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
