"""The main path's baseband -> CADU wall (chip_smoke.py's phase 6) in
several checkouts, one process a run, in the order given, so that two
commits are compared within one card call.

    python3 -m satdump_tpu_torch.tools.main_path_ab [--reps 4] \
        TREE,CADUS,WARM [TREE,CADUS,WARM ...]

TREE is the root of a checkout holding chip_smoke.py (to compare with a
parent commit, unpack it with `git archive` under satdump_tpu_torch/_build/).
CADUS is what the ~2^23-sample MetOp AHRPT pass carries: `random` (398
random CADUs, as before the products level) or `instrument` (AVHRR/3 and
MHS packets between idle frames, 399 CADUs, as chip_smoke.py's phase 6 now
sends). WARM is what the process runs on the card before it: `prefix` (the
tree's own chip_smoke.py phases 2-5, all that chip_smoke.py runs before
phase 6), `smoke` (its phase 5 alone), `cadu` (12-CADU MetOp and METEOR
passes to CADU on the card and the CPU, the phase 5 of a tree without
products) or `none`. Each run builds the tree's kernels, warms, then times the pass
`--reps` times (host clock around run_pipeline, ended by a synchronize),
with the process's CPU time (user + system) over the same span. It prints
a table of all runs and the card's name and power limit. Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

MAIN_RANDOM_CADUS = 398           # int(2^23 / (8192 * 18 / 7))


def child(tree: Path, cadus_kind: str, warm: str, reps: int) -> dict:
    """One run inside `tree`'s code; returns its walls."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import numpy as np
    import torch
    import chip_smoke as c
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    c.phase_build()
    rng = np.random.default_rng(c.SEED)
    work = tree / "satdump_tpu_torch" / "_build" / "ab"
    if warm == "prefix":
        c.phase_probe(rng)
        c.phase_k1(rng)
        c.phase_k2(rng)
    if warm in ("prefix", "smoke"):
        c.phase_small_pass(rng, work / "small")
    elif warm == "cadu":
        for fname, pipe_id, sps, params in (c.METOP, c.METEOR):
            bb = sim.ccsds_qpsk_baseband(sim.make_cadus(12, rng), rng, sps)
            (work / pipe_id).mkdir(parents=True, exist_ok=True)
            path = work / pipe_id / "pass.cf32"
            write_baseband(path, "cf32", bb)
            for dev in ("cuda", "cpu"):
                run_pipeline(c._pipeline(fname, pipe_id), str(path),
                             str(work / pipe_id / dev),
                             user_params=dict(params, torch_device=dev))
    if cadus_kind == "random":
        cadus = sim.make_cadus(MAIN_RANDOM_CADUS, rng)
    else:
        idle = sim.idle_cadus(c.MAIN_IDLE)
        data, _ = sim.metop_instrument_cadus(rng, c.MAIN_AVHRR_LINES,
                                            c.MAIN_MHS_LINES)
        cadus = np.concatenate([idle, data, idle])
    fname, pipe_id, sps, _ = c.METOP
    bb = sim.ccsds_qpsk_baseband(cadus, rng, sps)
    (work / "main").mkdir(parents=True, exist_ok=True)
    path = work / "main" / "pass.cf32"
    write_baseband(path, "cf32", bb)
    walls, cpus = [], []
    for r in range(reps):
        torch.cuda.synchronize()
        c0, t0 = os.times(), time.perf_counter()
        out = run_pipeline(c._pipeline(fname, pipe_id), str(path),
                           str(work / "main" / f"out{r}"))
        torch.cuda.synchronize()
        t1, c1 = time.perf_counter(), os.times()
        walls.append(t1 - t0)
        cpus.append(c1.user - c0.user + c1.system - c0.system)
        c._check_cadus(out, cadus, f"rep {r}")
    return {"samples": len(bb), "cadus": len(cadus), "walls_s": walls,
            "cpu_s": cpus, "torch_threads": torch.get_num_threads()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", help="TREE,CADUS,WARM")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        tree, kind, warm = a.runs[0].split(",")
        print("AB " + json.dumps(child(Path(tree).resolve(), kind, warm,
                                       a.reps)), flush=True)
        return 0
    rows = []
    for run in a.runs:
        tree, kind, warm = run.split(",")
        assert kind in ("random", "instrument") and \
            warm in ("prefix", "smoke", "cadu", "none"), run
        t = time.perf_counter()
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--child", "--reps", str(a.reps), run],
                           capture_output=True, text=True)
        res = [ln[3:] for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode or not res:
            print(p.stdout[-4000:], p.stderr[-4000:], sep="\n")
            raise SystemExit(f"{run}: exit {p.returncode}")
        r = json.loads(res[0])
        r.update(run=run, process_s=time.perf_counter() - t)
        rows.append(r)
        print(json.dumps(r), flush=True)
    print(f"{'run':48s} {'samples':>8s} walls s (cpu s), Msamp/s of the "
          "best")
    for r in rows:
        ws = ", ".join(f"{w:.3f} ({u:.2f})"
                       for w, u in zip(r["walls_s"], r["cpu_s"]))
        print(f"{r['run']:48s} {r['samples']:8d} {ws}; "
              f"{r['samples'] / min(r['walls_s']) / 1e6:.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
