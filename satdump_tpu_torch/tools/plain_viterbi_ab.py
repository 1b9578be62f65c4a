"""The block Viterbi's plain version (what `viterbi_decode_block` and
`viterbi_decode_tiled` run for a CPU tensor) timed in several checkouts,
one process a case and checkout, so that two commits are compared on one
host.

    python3 -m satdump_tpu_torch.tools.plain_viterbi_ab [--threads 1] \
        [--reps 2] TREE [TREE ...]

TREE is the root of a checkout holding `satdump_tpu_torch/` (to compare
with a parent commit, unpack it with `git archive` into a git-ignored
directory). The cases:
  lock   `viterbi_decode_block` on 1024 rows of 1023 pairs: a lock search's
         batch (Viterbi12Sync.search_stream at max_lanes 1024, TEST_BITS
         2048);
  tiled  `viterbi_decode_tiled` on 2^20 pairs at seg 1024, ovl 128: 1024
         lanes of 1280 steps.
Softs are uniform integers in [0, 255] from seed 0. Each case runs once
to warm, then `--reps` times on the host clock; its peak memory is the
process's peak resident set (ru_maxrss) less its resident set before the
first call. Prints one JSON line a run, then a table.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

CASES = ("lock", "tiled")
LOCK_SHAPE = (1024, 1023)
TILED = (1 << 20, 1024, 128)     # pairs, seg, ovl


def _rss_kib() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() // 1024


def child(tree: Path, case: str, threads: int, reps: int) -> dict:
    """One case inside `tree`'s code; returns its times and memory."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from satdump_tpu_torch.ops.fec import convolutional as cc
    torch.set_num_threads(threads)
    rng = np.random.default_rng(0)
    if case == "lock":
        x = torch.from_numpy(rng.integers(0, 256, LOCK_SHAPE + (2,))
                             .astype(np.float32))
        call = lambda: cc.viterbi_decode_block(x)  # noqa: E731
    else:
        n, seg, ovl = TILED
        x = torch.from_numpy(rng.integers(0, 256, (n, 2)).astype(np.float32))
        call = lambda: cc.viterbi_decode_tiled(x, seg, ovl)  # noqa: E731
    rss0 = _rss_kib()
    t = time.perf_counter()
    call()
    first = time.perf_counter() - t
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        call()
        walls.append(time.perf_counter() - t)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return {"tree": str(tree), "case": case, "threads": threads,
            "first_s": first, "walls_s": walls,
            "peak_mib": (peak - rss0) / 1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--child", choices=CASES, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(child(a.trees[0].resolve(), a.child, a.threads,
                               a.reps)))
        return 0
    rows = []
    for tree in a.trees:
        for case in CASES:
            p = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(tree),
                 "--child", case, "--threads", str(a.threads),
                 "--reps", str(a.reps)],
                capture_output=True, text=True, check=True)
            r = json.loads(p.stdout.strip().splitlines()[-1])
            print(json.dumps(r), flush=True)
            rows.append(r)
    print(f"{'tree':40s} {'case':6s} {'first s':>9s} {'best s':>9s} "
          f"{'peak MiB':>9s}")
    for r in rows:
        print(f"{r['tree'][-40:]:40s} {r['case']:6s} {r['first_s']:9.3f} "
              f"{min(r['walls_s']):9.3f} {r['peak_mib']:9.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
