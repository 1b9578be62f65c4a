"""The control's readings at a cell's own size, for setting the limit of
`soft_mismatch` (not run by the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3

For each seed: the cell's recording, made as its driver makes it for the
benchmark's `run_seconds`, through the plain reference in float32 and in
bfloat16 (the precision below the configuration's), on the card; prints the
share of softs in which the two differ: the upper reading of the number. The
lower reading is the `soft_mismatch` of the benchmark's own runs.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from harness import check, spec, tx  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.Cell(a.workload, bench)
    n = cell.driver.recording_samples(cell.cfg, cell.traffic,
                                      bench["run_seconds"])
    for seed in (int(s) for s in a.seeds.split(",")):
        rec = cell.code.make_recording(cell.cfg, n, seed, "cuda")
        x = tx.cs16_to_complex(rec.iq)
        del rec
        ref = cell.reference.demod(x, cell.cfg)[0]
        ctl = cell.reference.demod(x, cell.cfg, "bfloat16")[0]
        bad, total = check.soft_mismatch(ctl, ref)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "samples": n, "control": "bfloat16",
                          "soft_mismatch": bad / total}), flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
