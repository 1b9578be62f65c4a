"""The control's readings at a cell's own size, for setting the upper
reading of each limit that the control moves (not run by the benchmark's own
runs).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3

For each seed: the cell's recording, made as its driver makes it for the
benchmark's `run_seconds`, through the cell's reference's `control(x, cfg)`
on the card (`psk_ff`: the plain reference in float32 and in bfloat16, the
precision below the configuration's); prints the reference's `CONTROL` and
each number the control reads: the upper reading of that number. The lower
reading is the number in the benchmark's own runs. A reference that defines
no `control` exits 1.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from harness import spec, tx  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args()
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.Cell(a.workload, bench)
    ref = cell.reference
    if not callable(getattr(ref, "control", None)):
        print(f"calibrate: reference {cell.cfg['reference']} defines no "
              "control", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    n = cell.driver.recording_samples(cell.cfg, cell.traffic,
                                      bench["run_seconds"])
    for seed in (int(s) for s in a.seeds.split(",")):
        rec = cell.code.make_recording(cell.cfg, n, seed, "cuda")
        x = tx.cs16_to_complex(rec.iq)
        del rec
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "samples": n, "control": ref.CONTROL,
                          **ref.control(x, cell.cfg)}), flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
