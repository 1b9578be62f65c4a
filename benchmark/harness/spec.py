"""Finding a cell's pieces by the names in BENCHMARK.json.

A configuration is `configs/<config>.json`; it names its code module
(`codes/<code>.py`), whose `make_recording(cfg, n_samples, seed, device)`
makes the link's recording (`tx.Recording`), and its plain reference
(`reference/<reference>.py`), whose `check(run, driver)` decides `correct`.
Neither the drivers nor `run.py` name a code module or a reference, so a
link of another kind is new files too. A traffic mix is
`traffic/<traffic>.json`; it names its driver (`drivers/<driver>.py`).
Every metric, end to end or per layer, is a reader `metrics/<name>.py`, and
every kernel with a roofline is `roofline/<wrapper>.py`. Adding any of them
adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# compared by whole top-level names: the port's package name begins with
# the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "satdump_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at `path` as a module named by its path under the
    benchmark (a name may hold dots, so it is not imported by name)."""
    name = "benchmark_" + str(path.relative_to(BENCH).with_suffix("")) \
        .replace("/", "_").replace(".", "_")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


class Cell:
    """One entry of `workloads`, with its configuration, traffic, driver
    and the metrics it reports."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec or load_json(ROOT / "BENCHMARK.json")
        hits = [w for w in spec["workloads"] if w["name"] == name]
        if not hits:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = hits[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = [c for c in spec["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.cfg = load_json(ROOT / entry["file"])
        self.traffic = load_json(BENCH / "traffic" /
                                 f"{self.workload['traffic']}.json")
        self.code = load_module(BENCH / "codes" /
                                f"{self.cfg['signal']['code']}.py")
        self.reference = load_module(BENCH / "reference" /
                                     f"{self.cfg['reference']}.py")
        self.driver = load_module(BENCH / "drivers" /
                                  f"{self.traffic['driver']}.py")
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def reader(self, metric: dict):
        return load_module(BENCH / "metrics" / f"{metric['name']}.py")


def rooflines() -> dict:
    """{wrapper name: module} of every file under roofline/."""
    return {p.stem: load_module(p)
            for p in sorted((BENCH / "roofline").glob("*.py"))}
