"""Command-line interface of the port — the `pipeline`, `module`, `list`
and `process` subcommands of satdump_tpu's CLI (ref
src-core/core/cli/cli.cpp:41-56):

* ``pipeline <id> <level> <input> <output> [--key value ...]`` — run a
  processing pipeline from a data level; per-pipeline flags are free-form
  key/value pairs merged over the pipeline's editable parameters, the same
  auto-flag contract as core/cli/pipeline.cpp:12-48.
* ``list`` — pipelines + registered modules (replaces the GUI browsing).
* ``module <id> <input> <output> [--key value ...]`` — run one module by id
  (ref core/cli/module.cpp:8).
* ``process <dataset.json|product dir> [output]`` — render the composites
  of saved products (ref products processing).
Every module, and ``process``, takes ``--torch_device cuda|cpu`` (default
cuda).

Usage: ``python -m satdump_tpu_torch <subcommand> ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from satdump_tpu_torch.core.log import logger


def _parse_value(v: str):
    """Parse a CLI value: JSON first (numbers/bools/lists), then notated
    units ("6M", "1701.3 MHz" -> Hz, ref utils/unit_parser.cpp), else
    string."""
    try:
        return json.loads(v)
    except (json.JSONDecodeError, ValueError):
        pass
    from satdump_tpu_torch.utils.units import parse_frequency
    f = parse_frequency(v)
    return v if f is None else f


def _collect_kv(extra: List[str]) -> dict:
    """--key value / --key=value / bare --flag (=true) pairs -> dict."""
    out = {}
    i = 0
    while i < len(extra):
        tok = extra[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument '{tok}' (expected --key value)")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            out[key] = _parse_value(val)
            i += 1
        elif i + 1 < len(extra) and not extra[i + 1].startswith("--"):
            out[key] = _parse_value(extra[i + 1])
            i += 2
        else:
            out[key] = True
            i += 1
    return out


def _load_all_pipelines(extra_dirs: Optional[List[str]] = None) -> None:
    from satdump_tpu_torch.pipeline.pipeline import load_pipelines_dir
    roots = [Path(__file__).resolve().parent.parent / "resources" / "pipelines"]
    roots += [Path(d) for d in (extra_dirs or [])]
    for r in roots:
        if r.is_dir():
            load_pipelines_dir(r)


def cmd_pipeline(args, extra: List[str]) -> int:
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry
    from satdump_tpu_torch.pipeline.runner import run_pipeline

    _load_all_pipelines([args.pipelines_dir] if args.pipelines_dir else None)
    try:
        pipe = pipeline_registry.get(args.id)
    except Exception:
        logger.error(f"unknown pipeline '{args.id}' (see `list`)")
        return 2
    params = _collect_kv(extra)
    run_pipeline(pipe, args.input, args.output, user_params=params,
                 start_level=args.level)
    return 0


def cmd_list(args, extra: List[str]) -> int:
    from satdump_tpu_torch.pipeline.module import (module_registry,
                                             register_all_modules)
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry

    _load_all_pipelines([args.pipelines_dir] if args.pipelines_dir else None)
    register_all_modules()
    print("pipelines:")
    for pid in sorted(k for k, _ in pipeline_registry.items()):
        p = pipeline_registry.get(pid)
        levels = " -> ".join(s.level for s in p.steps)
        print(f"  {pid:28s} {p.name:32s} [{levels}]")
    print("modules:")
    for mid in sorted(k for k, _ in module_registry.items()):
        print(f"  {mid}")
    return 0


def cmd_module(args, extra: List[str]) -> int:
    from satdump_tpu_torch.pipeline.module import (module_registry,
                                             register_all_modules)
    register_all_modules()
    try:
        cls = module_registry.get(args.id)
    except Exception:
        logger.error(f"unknown module '{args.id}' (see `list`)")
        return 2
    params = _collect_kv(extra)
    mod = cls(args.input, args.output, params)
    mod.init()
    mod.process()
    mod.stop()
    stats = mod.getModuleStats()
    if stats:
        print(json.dumps(stats))
    return 0


def cmd_process(args, extra: List[str]) -> int:
    from satdump_tpu_torch.products.processor import process_path
    out = process_path(args.input, args.output, device=args.torch_device)
    print(out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="satdump_tpu_torch",
        description="Satellite baseband decoding framework (PyTorch/CUDA)")
    ap.add_argument("--pipelines-dir", help="extra pipelines directory")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pipeline", help="run a processing pipeline")
    p.add_argument("id")
    p.add_argument("level", help="input data level (baseband/soft/cadu/...)")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("list", help="list pipelines and modules")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("module", help="run a single module by id")
    p.add_argument("id")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_module)

    p = sub.add_parser("process", help="process saved products/datasets")
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument("--torch_device", default="cuda",
                   help="device of the composites: cuda (default) or cpu")
    p.set_defaults(fn=cmd_process)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    return args.fn(args, extra)


if __name__ == "__main__":
    raise SystemExit(main())
