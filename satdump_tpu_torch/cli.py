"""Command-line interface of the port — the `pipeline`, `module`, `list`,
`process`, `ingest`, `probe`, `bench`, `record`, `autotrack`, `fanin`,
`bitview` and `live` subcommands of satdump_tpu's CLI (ref
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
* ``ingest <files...> -o <dir> [--process]`` — agency level-1 files
  (SEVIRI .nat, Himawari HSD, netCDF / HDF5 with h5py) to products, and
  with ``--process`` their composites.
* ``probe`` — the torch devices (ref core/cli/probe.cpp:9).
* ``bench [--category NAME ...] [--n N]`` — per-stage throughput, one JSON
  line a category (ref dsp_bench, src-core/dsp/benchmark/bench.cpp:33-47).
* ``record <tcp://host:port> <file>`` — record a remote-IQ stream.
* ``live <id> <tcp://host:port|file://path> <output>`` — live decode, with
  ``--vfo name:offset_hz:pipeline_id`` (repeatable) for N pipelines behind
  a channelizer, ``--http-port`` for /status.
* ``autotrack <config.json> [--dry-run]`` — the headless ground station.
* ``fanin <output> --publishers N`` — merge CADU streams from N sites.
* ``bitview <file> -o <png>`` — a bit stream as a raster, its frame period
  found when not given.
Every module, ``process``, ``ingest``, ``probe``, ``bench`` and ``live``
take ``--torch_device cuda|cpu`` (default cuda).

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


def cmd_ingest(args, extra: List[str]) -> int:
    """Firstparty archive files (.nat/HSD/.nc/HDF) -> products (+ optional
    composite processing on --torch_device), ref
    plugins/firstparty_support/main_loader.cpp. The last line is JSON: the
    products and the host seconds of parse, save and processor."""
    import time

    from satdump_tpu_torch.products.firstparty import ingest_files
    from satdump_tpu_torch.products.product import DataSet
    from satdump_tpu_torch.utils.device import resolve_device

    if args.process:      # before any work: a missing card raises here
        resolve_device(args.torch_device)
    t0 = time.perf_counter()
    prods = ingest_files(args.inputs)
    if not prods:
        print("no products recognized", file=sys.stderr)
        return 1
    t1 = time.perf_counter()
    ds = DataSet()
    used = set()
    for p in prods:
        name = base = p.instrument_name or "product"
        i = 1
        while name in used:       # two same-instrument products must not
            i += 1                # overwrite each other's directory
            name = f"{base}_{i}"
        used.add(name)
        sub = Path(args.output) / name
        p.save(str(sub))
        ds.products_list.append(name)
        if p.has_product_source() and not ds.satellite_name:
            ds.satellite_name = p.get_product_source()
        if p.has_product_timestamp() and ds.timestamp < 0:
            ds.timestamp = p.get_product_timestamp()
    print(ds.save(args.output))
    t2 = time.perf_counter()
    written = []
    if args.process:
        from satdump_tpu_torch.products.processor import process_path
        written = process_path(args.output, device=args.torch_device)
        for f in written:
            print(f)
    print(json.dumps({"products": ds.products_list, "composites": len(written),
                      "parse_s": t1 - t0, "save_s": t2 - t1,
                      "process_s": time.perf_counter() - t2}))
    return 0


def cmd_probe(args, extra: List[str]) -> int:
    """The torch devices, in satdump_tpu's `probe` JSON shape (platform
    "gpu" for a CUDA device); the CPU only when asked."""
    import torch

    from satdump_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.torch_device)
    if dev.type == "cuda":
        info = [{"id": i, "platform": "gpu",
                 "kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())]
    else:
        info = [{"id": 0, "platform": "cpu", "kind": "cpu"}]
    print(json.dumps({"device_count": len(info), "devices": info}))
    return 0


def cmd_bench(args, extra: List[str]) -> int:
    from satdump_tpu_torch.bench import run_bench
    run_bench(categories=args.category or None, n=args.n,
              device=args.torch_device)
    return 0


def _remote_iq_client(spec: str):
    from satdump_tpu_torch.io.net import RemoteIQClient
    host, port = spec[6:].rsplit(":", 1)
    return RemoteIQClient(host, int(port))


def cmd_record(args, extra: List[str]) -> int:
    """Record a remote-IQ stream to a baseband file (the recorder app's
    headless core, src-interface/recorder + legacy record)."""
    import numpy as np

    client = _remote_iq_client(args.source)
    ext = args.output.rsplit(".", 1)[-1].lower()
    total = 0
    chunks = []
    for blk in client.blocks():
        chunks.append(blk)
        total += len(blk)
        if args.max_samples and total >= args.max_samples:
            break
    client.close()
    samples = np.concatenate(chunks) if chunks else np.zeros(0, np.complex64)
    if args.max_samples:
        samples = samples[: args.max_samples]
    if ext == "ziq":
        from satdump_tpu_torch.io.ziq import write_ziq
        write_ziq(args.output, samples, samplerate=args.samplerate)
    else:
        from satdump_tpu_torch.io import write_baseband
        write_baseband(args.output, ext, samples,
                       samplerate=args.samplerate)
    print(json.dumps({"samples": int(len(samples)), "file": args.output}))
    return 0


def cmd_autotrack(args, extra: List[str]) -> int:
    """Headless automated ground station (ref src-cli/legacy/autotrack):
    config JSON {qth:{lat,lon,alt}, tle_file, satellites:[{norad,
    frequency, pipeline, min_elevation}], source, output, params}. Computes
    the pass schedule; with --dry-run prints it and exits, else engages the
    scheduler: each AOS starts a live pipeline on the source until LOS."""
    import time as _time

    from satdump_tpu_torch.geo.tle import parse_tle_file
    from satdump_tpu_torch.tracking.scheduler import (AutoTrackScheduler,
                                                      TrackedObject)

    cfg = json.loads(Path(args.config).read_text())
    qth = cfg["qth"]
    tles = {t.norad: t for t in parse_tle_file(cfg["tle_file"])}
    sched = AutoTrackScheduler(qth["lat"], qth["lon"],
                               qth.get("alt_km", 0.0),
                               multi_mode=cfg.get("multi_mode", False))
    for s in cfg["satellites"]:
        sched.track(TrackedObject(
            norad=int(s["norad"]), tle=tles[int(s["norad"])],
            frequency_hz=float(s.get("frequency", 0)),
            pipeline_id=s.get("pipeline", ""),
            min_elevation=float(s.get("min_elevation", 0))))
    t0 = float(cfg.get("start_time", _time.time()))
    sched.compute_passes(t0, horizon_s=float(cfg.get("horizon_s", 43200)))
    sel = sched.upcoming_sel
    print(json.dumps({"passes": [
        {"norad": p.norad, "aos": p.aos, "los": p.los,
         "max_elevation": round(p.max_elevation, 1)} for p in sel]}))
    if args.dry_run:
        return 0

    _load_all_pipelines([args.pipelines_dir] if args.pipelines_dir else None)
    from satdump_tpu_torch.pipeline.live import LivePipeline
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry

    running: dict = {}

    def on_aos(p, obj):
        pipe = pipeline_registry.get(obj.pipeline_id)
        out = f"{cfg['output']}/{p.norad}_{int(p.aos)}"
        lp = LivePipeline(pipe, out, user_params=dict(
            cfg.get("params", {}),
            freq_shift=obj.frequency_hz - float(cfg.get("center_freq",
                                                        obj.frequency_hz))))
        lp.start()
        running[p.norad] = lp
        logger.info(f"AOS {p.norad}: live pipeline {obj.pipeline_id} -> {out}")

    def on_los(p, obj):
        lp = running.pop(p.norad, None)
        if lp:
            outs = lp.stop()
            logger.info(f"LOS {p.norad}: outputs {outs}")

    sched.aos_callback = on_aos
    sched.los_callback = on_los

    client = _remote_iq_client(cfg["source"])
    status = None
    if args.http_port is not None:
        from satdump_tpu_torch.core.http_status import StatusServer
        status = StatusServer(
            lambda: {"passes": len(sel),
                     "active": {str(k): v.stats for k, v in running.items()}},
            port=args.http_port)
        status.start()
    try:
        for blk in client.blocks():
            sched.tick(_time.time())
            for lp in running.values():
                lp.push(blk)
    finally:
        for lp in list(running.values()):
            lp.stop()
        client.close()
        if status:
            status.stop()
    return 0


def cmd_fanin(args, extra: List[str]) -> int:
    """Multi-site ingest merge (io/fanin.py): N sites publish CADUs over
    the framed transport; one deduplicated stream comes out."""
    from satdump_tpu_torch.io.fanin import FrameFanInServer
    srv = FrameFanInServer(port=args.port, host=args.host,
                           cadu_size=args.cadu_size)
    srv.start(n_publishers=args.publishers)
    print(json.dumps({"port": srv.port}), flush=True)
    n = 0
    with open(args.output, "wb") as f:
        for cadu in srv.frames(timeout=3600.0):
            f.write(cadu.tobytes())
            n += 1
    srv.close()
    print(json.dumps({"frames": n, "stats": srv.stats}))
    return 0


def cmd_bitview(args, extra: List[str]) -> int:
    """Headless BitView (ref plugins/bitview_app): raster + period
    autodetect for unknown bit streams (host)."""
    from satdump_tpu_torch.utils.bitview import run_bitview
    info = run_bitview(args.file, args.output, period=args.period,
                       soft=args.soft, diff=args.diff, reverse=args.reverse)
    print(json.dumps(info))
    return 0


def _file_blocks(src: str, params: dict, block_size: int):
    from satdump_tpu_torch.io.baseband import BasebandReader
    path = src[7:] if src.startswith("file://") else src
    reader = BasebandReader(path, str(params.get("baseband_format", "cf32")),
                            block_size=block_size)
    for blk in reader.blocks():
        yield blk.samples[: blk.valid]


def _cmd_live_multivfo(args, params: dict) -> int:
    """N simultaneous per-VFO live pipelines from one stream
    (ref recorder.h:174-178 add_vfo_live): --vfo name:offset_hz:pipeline."""
    from satdump_tpu_torch.pipeline.multivfo import MultiVFOLive
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry

    samplerate = float(params.get("samplerate", 0) or 0)
    if not samplerate:
        logger.error("multi-VFO live needs --samplerate")
        return 2
    mv = MultiVFOLive(samplerate, args.output,
                      block_size=int(params.get("buffer_size", 1 << 18)),
                      user_params={k: v for k, v in params.items()
                                   if k != "samplerate"})
    for spec in args.vfo:
        try:
            name, off, pid = spec.split(":", 2)
            pipe = pipeline_registry.get(pid)
        except Exception:
            logger.error(f"bad --vfo spec '{spec}' "
                         "(want name:freq_offset_hz:pipeline_id)")
            return 2
        mv.add_vfo(name, float(off), pipe)

    src = args.source
    if src.startswith("tcp://"):
        client = _remote_iq_client(src)
        for blk in client.blocks():
            mv.push(blk)
        client.close()
    else:
        for blk in _file_blocks(src, params, mv.block_size):
            mv.push(blk)
    outs = mv.stop()
    print(json.dumps({"outputs": outs, "stats": mv.stats,
                      "channelizer": mv.chan.stats}))
    return 0


def cmd_live(args, extra: List[str]) -> int:
    """Live decode from a streaming source (ref src-cli/legacy/live.cpp):
    source spec `tcp://host:port` (remote-IQ protocol) or `file://path`
    (throttle-free playback). Optional --http-port serves /status JSON."""
    from satdump_tpu_torch.pipeline.live import LivePipeline
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry

    _load_all_pipelines([args.pipelines_dir] if args.pipelines_dir else None)
    params = _collect_kv(extra)

    if args.vfo:
        return _cmd_live_multivfo(args, params)

    try:
        pipe = pipeline_registry.get(args.id)
    except Exception:
        logger.error(f"unknown pipeline '{args.id}' (see `list`)")
        return 2
    src = args.source
    if not (src.startswith(("tcp://", "file://")) or "://" not in src):
        logger.error(f"unknown source spec '{src}'")
        return 2
    lp = LivePipeline(pipe, args.output, user_params=params)

    status_srv = None
    if args.http_port is not None:
        from satdump_tpu_torch.core.http_status import StatusServer
        status_srv = StatusServer(lambda: lp.stats, port=args.http_port)
        status_srv.start()
        logger.info(f"HTTP status on :{status_srv.port}/status")

    try:
        if src.startswith("tcp://"):
            client = _remote_iq_client(src)
            outs = lp.run_source(client.blocks())
            client.close()
            stats = dict(lp.stats, source=client.stats)
        else:
            lp.start()
            for blk in _file_blocks(src, params, lp.block_size):
                lp.push(blk)
            outs = lp.stop()
            stats = lp.stats
    finally:
        if status_srv is not None:
            status_srv.stop()
    print(json.dumps({"outputs": outs, "stats": stats}))
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

    p = sub.add_parser("ingest",
                       help="ingest firstparty files (.nat/HSD/.nc/HDF)")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--process", action="store_true",
                   help="also run the products processor (composites)")
    p.add_argument("--torch_device", default="cuda",
                   help="device of the composites: cuda (default) or cpu")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("probe", help="list the torch devices")
    p.add_argument("--torch_device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("bench", help="per-stage throughput benchmark")
    p.add_argument("--category", action="append",
                   help="bench category (repeatable); default all")
    p.add_argument("--n", type=int, default=1 << 20,
                   help="samples per block")
    p.add_argument("--torch_device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("record",
                       help="record a streaming source to a baseband file")
    p.add_argument("source", help="tcp://host:port (remote-IQ protocol)")
    p.add_argument("output", help="output file (.cf32/.cs16/.cs8/.ziq)")
    p.add_argument("--samplerate", type=float, default=0)
    p.add_argument("--max-samples", type=int, default=0)
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("autotrack",
                       help="headless automated ground station")
    p.add_argument("config", help="autotrack config JSON")
    p.add_argument("--dry-run", action="store_true",
                   help="print the pass schedule and exit")
    p.add_argument("--http-port", type=int, default=None)
    p.set_defaults(fn=cmd_autotrack)

    p = sub.add_parser("fanin",
                       help="merge CADU streams from N receive sites")
    p.add_argument("output", help="merged .cadu output file")
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral, printed)")
    p.add_argument("--publishers", type=int, required=True,
                   help="number of site connections to accept")
    p.add_argument("--cadu-size", type=int, default=1024)
    p.add_argument("--host", default="0.0.0.0")
    p.set_defaults(fn=cmd_fanin)

    p = sub.add_parser("bitview",
                       help="render/analyze a raw bit stream "
                            "(ref bitview_app)")
    p.add_argument("file")
    p.add_argument("-o", "--output", default="bitview.png")
    p.add_argument("--period", type=int, default=None,
                   help="bit period (row width); omit to auto-detect")
    p.add_argument("--soft", action="store_true",
                   help="input is signed soft bytes (soft2hard first)")
    p.add_argument("--diff", action="store_true",
                   help="NRZ-M differential decode")
    p.add_argument("--reverse", action="store_true",
                   help="reverse bit order within bytes")
    p.set_defaults(fn=cmd_bitview)

    p = sub.add_parser("live", help="live decode from a streaming source")
    p.add_argument("id", help="pipeline id ('-' with --vfo for VFO-only)")
    p.add_argument("source", help="tcp://host:port or file://path")
    p.add_argument("output")
    p.add_argument("--http-port", type=int, default=None,
                   help="serve /status JSON on this port (0 = ephemeral)")
    p.add_argument("--vfo", action="append", default=[], metavar="SPEC",
                   help="add a VFO live pipeline: name:freq_offset_hz:"
                        "pipeline_id (repeatable; the wideband stream is "
                        "channelized, ref recorder.h add_vfo_live)")
    p.set_defaults(fn=cmd_live)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_parser()
    args, extra = ap.parse_known_args(argv)
    return args.fn(args, extra)


if __name__ == "__main__":
    raise SystemExit(main())
