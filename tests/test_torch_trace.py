"""The port's spans and counters (`core/trace.py`) on the CPU: off, they
record nothing and never open a profiler range; on, they nest per thread
with self times and kinds; under a torch profiler they are its
`satdump::<name>` host events; and a MetOp and a FengYun-3 decode record one
`psk_demod.block` a reader block and count the CADUs their .cadu file
holds. Also: `ops.cuda.launch_counts()` lists every kernel wrapper of the
data paths, and a launch that a CUDA graph's replay passes through the
launch path is seen there and launches nothing."""

import copy
import importlib
import pkgutil
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from satdump_tpu_torch import sim
from satdump_tpu_torch.core import trace
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.io.baseband import BasebandReader

BLOCK = 1 << 16


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


class _Spy:
    """Stands in for torch's record_function and notes each range."""
    opened: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Spy.opened.append(self.name)

    def __exit__(self, *exc):
        return False


class _Clock:
    """A host clock that advances by a set step at each read."""

    def __init__(self):
        self.t, self.step = 0, 10

    def perf_counter_ns(self):
        self.t += self.step
        return self.t


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    _Spy.opened = []
    monkeypatch.setattr(trace, "record_function", _Spy)
    assert not trace.active()
    assert trace.span("a") is trace.span("b", "wait")
    with trace.span("psk_demod.block"):
        with trace.span("psk_demod.pick", "wait"):
            pass
    trace.count("decoder.cadus", 5)
    assert trace.totals() == {"spans": {}, "counters": {}}
    assert _Spy.opened == []
    # the two spans that time in any case record nothing either
    times = {"demod": 0.0}
    laps = trace.Laps(times, "live.")
    laps.lap("demod")
    laps.lap()
    with trace.timed("step.x") as t:
        pass
    assert t.ns > 0 and times["demod"] > 0
    assert trace.totals() == {"spans": {}, "counters": {}}
    assert _Spy.opened == []


def test_enabled_spans_nest_with_self_times_kinds_and_counters(
        monkeypatch):
    _Spy.opened = []
    monkeypatch.setattr(trace, "record_function", _Spy)
    clock = _Clock()
    monkeypatch.setattr(trace, "time", clock)
    trace.enable()
    assert trace.active()
    with trace.span("outer"):                       # 10 .. 85
        with trace.span("host_part", "host"):       # 20 .. 30
            pass
        clock.step = 20
        with trace.span("inner"):                   # 50 .. 75
            clock.step = 5
            with trace.span("wait_part", "wait"):   # 55 .. 60
                pass
            with trace.span("wait_part", "wait"):   # 65 .. 70
                pass
        clock.step = 10
    trace.count("cadus", 3)
    trace.count("cadus", 4)
    got = trace.totals()
    spans = got["spans"]
    assert spans["wait_part"] == {"calls": 2, "ns": 10, "self_ns": 10,
                                  "kind": "wait"}
    assert spans["host_part"] == {"calls": 1, "ns": 10, "self_ns": 10,
                                  "kind": "host"}
    inner, outer = spans["inner"], spans["outer"]
    assert inner["kind"] is None and inner["calls"] == 1
    assert inner["self_ns"] == inner["ns"] - 10
    assert outer["self_ns"] == outer["ns"] - inner["ns"] - 10
    assert got["counters"] == {"cadus": 7}
    assert _Spy.opened == []              # no profiler records: no ranges
    trace.reset()
    assert trace.totals() == {"spans": {}, "counters": {}}
    with pytest.raises(ValueError):
        trace.span("x", "io")


def test_a_span_on_another_thread_is_no_child():
    trace.enable()
    done = threading.Event()

    def other():
        with trace.span("other"):
            done.wait(5)
    t = threading.Thread(target=other)
    with trace.span("main"):
        t.start()
        with trace.span("main_child"):
            pass
        done.set()
        t.join()
    spans = trace.totals()["spans"]
    main, child = spans["main"], spans["main_child"]
    assert main["self_ns"] == main["ns"] - child["ns"]
    assert spans["other"]["self_ns"] == spans["other"]["ns"]


def test_threads_lose_no_update():
    """More threads than cores, switching often: every span and count of
    every thread is in the totals."""
    import os
    import sys
    trace.enable()
    n_threads, n = 4 * (os.cpu_count() or 2), 300
    start = threading.Barrier(n_threads)

    def work():
        start.wait(10)
        for _ in range(n):
            with trace.span("outer"):
                with trace.span("inner", "wait"):
                    trace.count("hits", 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = trace.totals()
    assert got["spans"]["outer"]["calls"] == n_threads * n
    assert got["spans"]["inner"]["calls"] == n_threads * n
    assert got["counters"]["hits"] == 2 * n_threads * n
    outer = got["spans"]["outer"]
    assert outer["self_ns"] == outer["ns"] - got["spans"]["inner"]["ns"]


def test_laps_fill_times_and_spans_from_the_same_clock_reads(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(trace, "time", clock)
    trace.enable()
    times = dict.fromkeys(("rebuffer", "demod"), 0.0)
    laps = trace.Laps(times, "live.")
    laps.lap("rebuffer")                   # 10
    laps.lap("demod")                      # 20
    with trace.span("psk_demod.block"):    # 30 .. 40
        pass
    laps.lap("rebuffer")                   # 50
    laps.lap()                             # 60
    spans = trace.totals()["spans"]
    assert times == {"rebuffer": pytest.approx(20e-9),
                     "demod": pytest.approx(30e-9)}
    assert spans["live.rebuffer"]["ns"] == 20
    assert spans["live.demod"] == {"calls": 1, "ns": 30, "self_ns": 20,
                                   "kind": None}


def test_profiler_records_spans_as_nested_host_events_without_enable():
    assert not trace.active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch._C._autograd._profiler_enabled() and trace.active()
        with trace.span("outer"):
            with trace.span("inner", "wait"):
                torch.zeros(4).add_(1)
        trace.count("cadus", 2)
    assert not trace.active()
    ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith(trace.PREFIX)}
    assert set(ev) == {"satdump::outer", "satdump::inner"}
    (o0, o1), (i0, i1) = ev["satdump::outer"], ev["satdump::inner"]
    assert o0 <= i0 <= i1 <= o1
    got = trace.totals()
    assert got["spans"]["inner"]["kind"] == "wait"
    assert got["spans"]["outer"]["calls"] == 1
    assert got["counters"] == {"cadus": 2}


def _spans_opened(monkeypatch):
    """Note, for each span opened, its name, kind and the names and kinds
    of the spans open around it."""
    seen = []
    begin = trace._Span.begin

    def noted(self, t0=None):
        st = getattr(trace._local, "stack", [])
        seen.append((self.name, self.kind,
                     [(s.name, s.kind) for s in st]))
        return begin(self, t0)
    monkeypatch.setattr(trace._Span, "begin", noted)
    return seen


def _metop_run(tmp_path, n_cadus):
    from satdump_tpu_torch.cli import _load_all_pipelines
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    rng = np.random.default_rng(19)
    cadus = sim.make_cadus(n_cadus, rng)
    src = tmp_path / "metop.cf32"
    write_baseband(src, "cf32", sim.ccsds_qpsk_baseband(cadus, rng,
                                                         sim.METOP_SPS))
    _load_all_pipelines()
    pipe = copy.deepcopy(pipeline_registry.get("metop_ahrpt"))
    pipe.steps = pipe.steps[: pipe.level_index("cadu") + 1]
    out = run_pipeline(pipe, str(src), str(tmp_path / "out"),
                       user_params={"torch_device": "cpu",
                                    "samplerate": 6e6,
                                    "buffer_size": BLOCK})
    return cadus, src, out


def test_metop_pipeline_records_a_block_each_read_and_its_cadus(
        tmp_path, monkeypatch):
    from satdump_tpu_torch.ops import ffsync
    seen = _spans_opened(monkeypatch)
    ffsync._CONSTS.clear()
    trace.enable()
    cadus, src, out = _metop_run(tmp_path, 12)
    written = np.fromfile(out, np.uint8)
    assert written.tobytes() == cadus.tobytes()
    got = trace.totals()
    spans = got["spans"]
    blocks = BasebandReader(str(src), "cf32", block_size=BLOCK).num_blocks
    assert blocks > 2
    assert spans["psk_demod.block"]["calls"] == blocks
    for part in ("to_device", "chain", "pick", "snr", "to_host",
                 "quantize", "write"):
        assert spans[f"psk_demod.{part}"]["calls"] == blocks, part
    assert spans["psk_demod.read"]["calls"] == blocks + 1
    assert got["counters"]["decoder.cadus"] == len(written) // 1024
    assert spans["step.psk_demod"]["calls"] == 1
    assert spans["step.metop_ahrpt_decoder"]["calls"] == 1
    assert spans["decoder.lock_search"]["calls"] == 1
    assert spans["decoder.chunk"]["calls"] >= 1
    for name in ("decoder.chain", "decoder.to_host", "decoder.unpack"):
        assert spans[name]["calls"] == spans["decoder.to_device"]["calls"]
    kinds = {n: s["kind"] for n, s in spans.items()}
    assert kinds["psk_demod.tones"] == kinds["psk_demod.rotation"] == "wait"
    # the constants reach the device once in the pass, at its first block
    assert spans["psk_demod.tones"]["calls"] == 3
    assert spans["psk_demod.rotation"]["calls"] == 1
    assert "psk_demod.cfo_peak" not in spans
    assert kinds["decoder.unpack"] == kinds["decoder.read"] == "host"
    # a wait opens inside no other wait; every part of a block inside it
    for name, kind, around in seen:
        if kind == "wait":
            assert "wait" not in [k for _, k in around], (name, around)
        if name.startswith("psk_demod.") and name not in (
                "psk_demod.block", "psk_demod.read", "psk_demod.write"):
            assert ("psk_demod.block", None) in around, name
        if name.startswith("decoder."):
            assert around[0] == ("step.metop_ahrpt_decoder", None), name
    # self times: the steps cover the blocks and chunks inside them
    step = spans["step.psk_demod"]
    assert step["self_ns"] == step["ns"] - spans["psk_demod.block"]["ns"] \
        - spans["psk_demod.read"]["ns"] - spans["psk_demod.write"]["ns"]


def test_fy3_decoder_counts_the_cadus_it_writes(tmp_path, rng):
    """Dual-rail softs as tests/test_torch_fengyun3.py makes them: each
    rail's lock search and decode, the host steps, and the count."""
    from satdump_tpu_torch.models import fengyun3 as tfy
    from satdump_tpu_torch.ops.fec import convolutional as cc
    from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
    cadus = sim.make_cadus(6, rng)
    tx = cadus.copy()
    tx[:, 4:] = derand_ccsds(tx[:, 4:])
    x, y = sim.fengyun_diff_encode(np.concatenate(
        [np.unpackbits(tx.reshape(-1)), rng.integers(0, 2, 512)]))
    chan = np.empty(4 * len(x), np.uint8)
    chan[0::2] = cc.conv_encode_batch(1 - y)
    chan[1::2] = cc.conv_encode_batch(x)
    sim.soft_stream(chan, rng, prefix=1001).tofile(tmp_path / "f.soft")
    trace.enable()
    mod = tfy.FengyunAHRPTDecoderModule(str(tmp_path / "f.soft"),
                                        str(tmp_path / "fy"),
                                        {"torch_device": "cpu"})
    mod.process()
    written = np.fromfile(mod.d_output_file, np.uint8)
    assert written.tobytes() == cadus.tobytes()
    got = trace.totals()
    spans = got["spans"]
    assert got["counters"]["decoder.cadus"] == len(written) // 1024 == 6
    assert spans["decoder.rail"]["calls"] == 2
    assert spans["decoder.lock_search"]["calls"] == 2
    assert spans["decoder.to_host"]["calls"] == 2
    for name in ("read", "diff_decode", "deframe", "derand", "rs", "write"):
        assert spans[f"decoder.{name}"]["kind"] == "host", name
    assert spans["decoder.diff_decode"]["calls"] == 2


def test_fy3_psk_demod_blocks_upload_no_tables_and_read_no_bank(tmp_path):
    """FY-3D's psk_demod (sps 3: the strip pick) over a three-block stream:
    the bank and its tap polynomials reach the device once, when the
    module builds; no block reads the bank back or uploads a polynomial
    row, so each records the 4 waits of any block (to_device, pick, snr,
    to_host), and the first also the 4 uploads of the chain's constants
    (3 timing tones, the V&V rotation), as MetOp's K2 path does."""
    from satdump_tpu_torch.ops import ffsync
    from satdump_tpu_torch.pipeline.modules.demod.psk import PSKDemodModule
    rng = np.random.default_rng(29)
    mod = PSKDemodModule(str(tmp_path / "x.cf32"), str(tmp_path / "fy"), {
        "samplerate": 90e6, "symbolrate": 30e6, "constellation": "qpsk",
        "rrc_alpha": 0.35, "pll_bw": 0.002, "buffer_size": BLOCK,
        "torch_device": "cpu"})
    syms = sim.bits_to_qpsk_symbols(rng.integers(0, 2, 2 * BLOCK
                                                 ).astype(np.uint8))
    x = sim.ChannelModel(snr_db=18.0, freq_offset=1e-4, phase=0.4,
                         seed=5).apply(sim.qpsk_modulate_rational(
                             syms, 3, 1, rrc_alpha=0.35))
    ffsync._CONSTS.clear()
    trace.enable()
    mod.stream_start()
    assert mod.final_sps == 3.0 and mod.block_size == BLOCK
    built = dict(ffsync._CONSTS)
    tables = {k[0]: v for k, v in built.items()}
    assert len(tables) == len(built) == 2
    assert tables["bank"].shape == (128, 8)
    assert tables["bank_coefs"].shape == (11, 8)
    softs = [mod.stream_work(x[b * BLOCK: (b + 1) * BLOCK])
             for b in range(3)]
    assert sum(len(s) for s in softs) > 0.95 * 2 * 3 * BLOCK / 3
    # the blocks keep the tables and add only the chain's constants
    assert all(ffsync._CONSTS[k] is v for k, v in built.items())
    assert {k[0] for k in ffsync._CONSTS.keys() - built.keys()} == {
        "tones", "rotation"}
    spans = trace.totals()["spans"]
    assert spans["psk_demod.block"]["calls"] == 3
    assert "psk_demod.bank" not in spans
    assert "psk_demod.strip_taps" not in spans
    waits = sum(v["calls"] for k, v in spans.items()
                if k.startswith("psk_demod.") and v["kind"] == "wait")
    assert waits == 3 * 4 + 4
    for part in ("to_device", "pick", "snr", "to_host"):
        assert spans[f"psk_demod.{part}"]["calls"] == 3, part


def test_live_push_parts_are_spans_around_the_modules(tmp_path):
    from satdump_tpu_torch.pipeline.live import TIMED_PARTS, LivePipeline
    from satdump_tpu_torch.pipeline.pipeline import Pipeline, PipelineStep
    rng = np.random.default_rng(23)
    bb = sim.ccsds_qpsk_baseband(sim.make_cadus(8, rng), rng, sim.METOP_SPS)
    pipe = Pipeline(id="live_trace", name="Live trace", steps=[
        PipelineStep("baseband", ""),
        PipelineStep("soft", "psk_demod", {
            "constellation": "qpsk", "symbolrate": 2333333,
            "rrc_alpha": 0.5, "pll_bw": 0.003}),
        PipelineStep("cadu", "metop_ahrpt_decoder", {})], parameters={})
    lp = LivePipeline(pipe, str(tmp_path), user_params={
        "torch_device": "cpu", "samplerate": 6e6, "buffer_size": BLOCK})
    lp.start()
    trace.enable()
    for off in range(0, len(bb), 40_000):
        lp.push(bb[off: off + 40_000])
    trace.disable()
    lp.stop()
    spans = trace.totals()["spans"]
    for part in TIMED_PARTS:
        assert f"live.{part}" in spans, part
    blocks = spans["live.demod"]["calls"]
    assert blocks == spans["psk_demod.block"]["calls"] > 0
    assert spans["live.decoder"]["calls"] == blocks
    demod = spans["live.demod"]
    assert demod["self_ns"] == demod["ns"] - spans["psk_demod.block"]["ns"]
    assert spans["live.decoder"]["self_ns"] < spans["live.decoder"]["ns"]
    # times holds at least what the traced pushes recorded, part by part
    for part in TIMED_PARTS:
        assert lp.times[part] * 1e9 >= spans[f"live.{part}"]["ns"] - 1


def _wrappers():
    """Every function under ops/cuda/ that carries a `launches` count."""
    import satdump_tpu_torch.ops.cuda as pkg
    found = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            if isinstance(obj, types.FunctionType) and \
                    hasattr(obj, "launches") and obj.__module__ == \
                    mod.__name__:
                found[name] = obj
    return found


def test_launch_counts_list_every_kernel_wrapper_of_the_data_paths():
    from satdump_tpu_torch.ops.cuda import launch_counts
    wrappers = _wrappers()
    assert {"viterbi_block_acs", "viterbi_block_traceback",
            "gardner_walk"} <= set(wrappers)
    # the toolchain probe lies on no data path
    assert set(launch_counts()) == set(wrappers) - {"affine_probe"}
    assert launch_counts() == {k: w.launches for k, w in wrappers.items()
                               if k != "affine_probe"}


def test_count_launches_adds_to_each_wrapper_named():
    from satdump_tpu_torch.ops.cuda import count_launches, launch_counts
    before = launch_counts()
    count_launches({"resample_arith_grid": 3, "viterbi_re": 1})
    after = launch_counts()
    assert after.pop("resample_arith_grid") == \
        before.pop("resample_arith_grid") + 3
    assert after.pop("viterbi_re") == before.pop("viterbi_re") + 1
    assert after == before
    count_launches({"resample_arith_grid": -3, "viterbi_re": -1})


def test_a_replayed_launch_passes_the_launch_path_and_launches_nothing(
        monkeypatch):
    """`Kernel(REPLAYED, *args)`, how a CUDA graph's replay reports a
    launch that it made (ops/cuda/graph.py): whatever wraps
    `Kernel.__call__` sees the arguments, and nothing is built, loaded or
    launched; nor is it listed by `recording()`, which lists the launches
    made."""
    from satdump_tpu_torch.ops.cuda import _build
    from satdump_tpu_torch.ops.cuda.resample import _KERNEL
    seen = []
    orig = _build.Kernel.__call__

    def hook(self, device_index, *args):
        seen.append((self.entry, device_index, args))
        return orig(self, device_index, *args)
    monkeypatch.setattr(_build.Kernel, "__call__", hook)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(name))
    with _build.recording() as made:
        assert _KERNEL(_build.REPLAYED, 1, 2, 3) is None
    assert seen == [("resample_arith", _build.REPLAYED, (1, 2, 3))]
    assert made == [] and _KERNEL._fn is None
