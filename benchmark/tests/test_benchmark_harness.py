"""The benchmark's harness on the CPU at tiny sizes: BENCHMARK.json against
the contract's limits, the configurations against their pipeline files,
each configuration's code module (its recording) and reference (its
`check`), the generator, the plain reference and its control, the kernels'
counts, the import check, a dry run of every cell, the checks against the
loop they replaced, a run with the timed path broken underneath for each
fault a cell can have, planted by level and frame width, and a
configuration of another kind added to a copy of the benchmark as new files
and entries only."""

import builtins
import copy
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import run as bench
from harness import check, program, spec, trace, tx
from reference import psk_ff

SPEC = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
CONFIG_FILES = {c["name"]: spec.ROOT / c["file"] for c in SPEC["configs"]}
# the configurations whose reference is the soft-symbol demodulator, and
# their cells
PSK_FF = [n for n in CONFIGS
          if spec.load_json(CONFIG_FILES[n])["reference"] == "psk_ff"]
PSK_FF_CELLS = [w["name"] for w in SPEC["workloads"]
                if w["config"] in PSK_FF]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
# dry-run sizes: ~2.5 demod blocks offline; live: 2^14-sample chunks, one
# block of warm-up, a short flush
TINY = {"samples": 655360, "warmup_samples": 262144, "chunk_samples": 16384,
        "warmup_chunks": 16, "recording_factor": 1.0, "flush_chunks": 48,
        "trace_sessions": 1, "pushes_per_session": 4}
SEED = 2 ** 31 + 12345


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_one_line(w) for w in SPEC["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"])
        assert NAME.fullmatch(w["traffic"]) and w["config"] in CONFIGS
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_pieces_and_reports_enough(cell):
    c = spec.Cell(cell, SPEC)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m).read)
        if "workloads" in m and m in c.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", CONFIGS)
def test_config_follows_its_pipeline_file(name):
    entry = [c for c in SPEC["configs"] if c["name"] == name][0]
    cfg = spec.load_json(spec.ROOT / entry["file"])
    levels = cfg["levels"]
    program.pipeline(cfg, levels[0], levels[-1])    # raises on a mismatch
    p, s = cfg["pipeline_parameters"], cfg["signal"]
    mid = p[levels[1]]
    assert s["samplerate"] == p["samplerate"]
    if "sps" in s:
        up, down = s["sps"]
        assert abs(up / down - p["samplerate"] / mid["symbolrate"]) < 1e-6
    if "rrc_alpha" in s:
        assert s["rrc_alpha"] == mid["rrc_alpha"]
    assert set(entry["reduced"]) <= set(cfg["reduced_from"])


def _config(name):
    cfg = spec.load_json(CONFIG_FILES[name])
    return cfg, spec.load_module(spec.BENCH / "codes" /
                                 f"{cfg['signal']['code']}.py")


@pytest.mark.parametrize("name", CONFIGS)
def test_config_names_a_code_that_records_and_a_reference_that_checks(name):
    cfg, code = _config(name)
    ref = spec.load_module(spec.BENCH / "reference" /
                           f"{cfg['reference']}.py")
    assert callable(code.make_recording) and callable(ref.check)
    assert set(ref.READS) == set(cfg["levels"][1:])
    c = spec.Cell([w["name"] for w in SPEC["workloads"]
                   if w["config"] == name][0], SPEC)
    assert c.code is code and c.reference is ref


@pytest.mark.parametrize("seed", (SEED, 7))
@pytest.mark.parametrize("name", PSK_FF)
def test_code_module_makes_the_qpsk_recording(name, seed):
    """The QPSK links' code modules give what the shared QPSK transmitter
    gives with their channel coding, bit for bit."""
    cfg, code = _config(name)
    a = code.make_recording(cfg, 50000, seed, "cpu")
    b = tx.make_recording(cfg, code.channel_bits, 50000, seed, "cpu")
    assert torch.equal(a.iq, b.iq) and a.iq.shape == (50000, 2)
    assert np.array_equal(a.cadus, b.cadus)
    assert np.array_equal(a.cadu_end, b.cadu_end)
    assert a.samplerate == b.samplerate == cfg["signal"]["samplerate"]


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_is_deterministic_in_the_seed(name):
    cfg, code = _config(name)
    a = code.make_recording(cfg, 50000, SEED, "cpu")
    b = code.make_recording(cfg, 50000, SEED, "cpu")
    c = code.make_recording(cfg, 50000, SEED + 1, "cpu")
    assert torch.equal(a.iq, b.iq) and (a.cadus == b.cadus).all()
    assert not torch.equal(a.iq, c.iq)
    assert (a.cadus[:, :4] == tx.ASM).all()


def test_rs_encoder_gives_codewords():
    """Each codeword's syndromes vanish: evaluated at the generator's
    roots, in the conventional basis."""
    gen = tx.generator(SEED, "cpu")
    cw = tx.make_cadus(3, gen)[:, 4:].numpy().reshape(3, 255, 4)
    exp, mul = tx._gf_tables()
    _, from_dual = tx._dual_tables()
    for k in range(4):
        for row in from_dual[cw[:, :, k]]:
            for j in range(32):
                root = exp[(tx.RS_PRIM * (tx.RS_FCR + j)) % 255]
                acc = 0
                for byte in row:
                    acc = mul[acc, root] ^ byte
                assert acc == 0


@pytest.mark.parametrize("name", PSK_FF)
def test_reference_demodulates_the_generator(name):
    """At 18 dB the reference's hard decisions are the channel bits sent,
    up to QPSK's four rotations and a few symbols of offset."""
    cfg, code = _config(name)
    rec = code.make_recording(cfg, 300000, SEED, "cpu")
    soft, lens = psk_ff.demod(tx.cs16_to_complex(rec.iq), cfg)
    assert lens.sum() == len(soft)
    gen = tx.generator(SEED, "cpu")
    cadus = tx.make_cadus(len(rec.cadus), gen, cfg["signal"]["rs_depth"])
    chan, _ = code.channel_bits(tx.unpack_bits(tx.randomize(cadus)))
    sent = tx.qpsk_symbols(chan).numpy()
    got = soft[0::2].astype(np.float32) + 1j * soft[1::2]
    L = 20000

    def errors(r, d):
        g, t = (got[d:], sent) if d >= 0 else (got, sent[-d:])
        return np.mean(np.sign((g[:L] * 1j ** r).real) != np.sign(t[:L].real))
    assert min(errors(r, d) for r in range(4) for d in range(-8, 9)) < 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_the_soft_limit(name):
    """The reference's control (`psk_ff`: bfloat16 in place of float32)
    reads a number at more than three times its limit."""
    cfg, code = _config(name)
    ref = spec.load_module(spec.BENCH / "reference" /
                           f"{cfg['reference']}.py")
    x = tx.cs16_to_complex(code.make_recording(cfg, 300000, SEED,
                                               "cpu").iq)
    got = ref.control(x, cfg)
    assert got and set(got) <= set(cfg["limits"])
    assert any(v > 3 * cfg["limits"][k] for k, v in got.items())


@pytest.mark.card
@pytest.mark.parametrize("name", PSK_FF)
def test_control_fails_the_soft_limit_on_the_card(name, card):
    cfg, code = _config(name)
    x = tx.cs16_to_complex(code.make_recording(cfg, 1 << 20, SEED,
                                               card).iq)
    ref = psk_ff.demod(x, cfg)[0]
    bad, total = check.soft_mismatch(psk_ff.demod(x.cpu(), cfg)[0], ref)
    assert bad / total < cfg["limits"]["soft_mismatch"]
    assert psk_ff.control(x, cfg)["soft_mismatch"] > \
        3 * cfg["limits"]["soft_mismatch"]


def test_kernel_counts_on_known_shapes():
    k1 = spec.rooflines()["viterbi_re"]
    T = (1 << 20) + 1024
    ops, nbytes = k1.count((0, T, T // 1024, 1024, 128, 0))
    assert ops == T * 200 and nbytes == T * 9
    assert k1.bound_s((0, T, 0, 0, 0, 0)) == pytest.approx(T * 200 / 33.5e12)
    k2 = spec.rooflines()["resample_arith_grid"]
    n_ext, cap = (1 << 18) + 7, 102977
    flops, nbytes = k2.count((0, n_ext, 0, 0, 0, 0, cap))
    assert flops == cap * 38
    assert nbytes == n_ext * 8 + 4096 + 8 + cap * 8
    assert k2.bound_s((0, n_ext, 0, 0, 0, 0, cap)) == \
        pytest.approx(nbytes / 3.35e12)


def test_import_check_compares_whole_top_level_names(monkeypatch):
    import satdump_tpu_torch  # noqa: F401
    assert spec.forbidden_modules() == []
    monkeypatch.setitem(__import__("sys").modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert spec.forbidden_modules() == ["jax"]


def test_checks_count_what_they_say():
    sent = np.arange(40, dtype=np.uint8).reshape(10, 4)
    due = np.ones(10, bool)
    due[-1] = False
    assert check.cadus_failed(sent[:9].reshape(-1), sent, due) == (9, 0)
    assert check.cadus_failed(sent[1:].reshape(-1), sent, due) == (9, 1)
    twice = np.concatenate([sent[:9].reshape(-1), sent[0], [7]])
    assert check.cadus_failed(twice.astype(np.uint8), sent, due) == (9, 2)
    assert check.soft_mismatch(np.array([1, 2, 3]),
                               np.array([1, 2, 4, 5])) == (2, 4)


def test_union_of_intervals():
    s, e = trace._union(np.array([5, 0, 1, 10]), np.array([6, 2, 3, 12]))
    assert s.tolist() == [0, 5, 10] and e.tolist() == [3, 6, 12]


def _session(layer, lost=""):
    """A traced session as the card gives one: K1 and K2 launched twice
    each, every launch with its record."""
    T, n_ext, cap = (1 << 20) + 1024, (1 << 18) + 7, 102977
    return trace.Session(
        layer, 10.0, wall_s=2.0, busy_s=0.1, launches=600,
        kernel_records=600, lost=lost,
        by_kernel={"viterbi_re_kernel": [2, 2e-4],
                   "resample_arith_kernel": [2, 1e-5]},
        args={"viterbi_re": [(0, T, 0, 0, 0, 0)] * 2,
              "resample_arith": [(0, n_ext, 0, 0, 0, 0, cap)] * 2},
        counters={"viterbi_re": 2, "resample_arith_grid": 2})


DEVICE_METRICS = [m for m in SPEC["per_layer"]
                  if m["source"] == "device_trace"]


@pytest.mark.parametrize("lost", ("psk_demod", "decoder"))
def test_a_lost_session_leaves_every_device_metric_out(lost):
    """One session that lost records, and not the other layer's session
    alone, gives every device metric of the traced run as missing."""
    c = spec.Cell(CELLS[0], SPEC)
    whole = {"sessions": [_session("psk_demod"), _session("decoder")]}
    part = {"sessions": [_session(x, "4 kernel records for 8 launches"
                                  if x == lost else "")
                         for x in ("psk_demod", "decoder")]}
    assert {m["name"] for m in DEVICE_METRICS} >= {
        "device.idle_share", "host.launches_per_air_s"}
    for m in DEVICE_METRICS:
        assert c.reader(m).read(whole) is not None, m["name"]
        assert c.reader(m).read(part) is None, m["name"]
    assert c.reader({"name": "host.launches_per_air_s"}).read(whole) == 60.0
    assert c.reader({"name": "device.idle_share"}).read(whole) == \
        pytest.approx(95.0)


def test_a_counter_holds_only_the_kernels_it_counts(monkeypatch):
    """A kernel whose wrapper `launch_counts()` does not count (K3) is
    held to the launches seen alone; one it counts, to both."""
    k3 = types.SimpleNamespace(DEVICE_NAME="viterbi_block_acs",
                               ENTRY="viterbi_block_acs")
    monkeypatch.setattr(spec, "rooflines", lambda: {"viterbi_block": k3})
    s = _session("decoder")
    s.by_kernel["viterbi_block_acs_kernel"] = [3, 1e-4]
    s.args["viterbi_block_acs"] = [()] * 3
    bench.held_to_counts([s], "cuda")
    assert s.lost == ""
    s.args["viterbi_block_acs"] = [()] * 4
    bench.held_to_counts([s], "cuda")
    assert "viterbi_block" in s.lost
    k1 = spec.load_module(spec.BENCH / "roofline" / "viterbi_re.py")
    monkeypatch.setattr(spec, "rooflines", lambda: {"viterbi_re": k1})
    s = _session("decoder")
    s.counters["viterbi_re"] = 3
    bench.held_to_counts([s], "cuda")
    assert "counter 3" in s.lost


def test_traced_calls_run_again_while_a_session_loses_records():
    class Flaky:
        def __init__(self, losses):
            self.losses, self.tries = losses, 0

        def traced(self):
            self.tries += 1
            lost = "lost" if self.tries <= self.losses else ""
            return [_session("psk_demod", lost), _session("decoder")]
    d = Flaky(1)
    got = bench.traced_sessions(d, "cuda")
    assert d.tries == 2 and trace.kept(got) == got
    d = Flaky(trace.TRIES)
    got = bench.traced_sessions(d, "cuda")
    assert d.tries == trace.TRIES and trace.kept(got) == []


@pytest.mark.parametrize("traced", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_on_the_cpu(cell, traced):
    out = bench.run_cell(cell, SEED, 0.5, traced, "cpu", TINY, SPEC)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"] and all(c["value"] == 0
                                 for c in out["checks"].values())
    c = spec.Cell(cell, SPEC)
    assert set(c.reference.READS.values()) <= set(out["checks"])
    if traced:
        assert out["metrics"] and "breakdown" in out
    else:
        assert {m["name"] for m in c.end_to_end} == set(out["metrics"])


def _old_verify(run, driver):
    """The oracle: `run.py::verify` and the offline driver's `outputs` as
    they were before each configuration's reference decided `correct`
    (softs at `{pid}.soft`, CADUs at `{pid}.cadu`, `psk_ff.demod` as the
    reference)."""
    cfg = run.cell.cfg
    limits = cfg["limits"]
    outputs = driver.outputs()
    if run.cell.traffic["driver"] == "offline":
        pid = driver.full.id
        outputs = [(c / f"{pid}.soft", driver.n,
                    np.fromfile(c / f"{pid}.cadu", np.uint8), driver.due)
                   for c in driver.calls]
    ref_by_n, bad, total, attempted, failed = {}, 0, 0, 0, 0
    stream = None
    for soft_path, n, cadu_raw, due in outputs:
        a, f = check.cadus_failed(cadu_raw, driver.sent, due)
        attempted, failed = attempted + a, failed + f
        if n not in ref_by_n:
            if stream is None:
                stream = driver.stream(run.device)
            ref_by_n[n] = psk_ff.demod(stream[:n], cfg)[0]
        b, t = check.soft_mismatch(np.fromfile(soft_path, np.int8),
                                   ref_by_n[n])
        bad, total = bad + b, total + t
    return {"attempted": attempted, "failed": failed, "checks": {
        "soft_mismatch": {"value": bad / max(total, 1),
                          "limit": limits["soft_mismatch"]},
        "cadus_failed": {"value": failed, "limit": limits["cadus_failed"]}}}


@pytest.mark.parametrize("softs", ("as written", "altered"))
@pytest.mark.parametrize("cell", PSK_FF_CELLS)
def test_checks_equal_the_loop_they_replaced(cell, softs, monkeypatch):
    """`run_cell`'s checks and counts, through the configuration's
    reference, equal the oracle's on the same run's outputs: on a sound
    run, and on one whose softs are altered (a nonzero mismatch)."""
    if softs == "altered":
        plant(monkeypatch, cell, MIDDLE)
    seen = {}
    verify = bench.verify

    def both(run, driver):
        seen["old"] = _old_verify(run, driver)
        return verify(run, driver)
    monkeypatch.setattr(bench, "verify", both)
    out = bench.run_cell(cell, SEED + 3, 0.5, 0, "cpu", TINY, SPEC)
    old = seen["old"]
    assert out["checks"] == old["checks"]
    assert (out["attempted"], out["failed"]) == (old["attempted"],
                                                 old["failed"])
    assert out["attempted"] > 0
    assert (out["checks"]["soft_mismatch"]["value"] > 0) == \
        (softs == "altered")


# the faults planted underneath a cell's timed path, in the files that the
# program writes: (the level, by its index in the configuration's `levels`;
# what happens to the bytes written)
MIDDLE = "middle level altered"
FAULTS = {MIDDLE: (1, "altered"),
          "last level's frames altered": (-1, "altered"),
          "half of the last level's frames left out": (-1, "left out")}
# one byte in this many of the middle level is altered
MIDDLE_EVERY = 50


class _Faulty:
    """A file that the program writes a level to, whose bytes come out
    with a fault planted by their place in the file: `altered` flips the
    top bit of one byte in every `width` (an int8 soft moves by 128 and
    changes its sign), `left out` drops every second frame of `width`
    bytes."""

    def __init__(self, f, fault, width):
        self.f, self.fault, self.width, self.pos = f, fault, width, 0

    def write(self, b):
        a = np.frombuffer(b, np.uint8).copy()
        at = self.pos + np.arange(len(a))
        self.pos += len(a)
        if self.fault == "altered":
            a[at % self.width == self.width // 2] ^= 0x80
        else:
            a = a[at // self.width % 2 == 0]
        return self.f.write(a.tobytes())

    def __getattr__(self, name):
        return getattr(self.f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()


def plant(monkeypatch, cell, fault, spec_dict=SPEC) -> str:
    """Plant `fault` underneath the cell's timed path: every file that the
    program opens for writing with the suffix of the fault's level
    (`.<level>`) writes through `_Faulty`, with the width of the frames sent
    (the recording's CADUs) on the last level. Returns the number of the
    cell's reference that reads that level (its `READS`)."""
    c = spec.Cell(cell, spec_dict)
    index, what = FAULTS[fault]
    level = c.cfg["levels"][index]
    width = {}
    make = c.code.make_recording

    def recording(*a, **k):
        rec = make(*a, **k)
        width["frames"] = rec.cadus.shape[1]
        return rec
    monkeypatch.setattr(c.code, "make_recording", recording)
    real_open = builtins.open

    def faulty_open(path, mode="r", *a, **k):
        f = real_open(path, mode, *a, **k)
        if str(path).endswith("." + level) and "w" in mode:
            return _Faulty(f, what, width["frames"] if index == -1
                           else MIDDLE_EVERY)
        return f
    monkeypatch.setattr(builtins, "open", faulty_open)
    return c.reference.READS[level]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    key = plant(monkeypatch, cell, fault)
    out = bench.run_cell(cell, SEED, 0.5, 0, "cpu", TINY, SPEC)
    assert out["correct"] is False
    c = out["checks"][key]
    assert c["value"] > c["limit"]


# A configuration of another kind, added to a copy of the benchmark as new
# files and entries only: GOES-R GRB (DVB-S2 to BBFrames, then 2,048-byte
# CADUs) at exactly 2 samples a symbol, the rate that `chip_smoke.py`'s
# phase 13 runs; the files under `grb_fixture/` are copied into the copy
# alone and are never a configuration of the benchmark
GRB = "goes_grb_2sps"
GRB_CELL = f"{GRB}.offline"
GRB_FIXTURE = spec.BENCH / "tests" / "grb_fixture"
GRB_ENTRIES = {
    "configs": {"name": GRB, "source": "https://github.com/SatDump/SatDump "
                "pipelines/GOES.json, pipeline goes_grb",
                "file": f"benchmark/configs/{GRB}.json",
                "reduced": ["samplerate", "recording_s"],
                "why": "GOES-R GRB at exactly 2 sps: DVB-S2 MODCOD 11 "
                       "(dvbs2_demod) to BBFrames, then 2,048-byte CADUs"},
    "workloads": {"name": GRB_CELL, "config": GRB, "traffic": "offline",
                  "chips": 1, "why": "GRB recordings by whole run_pipeline "
                  "calls: dvbs2_demod's PL layer, LDPC and BCH, the CADU "
                  "extractor"}}
# the metrics whose cells the new cell joins
GRB_METRICS = ("realtime_x", "decoder.ms_per_air_s")


def _files(root):
    """{path under root: bytes} of every file, but the work and cache
    directories' and Python's caches."""
    skip = {"_work", "_cache", "__pycache__"}
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and not skip & set(p.relative_to(root).parts)}


def _fixture_files():
    """The fixture's files, by their paths under the benchmark."""
    return [p.relative_to(GRB_FIXTURE) for p in GRB_FIXTURE.rglob("*.*")
            if p.suffix in (".py", ".json")]


@pytest.fixture(scope="module")
def another_kind(tmp_path_factory):
    """The copy: `BENCHMARK.json` and `benchmark/` (without its work and
    cache directories), then the GRB configuration's file, code module and
    reference as new files, and its configuration, its cell and its cell in
    `GRB_METRICS` as new entries. GOES.json's `goes_grb` at 16 Msps would
    make `dvbs2_demod` resample, so the program loads the same pipeline
    with the samplerate of 2 sps under the id `goes_grb_2sps`, from a
    pipelines file of the user's (as the CLI's `--pipelines_dir` does).
    Returns (the copy's root, its BENCHMARK.json)."""
    from satdump_tpu_torch.pipeline.pipeline import load_pipelines_file
    root = tmp_path_factory.mktemp("another_kind")
    shutil.copytree(spec.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("_work", "_cache",
                                                  "__pycache__"))
    for f in _fixture_files():
        assert not (root / "benchmark" / f).exists()
        shutil.copy(GRB_FIXTURE / f, root / "benchmark" / f)
    b = copy.deepcopy(SPEC)
    for key, entry in GRB_ENTRIES.items():
        b[key].append(entry)
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in GRB_METRICS:
            m["workloads"].append(GRB_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=2) + "\n")
    pipe = spec.load_json(spec.ROOT / "resources" / "pipelines" /
                          "GOES.json")["goes_grb"]
    pipe["parameters"]["samplerate"]["value"] = spec.load_json(
        GRB_FIXTURE / "configs" / f"{GRB}.json")["signal"]["samplerate"]
    (root / "pipelines").mkdir()
    (root / "pipelines" / f"{GRB}.json").write_text(json.dumps({GRB: pipe}))
    load_pipelines_file(root / "pipelines" / f"{GRB}.json")
    return root, b


@pytest.fixture
def in_the_copy(another_kind, monkeypatch):
    """The harness pointed at the copy: its `BENCHMARK.json`, its files
    loaded anew (not the benchmark's own, which the module cache holds) and
    its work directory. After the test, every file the copy shares with the
    benchmark is still the benchmark's, byte for byte, and the copy's
    `BENCHMARK.json` is the benchmark's with the new entries alone."""
    root, b = another_kind
    monkeypatch.setattr(spec, "BENCH", root / "benchmark")
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(bench, "BENCH", root / "benchmark")
    for name in [m for m in sys.modules if m.startswith("benchmark_")]:
        monkeypatch.delitem(sys.modules, name)
    yield b
    ours = _files(Path(__file__).resolve().parents[1])
    theirs = _files(root / "benchmark")
    assert {p: theirs.get(p) for p in ours} == ours
    assert set(theirs) - set(ours) == set(_fixture_files())
    got = spec.load_json(root / "BENCHMARK.json")
    for key in GRB_ENTRIES:
        assert got[key].pop() == GRB_ENTRIES[key]
    for m in got["end_to_end"] + got["per_layer"]:
        if m["name"] in GRB_METRICS:
            assert m["workloads"].pop() == GRB_CELL
    assert got == SPEC


@pytest.mark.parametrize("fault", ("none", *FAULTS))
def test_a_configuration_of_another_kind_comes_as_new_files(fault,
                                                            in_the_copy,
                                                            monkeypatch):
    """In the copy, the GRB cell's dry run is correct with every check at
    0, and each fault planted underneath it, by level and by the width of
    the frames sent, trips the number that its reference reads there."""
    key = plant(monkeypatch, GRB_CELL, fault, in_the_copy) \
        if fault != "none" else None
    out = bench.run_cell(GRB_CELL, SEED, 0.5, 0, "cpu", TINY, in_the_copy)
    c = spec.Cell(GRB_CELL, in_the_copy)
    assert set(out["checks"]) == set(c.reference.READS.values())
    assert out["attempted"] > 0
    if key is None:
        assert out["correct"] and out["failed"] == 0
        assert all(v["value"] == 0 for v in out["checks"].values())
        assert {m["name"] for m in c.end_to_end} == set(out["metrics"])
    else:
        assert out["correct"] is False
        assert out["checks"][key]["value"] > out["checks"][key]["limit"]


def test_calibrate_names_a_reference_without_a_control(another_kind):
    root, _ = another_kind
    r = subprocess.run([sys.executable, str(root / "benchmark" /
                                            "calibrate.py"),
                        "--workload", GRB_CELL, "--seeds", "1"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and r.stdout == ""
    assert "reference grb_frames defines no control" in r.stderr
