"""The per-layer metrics that read the program's own spans
(`harness/spans.py`): each reader on made-up span totals, with its missing
cases (no `core.trace` in the program, a zero denominator), and a traced
dry run of `metop_ahrpt.offline` on the CPU that reports all five."""

import pytest

import run as bench
from harness import spans, spec

SPEC = spec.load_json(spec.ROOT / "BENCHMARK.json")
SPAN_METRICS = [m for m in SPEC["per_layer"]
                if m["source"] == "program_span"
                and m["name"] != "live.decoder_ms_per_block"]
NAMES = sorted(m["name"] for m in SPAN_METRICS)
TINY = {"samples": 655360, "warmup_samples": 262144}
SEED = 2 ** 31 + 54321


def _span(calls, ns, self_ns, kind):
    return {"calls": calls, "ns": ns, "self_ns": self_ns, "kind": kind}


# two psk_demod blocks and 4 CADUs, in ns
TOTALS = {"spans": {
    "psk_demod.block": _span(2, 30e6, 1e6, None),
    "psk_demod.read": _span(3, 4e6, 4e6, "host"),
    "psk_demod.quantize": _span(2, 2e6, 2e6, "host"),
    "psk_demod.write": _span(2, 1e6, 1e6, "host"),
    "psk_demod.chain": _span(2, 20e6, 14e6, None),
    "psk_demod.tones": _span(6, 3e6, 3e6, "wait"),
    "psk_demod.pick": _span(2, 2e6, 2e6, "wait"),
    "psk_demod.to_host": _span(2, 1e6, 1e6, "wait"),
    "step.psk_demod": _span(1, 40e6, 5e6, None),
    "decoder.read": _span(1, 0.5e6, 0.5e6, "host"),
    "decoder.unpack": _span(1, 1.5e6, 1.5e6, "host"),
    "decoder.lock_search": _span(1, 5e6, 4e6, None),
    "decoder.lock_wait": _span(2, 1e6, 1e6, "wait"),
    "decoder.to_host": _span(1, 3e6, 3e6, "wait"),
    "live.rebuffer": _span(9, 9e6, 9e6, None)},
    "counters": {"decoder.cadus": 4}}
WANT = {"psk_demod.host_ms_per_block": 3.5,
        "psk_demod.wait_ms_per_block": 3.0,
        "psk_demod.syncs_per_block": 5.0,
        "decoder.host_us_per_cadu": 500.0,
        "decoder.wait_us_per_cadu": 1000.0}


def _reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py")


def test_the_five_are_entries_with_readers():
    assert NAMES == sorted(WANT)
    for m in SPAN_METRICS:
        assert m["moves"] == "realtime_x"
        assert m["workloads"] == ["metop_ahrpt.offline",
                                  "fy3d_ahrpt.offline", "metop_ahrpt.live"]


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_made_up_totals(name, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: TOTALS)
    assert _reader(name).read({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_without_spans_or_denominator(name, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: None)
    assert _reader(name).read({}) is None
    empty = {"spans": {k: v for k, v in TOTALS["spans"].items()
                       if k != "psk_demod.block"}, "counters": {}}
    monkeypatch.setattr(spans, "totals", lambda: empty)
    assert _reader(name).read({}) is None
    zero = {"spans": dict(TOTALS["spans"], **{
        "psk_demod.block": _span(0, 0, 0, None)}),
        "counters": {"decoder.cadus": 0}}
    monkeypatch.setattr(spans, "totals", lambda: zero)
    assert _reader(name).read({}) is None


def test_a_program_without_core_trace_gives_none(monkeypatch):
    import sys
    import satdump_tpu_torch.core as core
    monkeypatch.setitem(sys.modules, "satdump_tpu_torch.core.trace", None)
    monkeypatch.delattr(core, "trace", raising=False)
    assert spans.totals() is None
    for name in WANT:
        assert _reader(name).read({}) is None


def test_traced_dry_run_reports_all_five():
    from satdump_tpu_torch.core import trace
    trace.reset()
    out = bench.run_cell("metop_ahrpt.offline", SEED, 0.5, 1, "cpu", TINY,
                         SPEC)
    assert out["correct"]
    for name in WANT:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["psk_demod.syncs_per_block"]["value"] >= 5
