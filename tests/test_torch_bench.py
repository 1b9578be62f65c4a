"""The port's `bench` (satdump_tpu_torch/bench.py, the CLI's `bench`)
against the JAX package's: the same categories, one JSON line each with a
rate. Run on the CPU at n = 4096 (torch at one intra-op thread)."""

import json

import pytest
import torch

from satdump_tpu import bench as jbench
from satdump_tpu_torch import bench, cli
from satdump_tpu_torch.core.exceptions import SatdumpError

RATE_KEYS = ("samples_per_sec", "mbytes_per_sec", "msoft_per_sec")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_cli_bench_categories_match_jax(capsys):
    assert cli.main(["bench", "--torch_device", "cpu", "--n", "4096"]) == 0
    lines = _lines(capsys)
    want = list(jbench._categories(4096)) + list(jbench._host_categories())
    assert [ln["category"] for ln in lines] == want
    for ln in lines:
        assert "error" not in ln, ln
        rate = [ln[k] for k in RATE_KEYS if k in ln]
        assert len(rate) == 1 and rate[0] > 0, ln
        if "samples_per_sec" in ln:
            assert ln["msps"] == round(ln["samples_per_sec"] / 1e6, 2)
    host = {ln["category"]: ln for ln in lines}
    assert host["soft_to_cadu"]["cadus"] == 8
    assert host["rs_decode"]["frames"] == 64


def test_bench_category_filter_and_device(capsys):
    res = bench.run_bench(["agc", "viterbi_k7"], n=4096, device="cpu")
    assert sorted(res) == ["agc", "viterbi_k7"]
    assert [ln["category"] for ln in _lines(capsys)] == ["agc", "viterbi_k7"]
    # the default device is cuda, which this machine lacks
    with pytest.raises(SatdumpError, match="cuda"):
        bench.run_bench(["agc"], n=4096)
