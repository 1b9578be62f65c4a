"""The port's FengYun-3 AHRPT modules against the JAX package's, on the
CPU, on the same inputs made from a seed: the FengYun differential code,
the VIRR / MERSI-2 / MWHS-2 / MWTS-2 readers, `fy3_instruments`,
`fengyun_ahrpt_decoder` from softs, and the FY-3A/B pipeline from baseband
(8.4 Msps, sps 3) through both packages' run_pipeline.

Tolerances, and why:
* readers, .cadu, products (pixels, product.json / .cbor, dataset.json):
  none. Both packages decode with k=7 Viterbi, deframe, derandomize and
  RS-correct on the host or exactly on the device;
* .soft from baseband: the same length, every soft within 3 LSB and the
  mean |difference| below 0.25 LSB (torch's FFTs and reductions sum in
  another order than XLA's, as in tests/test_torch_e2e.py).

psk_demod's block seams: at sps 3 the JAX package's feedforward timing can
drop the first symbol of a block (its estimate puts it a hair before the
carried history), which shifts each rail's code pairs for the rest of the
pass; the port keeps it (ops/ffsync.py, FIRST_SNAP). So the baseband
comparison runs in one psk_demod block (`buffer_size`), and a second test
holds the port alone across seams.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from satdump_tpu.models import fengyun3 as jfy
from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
from satdump_tpu.pipeline.runner import run_pipeline as jrun
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.models import fengyun3 as tfy
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file as tparse
from satdump_tpu_torch.pipeline.runner import run_pipeline as trun
from tests.test_fengyun3 import (_fengyun_diff_encode, mk_mwhs2_packets,
                                 mk_mwts2_packets)
from tests.test_torch_hrpt import _assert_products_equal, _run_both

FY3 = Path(__file__).resolve().parents[1] / "resources" / "pipelines" / \
    "FengYun-3.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The lock search is a loop of ~2,000 small torch ops a call; with one
    intra-op thread it does not wait on a thread pool that the other test
    workers of a parallel run keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_diff_code_equals_jax(rng):
    bits = rng.integers(0, 2, 4000).astype(np.uint8)
    x, y = sim.fengyun_diff_encode(bits)
    jx, jy = _fengyun_diff_encode(bits[:600])
    np.testing.assert_array_equal(x[:301], jx)
    np.testing.assert_array_equal(y[:301], jy)
    np.testing.assert_array_equal(tfy.fengyun_diff_decode(x, y), bits)
    np.testing.assert_array_equal(tfy.fengyun_diff_decode(x, y),
                                  jfy.fengyun_diff_decode(x, y))
    # a QPSK rotation by 90 degrees (x, y) -> (not y, x) decodes the same
    np.testing.assert_array_equal(tfy.fengyun_diff_decode(1 - y, x), bits)


def test_readers_equal_jax(rng):
    frames = [sim.virr_frame(rng, ms=5_000_000 + 1000 * i) for i in range(2)]
    out = {}
    for name, mod in (("jax", jfy), ("torch", tfy)):
        v = mod.VIRRReader()
        for f, _ in frames:
            v.work(f)
        h, t = mod.MWHS2Reader(), mod.MWTS2Reader()
        for s in range(3):
            for p in mk_mwhs2_packets(s):
                h.work(p)
            for p in mk_mwts2_packets(s):
                t.work(p)
        out[name] = (v, h, t)
    for (a, b, n) in zip(out["jax"], out["torch"], (10, 15, 16)):
        assert b.lines == a.lines > 0
        for ch in range(n):
            np.testing.assert_array_equal(b.get_channel(ch), a.get_channel(ch))
        assert b.timestamps == a.timestamps
    for ch in range(10):
        np.testing.assert_array_equal(out["torch"][0].get_channel(ch) // 64,
                                      np.stack([f[1][:, ch] for f in frames]))


def test_mersi2_reader_equals_jax(rng):
    """A head frame and 250 m / 1 km scan frames behind their syncs, at
    random bit offsets in a random stream."""
    r = tfy.MERSI2Reader()
    parts = [rng.integers(0, 2, 77).astype(np.uint8)]
    for marker in (0, 41, r.counter_250_end + 12, 7):
        head = np.array([(r.SCAN_SYNC >> (27 - i)) & 1 for i in range(28)],
                        np.uint8)
        size = r.scan250_size if marker < r.counter_250_end \
            else r.scan1000_size
        body = rng.integers(0, 2, size).astype(np.uint8)
        body[:10] = (marker >> np.arange(9, -1, -1)) & 1
        parts += [head, body]
    parts.insert(1, np.array([(r.HEAD_SYNC >> (47 - i)) & 1
                              for i in range(48)], np.uint8))
    parts.insert(2, rng.integers(0, 2, r.head_size).astype(np.uint8))
    stream = np.packbits(np.concatenate(parts))
    j = jfy.MERSI2Reader()
    j.work(stream)
    r.work(stream)
    assert r.segments == j.segments == 0 and r.timestamps == j.timestamps
    for ch in range(r.c250 + r.c1000):
        np.testing.assert_array_equal(r.get_channel(ch), j.get_channel(ch))


def test_fy3_instruments_equal_jax(tmp_path, rng):
    """A CADU file carrying 2 VIRR lines (VCID 5) and MWHS-2 / MWTS-2
    packets (VCID 12) to products."""
    cadus, lines = sim.fy3_instrument_cadus(rng, 2, 3, 2)
    cadus.tofile(tmp_path / "x.cadu")
    mods = _run_both(tmp_path, tmp_path / "x.cadu",
                     jfy.FY3InstrumentsDecoderModule,
                     tfy.FY3InstrumentsDecoderModule, {})
    assert mods["torch"].stats == mods["jax"].stats == {
        "virr_lines": 2, "mersi_segments": 0, "mwhs2_lines": 3,
        "mwts2_lines": 2}
    assert sorted(_assert_products_equal(tmp_path)) == \
        ["MWHS-2", "MWTS-2", "VIRR"]
    from satdump_tpu_torch.products.product import load_product
    virr = load_product(str(tmp_path / "torch" / "VIRR"))
    np.testing.assert_array_equal(virr.get_channel("3").image // 64,
                                  lines[:, :, 2])


def test_ahrpt_decoder_from_softs_equals_jax(tmp_path, rng):
    """Ideal dual-rail softs with noise, the rails swapped and one rail's
    stream rotated as a 90-degree carrier lock gives them."""
    cadus = sim.make_cadus(8, rng)
    tx = cadus.copy()
    from satdump_tpu_torch.ops.fec import convolutional as cc
    from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
    tx[:, 4:] = derand_ccsds(tx[:, 4:])
    x, y = sim.fengyun_diff_encode(np.concatenate(
        [np.unpackbits(tx.reshape(-1)), rng.integers(0, 2, 512)]))
    chan = np.empty(4 * len(x), np.uint8)
    chan[0::2] = cc.conv_encode_batch(1 - y)     # I = not y, Q = x
    chan[1::2] = cc.conv_encode_batch(x)
    sim.soft_stream(chan, rng, prefix=1001).tofile(tmp_path / "f.soft")
    out = {}
    for name, cls, params in (("jax", jfy.FengyunAHRPTDecoderModule, {}),
                              ("torch", tfy.FengyunAHRPTDecoderModule,
                               {"torch_device": "cpu"})):
        mod = cls(str(tmp_path / "f.soft"), str(tmp_path / name), params)
        mod.process()
        out[name] = np.fromfile(mod.d_output_file, np.uint8)
    assert out["torch"].tobytes() == out["jax"].tobytes()
    np.testing.assert_array_equal(out["torch"].reshape(-1, 1024), cadus)


def test_ahrpt_decoder_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default")
    with pytest.raises(SatdumpError):
        tfy.FengyunAHRPTDecoderModule("x.soft", "out", {})


def _fy3_baseband(tmp_path, rng, cadus):
    src = tmp_path / "fy3.cf32"
    write_baseband(src, "cf32", sim.fy3_ahrpt_baseband(cadus, rng))
    return src


def test_fy3ab_baseband_to_products_equals_jax(tmp_path):
    """14 CADUs of MWHS-2 / MWTS-2 data from baseband at 8.4 Msps to .cadu
    and products through both packages' run_pipeline, in one psk_demod
    block (module docstring)."""
    rng = np.random.default_rng(31)
    cadus, _ = sim.fy3_instrument_cadus(rng, 0, 2, 1)
    assert len(cadus) == 14
    src = _fy3_baseband(tmp_path, rng, cadus)
    params = {"buffer_size": 1 << 19}
    tout = trun(tparse(FY3)["fengyun3_ab_ahrpt"], str(src),
                str(tmp_path / "torch"),
                user_params=dict(params, torch_device="cpu"))
    jout = jrun(jparse(FY3)["fengyun3_ab_ahrpt"], str(src),
                str(tmp_path / "jax"), user_params=params)
    assert Path(tout).name == Path(jout).name == "dataset.json"
    tc = (tmp_path / "torch" / "fengyun3_ab_ahrpt.cadu").read_bytes()
    assert tc == (tmp_path / "jax" / "fengyun3_ab_ahrpt.cadu").read_bytes()
    assert tc == cadus.tobytes()
    ts = np.fromfile(tmp_path / "torch" / "fengyun3_ab_ahrpt.soft", np.int8)
    js = np.fromfile(tmp_path / "jax" / "fengyun3_ab_ahrpt.soft", np.int8)
    assert ts.shape == js.shape and len(ts) > len(cadus) * 8192 * 2
    d = np.abs(ts.astype(np.int16) - js)
    assert d.max() <= 3, d.max()
    assert d.mean() < 0.25, d.mean()
    assert sorted(_assert_products_equal(tmp_path)) == ["MWHS-2", "MWTS-2"]


def test_fy3_baseband_across_block_seams(tmp_path):
    """40 CADUs at the default 2^18-sample psk_demod block (four blocks):
    every CADU sent comes out, in order. The first symbol of the second
    block lands 0.0025 samples before the carried history here."""
    rng = np.random.default_rng(3)
    cadus = sim.make_cadus(40, rng)
    src = _fy3_baseband(tmp_path, rng, cadus)
    pipe = tparse(FY3)["fengyun3_ab_ahrpt"]
    pipe.steps = pipe.steps[: pipe.level_index("cadu") + 1]
    out = trun(pipe, str(src), str(tmp_path / "torch"),
               user_params={"torch_device": "cpu"})
    assert np.fromfile(out, np.uint8).tobytes() == cadus.tobytes()
