"""The port's DVB-S legacy chain (EN 300 421) against the JAX package's, on
the CPU, on the same inputs made from a seed: RS(204,188), the Forney
(de)interleaver, energy dispersal, the TS comb sync, and the dvbs_demod
module on tests/test_dvbs_legacy.py's loopback (64 TS packets at 100
ksym/s, 220 ksps), whose .ts must be byte-identical to the JAX module's
and hold only packets sent. Everything after the soft symbols is exact,
so there is no tolerance: the softs themselves differ in the last bits
(torch.fft against XLA's FFT), which the Viterbi absorbs."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from satdump_tpu.ops import dvbs as jd
from satdump_tpu_torch.ops import dvbs as td

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_dvbs_legacy import _dvbs_tx  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain paths here are loops of small torch ops (the lock
    search's ~1,000 trellis steps, the PL layer's slots); with one intra-op
    thread they do not wait on a thread pool that the other test workers
    of a parallel run keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rs204_equals_jax(rng):
    pkts = rng.integers(0, 256, (6, 188), dtype=np.uint8)
    cws = td.DVBSReedSolomon().encode(pkts)
    np.testing.assert_array_equal(cws, jd.DVBSReedSolomon().encode(pkts))
    for i, row in enumerate(cws):
        nerr = 9 if i == 5 else 8 - i            # the last uncorrectable
        pos = rng.choice(204, nerr, replace=False)
        row[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
    tdec, tn = td.DVBSReedSolomon().decode(cws)
    jdec, jn = jd.DVBSReedSolomon().decode(cws)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tdec[tn >= 0], jdec[jn >= 0])
    assert list(tn[:5]) == [8, 7, 6, 5, 4] and tn[5] < 0


def test_interleaver_and_dispersal_equal_jax(rng):
    data = rng.integers(0, 256, 204 * 40, dtype=np.uint8)
    tx_t, tx_j = td.ConvInterleaver(), jd.ConvInterleaver()
    rx_t, rx_j = td.ConvDeinterleaver(), jd.ConvDeinterleaver()
    for part in (data[:204 * 17], data[204 * 17:]):    # state carried
        it, ij = tx_t.work(part), tx_j.work(part)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(rx_t.work(it), rx_j.work(ij))
    grp = rng.integers(0, 256, (8, 188), dtype=np.uint8)
    grp[:, 0] = td.SYNC
    grp[0, 0] = td.SYNC_INV
    np.testing.assert_array_equal(td.energy_dispersal(grp),
                                  jd.energy_dispersal(grp))


def test_find_ts_sync_equals_jax(rng):
    data = rng.integers(0, 256, 204 * 24, dtype=np.uint8)
    for k in range(20):
        data[777 + k * 204] = td.SYNC_INV if k % 8 == 0 else td.SYNC
    assert td.find_ts_sync(data) == jd.find_ts_sync(data) == 777
    assert td.find_ts_sync(data[:900]) is jd.find_ts_sync(data[:900]) is None


@pytest.mark.parametrize("rate,conv_rate", [("1/2", "auto"), ("3/4", "auto"),
                                            ("3/4", "3/4")],
                         ids=["auto_1/2", "auto_3/4", "fixed_3/4"])
def test_dvbs_demod_ts_equals_jax(tmp_path, rng, rate, conv_rate):
    from satdump_tpu import sim as jsim
    from satdump_tpu.io import write_baseband
    from satdump_tpu.pipeline.modules.dvbs2.dvbs import DVBSDemodModule as J
    from satdump_tpu_torch.pipeline.modules.dvbs2.dvbs import \
        DVBSDemodModule as T
    ts = rng.integers(0, 256, (64, 188), dtype=np.uint8)
    ts[:, 0] = jd.SYNC
    syms = _dvbs_tx(ts, rate, rng)
    bb = jsim.qpsk_modulate(syms, sps=2.2, rrc_alpha=0.35)
    chan = jsim.ChannelModel(snr_db=17.0, freq_offset=1e-4, phase=0.3, seed=6)
    path = tmp_path / "dvbs.cf32"
    write_baseband(path, "cf32", chan.apply(bb))
    params = {"samplerate": 220_000, "symbolrate": 100_000,
              "conv_rate": conv_rate, "buffer_size": 1 << 17}
    jm = J(str(path), str(tmp_path / "j"), params)
    jm.process()
    tm = T(str(path), str(tmp_path / "t"), dict(params, torch_device="cpu"))
    tm.process()
    got = np.fromfile(tm.d_output_file, np.uint8)
    np.testing.assert_array_equal(got, np.fromfile(jm.d_output_file,
                                                   np.uint8))
    assert tm.stats["viterbi_rate"] == jm.stats["viterbi_rate"] == rate
    assert tm.stats["ts_packets"] == jm.stats["ts_packets"]
    got = got.reshape(-1, 188)
    assert len(got) >= 24, f"only {len(got)} TS packets"
    sent = {r.tobytes() for r in ts}
    assert all(g.tobytes() in sent for g in got)


@pytest.mark.parametrize("rate", ["1/2", "3/4", "7/8"])
def test_sim_dvbs_symbols_equal_the_jax_suites_fixture(rng, rate):
    from satdump_tpu_torch import sim
    ts = rng.integers(0, 256, (16, 188), dtype=np.uint8)
    ts[:, 0] = jd.SYNC
    np.testing.assert_array_equal(sim.dvbs_symbols(ts, rate),
                                  _dvbs_tx(ts, rate, rng))
