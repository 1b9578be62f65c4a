"""The port's FIR forms and VFO channelizer against the JAX package's on
the CPU, the VFO recorder, and two carriers of one wideband stream decoded
through the CLI's `live --vfo`.

Tolerances: fir_direct within 1e-6 of the JAX function (the same sum of
taps, XLA may fuse its multiply-adds); the FFT forms within 2e-5 absolute
on unit-scale signals (pocketfft in torch against XLA's FFT, ROADMAP §3);
the decimation, rates and taps exactly. The channelizer's shift forms its
phase p0 + n*delta in float32 as both packages do, but XLA fuses the
multiply-add under jit (one rounding where the port has two), so from the
second block, whose p0 is not 0, the phases differ by up to an ulp of the
block's largest phase: against JAX its output is held to
tests/test_torch_stages.py's freq_shift rule, 8 ulp(max phase) * max|x|
(times the taps' gain), and to 2e-5 against a float64 model of the port's
own float32 phases.
"""

import contextlib
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import fir as jfir
from satdump_tpu.ops import firdes as jfirdes
from satdump_tpu.ops.vfo import VFOChannelizer as JChan
from satdump_tpu.pipeline.multivfo import MultiVFOLive as JMulti
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.io import read_baseband, write_baseband
from satdump_tpu_torch.ops import fir, firdes
from satdump_tpu_torch.ops.vfo import VFOChannelizer
from satdump_tpu_torch.pipeline.multivfo import MultiVFOLive

FFT_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cx(rng, n, scale=0.5):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale
            ).astype(np.complex64)


def test_fir_direct_matches_jax(rng):
    taps = rng.standard_normal(15).astype(np.float32) * 0.2
    st, jst = fir.fir_init(15, device="cpu"), jfir.fir_init(15)
    ys, jys = [], []
    for _ in range(2):
        x = _cx(rng, 1000)
        st, y = fir.fir_direct(st, torch.from_numpy(x), taps)
        jst, jy = jfir.fir_direct(jst, jnp.asarray(x), jnp.asarray(taps))
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
        np.testing.assert_allclose(st.history.numpy(),
                                   np.asarray(jst.history))
    y, jy = np.concatenate(ys), np.concatenate(jys)
    np.testing.assert_allclose(y, jy, atol=1e-6)
    assert y.dtype == np.complex64


def test_decimating_fir_matches_jax(rng):
    """Three blocks of the decimating overlap-save FIR with its history
    carried, against the JAX function and the NumPy golden model."""
    taps = jfirdes.low_pass(1.0, 1e6, 6e4, 3e4)
    assert np.array_equal(firdes.low_pass(1.0, 1e6, 6e4, 3e4), taps)
    st, jst = fir.fir_init(len(taps), device="cpu"), jfir.fir_init(len(taps))
    xs, ys, jys = [], [], []
    for _ in range(3):
        x = _cx(rng, 4096)
        st, y = fir.decimating_fir_apply(st, torch.from_numpy(x), taps, 4)
        jst, jy = jfir.decimating_fir_apply(jst, jnp.asarray(x), taps, 4)
        xs.append(x)
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
    y = np.concatenate(ys)
    assert y.shape == (3 * 1024,)
    np.testing.assert_allclose(y, np.concatenate(jys), atol=FFT_ATOL)
    ref = fir.np_fir_reference(np.concatenate(xs).astype(np.complex128),
                               taps.astype(np.float64))[::4]
    np.testing.assert_allclose(y, ref, atol=FFT_ATOL)
    np.testing.assert_array_equal(
        fir.np_fir_reference(xs[0], taps), jfir.np_fir_reference(xs[0], taps))
    for b, n in ((1 << 18, 97), (4096, 1), (1000, 31)):
        assert fir.design_fft_size(b, n) == jfir.design_fft_size(b, n)


@pytest.mark.parametrize("block", [1 << 14, 1 << 18])
def test_channelizer_matches_jax(rng, block):
    """VFOChannelizer at the phase-17 configuration's rates (an RTL-SDR
    class 2.048 Msps stream, VFOs at +-400 kHz asking for 2.4 x 72 ksym/s):
    the same decimation (12 snapped down to a divisor of the block: 8),
    actual rate and taps as JAX's; three blocks of output within FFT_ATOL
    of the float64 model and within the freq_shift rule of JAX's."""
    fs = 2.048e6
    chan, jchan = VFOChannelizer(fs, block, device="cpu"), JChan(fs, block)
    for name, off in (("a", 400e3), ("b", -400e3)):
        assert chan.add_vfo(name, off, 2.4 * 72e3) == \
            jchan.add_vfo(name, off, 2.4 * 72e3) == fs / 8
        assert chan.vfos[name].decim == jchan.vfos[name].decim == 8
    np.testing.assert_array_equal(
        chan.vfos["a"].taps,
        jfirdes.low_pass(1.0, fs, 0.4 * fs / 8, 0.2 * fs / 8
                         ).astype(np.float32))
    n = min(block, 1 << 14)
    xs, phase = [], {"a": np.float32(0), "b": np.float32(0)}
    model = {"a": [], "b": []}
    for _ in range(3):
        x = _cx(rng, block, 0.3)
        x[:n] += np.exp(2j * np.pi * 400e3 / fs * np.arange(n)
                        ).astype(np.complex64)
        xs.append(x)
        out, jout = chan.work(x), jchan.work(x)
        assert set(out) == {"a", "b"}
        for name, v in chan.vfos.items():
            assert out[name].shape == (block // 8,)
            k = np.arange(block, dtype=np.float32)
            ph = phase[name] + k * np.float32(-v.delta)
            phase[name] = np.float32(np.mod(phase[name] - block * v.delta,
                                            np.float32(2 * np.pi)))
            model[name].append(x * np.exp(1j * ph.astype(np.float64)))
            y = np.convolve(np.concatenate(model[name]),
                            v.taps.astype(np.float64))[-block - len(v.taps)
                                                        + 1:][:block][::8]
            np.testing.assert_allclose(out[name], y, atol=FFT_ATOL)
            tol = 8 * np.spacing(np.float32(block * abs(v.delta))) * \
                np.abs(x).max() * np.abs(v.taps).sum()
            np.testing.assert_allclose(out[name], jout[name], atol=tol)


def test_vfo_recorder_matches_jax(tmp_path, rng):
    """add_vfo_reco: a VFO recorded raw, the tail block padded and cut to
    its samples, as the JAX class records it."""
    fs = 800_000.0
    files = {}
    for pkg, cls, kw in (("torch", MultiVFOLive,
                          {"user_params": {"torch_device": "cpu"}}),
                         ("jax", JMulti, {})):
        mv = cls(fs, str(tmp_path / pkg), block_size=1 << 14, **kw)
        assert mv.add_vfo_recorder("rec", 100_000.0, 200_000.0) == 200_000.0
        r = np.random.default_rng(4)
        for _ in range(3):
            mv.push(_cx(r, 20_000, 0.1))
        assert mv.stop() == {"rec": []}
        files[pkg], _ = read_baseband(tmp_path / pkg / "rec.cf32", "cf32")
    assert len(files["torch"]) == len(files["jax"]) == -(-60_000 // 4)
    np.testing.assert_allclose(files["torch"], files["jax"], atol=FFT_ATOL)


def test_multivfo_default_rate_is_the_pipelines(tmp_path):
    """add_vfo without a rate takes 2.4 x the pipeline's symbol rate: the
    METEOR LRPT pipelines behind a 2.048 Msps stream run at 256 ksps; a
    deleted VFO leaves the channelizer and writes its files."""
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    pipes = parse_pipeline_file(Path(__file__).resolve().parents[1] /
                                "resources" / "pipelines" / "Meteor-M.json")
    mv = MultiVFOLive(2.048e6, str(tmp_path),
                      user_params={"torch_device": "cpu"})
    assert mv.add_vfo("a", 400e3, pipes["meteor_m2x_lrpt"]) == 256_000.0
    assert mv.chan.device.type == "cpu"
    assert mv.pipes["a"].modules[0].torch_device.type == "cpu"
    assert mv.pipes["a"].modules[0].final_sps == pytest.approx(168 / 72)
    mv.del_vfo("a")
    assert not mv.chan.vfos and not mv.pipes
    assert (tmp_path / "a" / "meteor_m2x_lrpt.soft").exists()


def test_cli_live_two_vfos(tmp_path):
    """Two QPSK carriers at -400 and +300 kHz in one 1.6 Msps stream,
    decoded through `live --vfo` on the CPU: every CADU of each carrier
    (at most 2 missing at the edges), none corrupt."""
    rng = np.random.default_rng(11)
    fs, rs = 1.6e6, 100e3
    n_cadus = 8
    wide, truth = 0, {}
    for name, off in (("a", -400e3), ("b", 300e3)):
        cadus = sim.make_cadus(n_cadus, rng)
        syms = sim.bits_to_qpsk_symbols(sim.encode_cadu_stream(cadus))
        bb = sim.ChannelModel(snr_db=20.0, phase=0.3,
                              seed=int(rng.integers(1 << 30))).apply(
            sim.qpsk_modulate(syms, sps=fs / rs))
        wide = wide + bb * np.exp(2j * np.pi * off / fs *
                                  np.arange(len(bb))) * 0.5
        truth[name] = cadus
    write_baseband(tmp_path / "wide.cf32", "cf32", wide.astype(np.complex64))
    d = tmp_path / "pipelines"
    d.mkdir()
    (d / "p.json").write_text(json.dumps({"vfo_t": {
        "name": "VFO test", "live": [1, 2], "parameters": {},
        "work": {"baseband": {},
                 "soft": {"module": "psk_demod", "parameters": {
                     "constellation": "qpsk", "symbolrate": rs,
                     "rrc_alpha": 0.5, "pll_bw": 0.005}},
                 "cadu": {"module": "metop_ahrpt_decoder",
                          "parameters": {}}}}}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--pipelines-dir", str(d), "live", "-",
                       f"file://{tmp_path / 'wide.cf32'}", str(tmp_path / "o"),
                       "--vfo", "a:-400000:vfo_t", "--vfo", "b:300000:vfo_t",
                       "--samplerate", str(fs), "--buffer_size", str(1 << 17),
                       "--torch_device", "cpu"])
    assert rc == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(res["outputs"]) == set(res["stats"]) == {"a", "b"}
    # the channelizer's blocks: the stream's, its tail padded to one
    assert res["channelizer"]["blocks"] == -(-len(wide) // (1 << 17))
    assert res["channelizer"]["host_s"] > 0
    for name, cadus in truth.items():
        cadu = [o for o in res["outputs"][name] if o.endswith(".cadu")][0]
        got = np.fromfile(cadu, np.uint8).reshape(-1, 1024)
        sent = {c.tobytes() for c in cadus}
        assert all(g.tobytes() in sent for g in got)
        assert len(got) >= n_cadus - 2, (name, len(got))
    assert cli.main(["live", "-", "file://x", "o", "--vfo", "a:1:p",
                     "--torch_device", "cpu"]) == 2
