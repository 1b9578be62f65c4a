"""The port's DVB-S2 receive chain against the JAX package's, on the CPU,
on the same inputs made from a seed: the LDPC and BCH codes, the
scramblers, the PL header, the BBFrame/TS layer, the soft demap,
DVBS2Demod on the JAX suite's loopbacks and on GOES-R GRB's MODCOD 11,
dvbs2_demod's front end, the baseband -> TS pipeline and GRB's CADU
extractor.

Tolerances, and why: the soft demap's squared distances are formed in
torch as XLA's CPU code forms |y - p| (its scaled complex magnitude, the
1 + q^2 fused), each step correctly rounded. XLA's own magnitude is not
correctly rounded, and not the same from run to run of the JAX package:
in most runs about 1 % of the LLRs differ from the port's in the last
bits (at most 5.3e-5 on LLRs of magnitude up to ~120), but one run of
this file saw 12 % of the QPSK LLRs differ by up to 9e-4 relative. So
LLRs are held within LLR_ATOL + LLR_RTOL x |LLR|. Every later stage is
exact (the min-sum sums in XLA's order), so bits, BBFrames, TS packets
and CADUs must be equal. The front end's symbols are held as
tests/test_torch_ffsync.py holds the feedforward sync.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops.dvbs2 import bbframe as jbb
from satdump_tpu.ops.dvbs2 import bch as jbch
from satdump_tpu.ops.dvbs2 import defs as jdefs
from satdump_tpu.ops.dvbs2 import demap as jdemap
from satdump_tpu.ops.dvbs2 import ldpc as jldpc
from satdump_tpu.ops.dvbs2 import plsync as jpl
from satdump_tpu.ops.dvbs2 import scrambling as jscr
from satdump_tpu.ops.dvbs2 import tx as jtx
from satdump_tpu.ops.dvbs2.rx import DVBS2Demod as JDemod
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops.dvbs2 import bbframe as tbb
from satdump_tpu_torch.ops.dvbs2 import bch as tbch
from satdump_tpu_torch.ops.dvbs2 import defs as tdefs
from satdump_tpu_torch.ops.dvbs2 import demap as tdemap
from satdump_tpu_torch.ops.dvbs2 import ldpc as tldpc
from satdump_tpu_torch.ops.dvbs2 import plsync as tpl
from satdump_tpu_torch.ops.dvbs2 import scrambling as tscr
from satdump_tpu_torch.ops.dvbs2 import tx as ttx
from satdump_tpu_torch.ops.dvbs2.rx import DVBS2Demod as TDemod

LLR_ATOL = 1e-4
LLR_RTOL = 2e-3


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


def _ts(rng, n=20):
    ts = rng.integers(0, 256, (n, 188), dtype=np.uint8)
    ts[:, 0] = 0x47
    return ts


def _awgn(rng, x, esn0_db):
    s = np.sqrt(1.0 / (2 * 10 ** (esn0_db / 10)))
    n = (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return (x + s * n).astype(np.complex64)


# -- the codes ----------------------------------------------------------------
CODES = [("short", "1/2"), ("normal", "9/10")]


@pytest.mark.parametrize("frame,rate", CODES)
def test_ldpc_code_equals_jax(frame, rate):
    jc, jk = jldpc.make_code(frame, rate)
    tc, tk = tldpc.make_code(frame, rate)
    assert (tk, tc.n, tc.m, tc.dc_max, tc.dv_max) == \
        (jk, jc.n, jc.m, jc.dc_max, jc.dv_max)
    np.testing.assert_array_equal(tc.chk_vars, jc.chk_vars)


@pytest.mark.parametrize("frame,rate", CODES)
def test_minsum_bits_and_ok_equal_jax(rng, frame, rate):
    """Noisy BPSK LLRs of encoded frames near the code's threshold (some
    frames fail, so `ok` is tested both ways)."""
    j = jldpc.get_ldpc(frame, rate, iters=30)
    t = tldpc.get_ldpc(frame, rate, iters=30)
    enc = tldpc.IRAEncoder(frame, rate)
    msg = rng.integers(0, 2, (3, t.K), dtype=np.uint8)
    cw = enc.encode(msg)
    np.testing.assert_array_equal(cw, jldpc.IRAEncoder(frame, rate)
                                  .encode(msg))
    x = 1.0 - 2.0 * cw.astype(np.float32)
    ebn0 = {"1/2": [3.0, 1.0, 0.0], "9/10": [5.0, 3.2, 2.6]}[rate]
    sig = np.array([np.sqrt(1.0 / (2 * (t.K / t.N) * 10 ** (e / 10)))
                    for e in ebn0], np.float32)[:, None]
    llr = (2 * (x + sig * rng.standard_normal(cw.shape)) / sig ** 2
           ).astype(np.float32)
    jb, jok = j.decode(llr)
    tb, tok = t.decode(llr, device="cpu")
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tok, jok)
    assert tok[0] and np.array_equal(tb[0, : t.K], msg[0])


@pytest.mark.parametrize("frame,rate", [("short", "1/2"), ("normal", "9/10")])
def test_bch_corrects_t_errors_as_jax(rng, frame, rate):
    jb, tb = jbch.get_bch(frame, rate), tbch.get_bch(frame, rate)
    msg = rng.integers(0, 2, (3, tb.kbch), dtype=np.uint8)
    cw = tb.encode(msg)
    np.testing.assert_array_equal(cw, jb.encode(msg))
    for i, row in enumerate(cw):
        nerr = (tb.t, tb.t - 1, tb.t + 2)[i]   # the last one uncorrectable
        row[rng.choice(len(row), size=nerr, replace=False)] ^= 1
    jc, jn = jb.decode(cw)
    tc, tn = tb.decode(cw)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    assert list(tn[:2]) == [tb.t, tb.t - 1]
    np.testing.assert_array_equal(tc[:2, : tb.kbch], msg[:2])


def test_scramblers_equal_jax(rng):
    np.testing.assert_array_equal(tscr.pl_scramble_rn(0),
                                  jscr.pl_scramble_rn(0))
    np.testing.assert_array_equal(tscr.bb_scramble_bytes(),
                                  jscr.bb_scramble_bytes())
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
         ).astype(np.complex64)
    np.testing.assert_array_equal(tscr.pl_descramble(x),
                                  jscr.pl_descramble(x))
    frames = rng.integers(0, 256, (3, 879), dtype=np.uint8)
    np.testing.assert_array_equal(tscr.bb_derandomize(frames),
                                  jscr.bb_derandomize(frames))


# -- the PL header ------------------------------------------------------------
@pytest.mark.parametrize("pls", [16, 18, 44, 49, 72, 101])
def test_decode_pls_equals_jax(rng, pls):
    hdr = np.concatenate([tdefs.sof_symbols(), tdefs.pls_symbols()[pls]])
    np.testing.assert_array_equal(hdr, np.concatenate(
        [jdefs.sof_symbols(), jdefs.pls_symbols()[pls]]))
    n = np.arange(tdefs.HDR_LEN)
    rx = _awgn(rng, hdr * np.exp(1j * (0.01 * n + 1.1)), 8.0)
    got = tpl.decode_pls(rx)
    assert got == jpl.decode_pls(rx)
    assert got[0] == pls


def test_find_frame_offset_equals_jax(rng):
    cfg = tdefs.get_modcod_cfg(4, True, False)
    syms = ttx.ts_to_symbols(_ts(rng, 20), 4, True, False)
    x = _awgn(rng, np.concatenate([syms[-777:], syms]), 5.0)
    got = tpl.find_frame_offset(x, tdefs.plframe_len(cfg))
    assert got == jpl.find_frame_offset(x, jdefs.plframe_len(cfg))
    assert got[0] == 777


# -- BBFrames and TS ----------------------------------------------------------
def test_bbheader_crc_and_ts_parse_equal_jax(rng):
    kbch = tbch.get_bch("short", "1/2").kbch
    ts = _ts(rng, 30)
    frames = tbb.ts_to_bbframes(ts, kbch)
    np.testing.assert_array_equal(frames, jbb.ts_to_bbframes(ts, kbch))
    for f in frames:
        assert tbb.header_crc(f[:9]) == jbb.header_crc(f[:9]) == f[9]
        assert tbb.header_crc_ok(f[:10]) and jbb.header_crc_ok(f[:10])
    bad = frames.copy()
    bad[1, 3] ^= 0x10                       # a header error
    bad[2, 500] ^= 0x01                     # a packet CRC error
    tp, jp = tbb.BBFrameTSParser(kbch), jbb.BBFrameTSParser(kbch)
    np.testing.assert_array_equal(tp.work(bad), jp.work(bad))
    assert (tp.header_errors, tp.packet_crc_errors) == \
        (jp.header_errors, jp.packet_crc_errors) != (0, 0)


# -- the soft demap -----------------------------------------------------------
@pytest.mark.parametrize("modcod", [4, 12, 18, 24],
                         ids=["qpsk", "8psk", "16apsk", "32apsk"])
def test_soft_demap_within_tolerance_of_jax(rng, modcod):
    cfg = tdefs.get_modcod_cfg(modcod, True, False)
    pts = tdefs.constellation(cfg.constellation, cfg.g1, cfg.g2)
    y = _awgn(rng, pts[rng.integers(0, len(pts), (3, 4000))], 12.0)
    a = jdemap.soft_demap(y, cfg.constellation, cfg.g1, cfg.g2,
                          noise_var=0.0731)
    b = tdemap.soft_demap(y, cfg.constellation, cfg.g1, cfg.g2,
                          noise_var=0.0731, device="cpu")
    assert b.shape == a.shape and b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=LLR_RTOL, atol=LLR_ATOL)
    np.testing.assert_array_equal(
        tdemap.deinterleave(b, cfg.constellation, cfg.rate)[..., :16200],
        jdemap.deinterleave(b, cfg.constellation, cfg.rate)[..., :16200])
    # the tensor path deinterleaves as the NumPy one
    np.testing.assert_array_equal(
        tdemap.deinterleave(torch.from_numpy(b), cfg.constellation,
                            cfg.rate).numpy(),
        jdemap.deinterleave(b, cfg.constellation, cfg.rate))


# -- DVBS2Demod ---------------------------------------------------------------
LOOPBACKS = [(4, True, False, 5.0, 20), (12, True, False, 11.0, 20),
             (4, True, True, 5.0, 20), (18, True, True, 14.0, 20),
             (24, True, False, 19.0, 20), (11, False, False, 8.0, 24)]


@pytest.mark.parametrize("modcod,short,pilots,esn0,nts", LOOPBACKS,
                         ids=["qpsk12_short", "8psk35_short",
                              "qpsk12_pilots", "16apsk23_pilots",
                              "32apsk34", "grb_qpsk910_normal"])
def test_dvbs2demod_bbframes_equal_jax(rng, modcod, short, pilots, esn0,
                                       nts):
    """The JAX suite's loopbacks (tests/test_dvbs2.py::_loopback), and
    GOES-R GRB's MODCOD 11 in normal frames, in two calls (a frame carried
    across)."""
    ts = _ts(rng, nts)
    syms = ttx.ts_to_symbols(ts, modcod, short, pilots)
    np.testing.assert_array_equal(syms, jtx.ts_to_symbols(ts, modcod, short,
                                                          pilots))
    n = np.arange(len(syms) + 1000)
    x = np.concatenate([syms[-1000:], syms]) * np.exp(1j * (0.002 * n + 0.9))
    x = _awgn(rng, x, esn0)
    cut = len(x) // 2 + 123
    j, t = JDemod(modcod, short, pilots), TDemod(modcod, short, pilots,
                                                  device="cpu")
    jf = np.concatenate([j.process(x[:cut]), j.process(x[cut:])])
    tf = np.concatenate([t.process(x[:cut]), t.process(x[cut:])])
    np.testing.assert_array_equal(tf, jf)
    assert t.stats == j.stats
    assert t.stats["detected_modcod"] == modcod and t.stats["ldpc_ok"] >= 1
    out = tbb.BBFrameTSParser(t.kbch).work(tf).reshape(-1, 188)
    sent = {r.tobytes() for r in ts}
    assert len(out) and all(r.tobytes() in sent for r in out)


# -- dvbs2_demod's front end --------------------------------------------------
def test_front_end_two_blocks_match_jax(rng, tmp_path):
    """dvbs2_demod's front end (AGC, RRC, feedforward timing at 2 sps) on
    two consecutive blocks, each package carrying its own state."""
    from satdump_tpu.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule as J
    from satdump_tpu_torch.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule as T
    N = 1 << 15
    syms = ttx.ts_to_symbols(_ts(rng, 30), 4, True, False)
    bb = sim.dvbs2_baseband(syms, rng)[: 2 * N]
    params = {"samplerate": 200e3, "symbolrate": 100e3, "rrc_alpha": 0.25,
              "modcod": 4, "buffer_size": N}
    jm = J(str(tmp_path / "x"), str(tmp_path / "j"), params)
    tm = T(str(tmp_path / "x"), str(tmp_path / "t"),
           dict(params, torch_device="cpu"))
    jm._build()
    tm._build()
    for blk in range(2):
        x = bb[blk * N: (blk + 1) * N]
        jm._state, js, jv = jm._step(jm._state, jnp.asarray(x))
        ts, tv = tm.front_end(torch.from_numpy(x))
        js, jv, ts, tv = (np.asarray(js), np.asarray(jv), ts.numpy(),
                          tv.numpy())
        np.testing.assert_array_equal(tv, jv)
        assert jv.sum() > 0.9 * N / 2
        err = np.abs(ts - js)[jv]
        assert err.max() < 0.05, err.max()
        assert np.median(err) < 1e-3, np.median(err)


# -- the pipeline -------------------------------------------------------------
def _s2_pipeline(symbolrate, modcod, short, pilots):
    from satdump_tpu_torch.pipeline.pipeline import Pipeline, PipelineStep
    return Pipeline(id="dvbs2_t", name="DVB-S2 test", steps=[
        PipelineStep("baseband", ""),
        PipelineStep("bbframe", "dvbs2_demod", {
            "symbolrate": symbolrate, "rrc_alpha": 0.25, "modcod": modcod,
            "shortframes": short, "pilots": pilots}),
        PipelineStep("ts", "dvbs2_ts_extractor", {
            "modcod": modcod, "shortframes": short})], parameters={})


@pytest.mark.parametrize("samplerate", [200_000.0, 250_000.0],
                         ids=["sps_2", "resampled_from_2.5"])
def test_pipeline_baseband_to_ts_equals_jax(tmp_path, rng, samplerate):
    """The JAX package's slow pipeline test's setup
    (tests/test_dvbs2.py::test_dvbs2_pipeline_baseband_to_ts: 40 TS
    packets, 100 ksym/s, MODCOD 4 short) through both packages; at 250 ksps
    the input resampler takes it to 2 sps."""
    from satdump_tpu import sim as jsim
    from satdump_tpu.io import write_baseband
    from satdump_tpu.pipeline.pipeline import Pipeline, PipelineStep
    from satdump_tpu.pipeline.runner import run_pipeline as jrun
    from satdump_tpu_torch.pipeline.runner import run_pipeline as trun
    symbolrate, modcod, short, pilots = 100_000.0, 4, True, False
    ts = _ts(rng, 40)
    syms = ttx.ts_to_symbols(ts, modcod, short, pilots)
    bbs = jsim.qpsk_modulate(syms, sps=samplerate / symbolrate,
                             rrc_alpha=0.25, rrc_taps=31)
    iq = jsim.ChannelModel(snr_db=14.0, freq_offset=1e-4, phase=0.5,
                           gain=0.7, seed=5).apply(bbs)
    path = tmp_path / "s2.cf32"
    write_baseband(path, "cf32", iq)
    tp = _s2_pipeline(symbolrate, modcod, short, pilots)
    jp = Pipeline(id=tp.id, name=tp.name, parameters={}, steps=[
        PipelineStep(s.level, s.module_id, s.parameters) for s in tp.steps])
    user = {"samplerate": samplerate, "buffer_size": 1 << 17}
    jout = jrun(jp, str(path), str(tmp_path / "j"), user_params=user)
    tout = trun(tp, str(path), str(tmp_path / "t"),
                user_params=dict(user, torch_device="cpu"))
    jts, tts = np.fromfile(jout, np.uint8), np.fromfile(tout, np.uint8)
    np.testing.assert_array_equal(tts, jts)
    got = tts.reshape(-1, 188)
    assert len(got) >= 20, f"only {len(got)} TS packets"
    sent = {r.tobytes() for r in ts}
    assert all(r.tobytes() in sent for r in got)


def test_missing_modcod_raises_in_both_packages(tmp_path):
    """dvbs2_demod given no `modcod` (or no `rrc_alpha`) raises in both
    packages, as `required=True` does in the JAX module."""
    from satdump_tpu.core.exceptions import SatdumpError as JErr
    from satdump_tpu.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule as J
    from satdump_tpu_torch.core.exceptions import SatdumpError as TErr
    from satdump_tpu_torch.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule as T
    params = {"samplerate": 2e6, "symbolrate": 1e6, "rrc_alpha": 0.25}
    with pytest.raises(JErr, match="modcod"):
        J(str(tmp_path / "x"), str(tmp_path / "j"), params)
    with pytest.raises(TErr, match="modcod"):
        T(str(tmp_path / "x"), str(tmp_path / "t"),
          dict(params, torch_device="cpu"))
    with pytest.raises(TErr, match="rrc_alpha"):
        T(str(tmp_path / "x"), str(tmp_path / "t"),
          {"samplerate": 2e6, "modcod": 4, "torch_device": "cpu"})


@pytest.mark.parametrize("fname,pipe_id,modcod", [
    ("DVB-S2.json", "dvbs2", 4), ("DVB_Test.json", "dvbs2_test", 11)])
def test_dvbs2_pipeline_files_give_modcod(fname, pipe_id, modcod):
    """`dvbs2` and `dvbs2_test` set no `modcod` in dvbs2_demod's step; it
    comes from the file's parameters block ({"value": ...}), which both
    packages merge under the step's parameters."""
    from pathlib import Path

    from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    path = Path(__file__).resolve().parents[1] / "resources" / "pipelines" \
        / fname
    got = []
    for parse in (jparse, parse_pipeline_file):
        pipe = parse(path)[pipe_id]
        step = next(s for s in pipe.steps if s.module_id == "dvbs2_demod")
        assert "modcod" not in step.parameters
        got.append(pipe.prepare_parameters(step, {"samplerate": 2e6}))
    assert got[0] == got[1]
    assert got[1]["modcod"] == modcod and got[1]["rrc_alpha"] == 0.25


# -- GOES-R GRB's CADU extractor ---------------------------------------------
def test_grb_cadu_extractor_equals_jax(rng, tmp_path):
    """BBFrames whose CADU stream starts 777 bytes into the first data
    field and holds a corrupt ASM: the .cadu equals the JAX module's."""
    from satdump_tpu.models.goes_grb import GRBCaduExtractorModule as J
    from satdump_tpu_torch.models import goes_grb as tg
    from satdump_tpu_torch.models.goes_grb import GRBCaduExtractorModule as T
    cadus = rng.integers(0, 256, (12, tg.CADU_SIZE), dtype=np.uint8)
    cadus[:, :4] = np.frombuffer(tg.ASM, np.uint8)
    cadus[5, 1] ^= 0x40
    frames = sim.grb_bbframes(cadus, lead=777)
    assert frames.shape[1] == tg.BBFRAME_SIZE
    frames.tofile(tmp_path / "in.bbframe")
    outs = []
    for cls, hint in ((J, "j"), (T, "t")):
        m = cls(str(tmp_path / "in.bbframe"), str(tmp_path / hint), {})
        m.process()
        outs.append(np.fromfile(m.d_output_file, np.uint8))
    np.testing.assert_array_equal(outs[1], outs[0])
    got = outs[1].reshape(-1, tg.CADU_SIZE)
    assert len(got) >= 10
    good = [i for i in range(12) if i != 5]
    np.testing.assert_array_equal(got[: 4], cadus[: 4])
    assert {g.tobytes() for g in got} >= {cadus[i].tobytes()
                                          for i in good[:9]}


# -- entry points run on the card unless asked for the CPU -------------------
def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    from satdump_tpu_torch.core.exceptions import SatdumpError
    from satdump_tpu_torch.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule
    from satdump_tpu_torch.pipeline.modules.dvbs2.dvbs import DVBSDemodModule
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SatdumpError, match="cuda"):
        TDemod(11)
    with pytest.raises(SatdumpError, match="cuda"):
        tdemap.soft_demap(np.zeros((1, 90), np.complex64), "qpsk")
    with pytest.raises(SatdumpError, match="cuda"):
        DVBS2DemodModule(str(tmp_path / "x"), str(tmp_path / "o"), {
            "samplerate": 2e6, "symbolrate": 1e6, "rrc_alpha": 0.25,
            "modcod": 4})
    with pytest.raises(SatdumpError, match="cuda"):
        DVBSDemodModule(str(tmp_path / "x"), str(tmp_path / "o"), {
            "samplerate": 2e6, "symbolrate": 1e6})

