"""Pipelines of the classic demod chain and the simple PSK decoder, baseband
-> .soft -> .cadu through both packages on the CPU:
* elektro_ggak: pm_demod -> ccsds_simple_psk_decoder (BPSK, 1792-bit
  frames, no RS), 5 ksym/s at 40 ksps;
* integral_s_link: pm_demod -> ccsds_conv_concat_decoder (bpsk_90, 8192-bit
  CADUs, RS(255,239) x 4), 262 ksym/s at 2.096 Msps (sps 8, no resampler);
* sts1_9k6: fsk_demod resampled from 140 ksps -> ccsds_simple_psk_decoder
  (rs_i 1);
* gk2a_cdas: psk_demod (fast) -> ccsds_simple_psk_decoder (QPSK on the
  dual deframer, rs_i 5), at cadu_size 10232: at the file's own 10112 with
  `rs_fill_bytes: 3`, which no module reads, both packages fail
  (tests/test_torch_simple_psk.py).

On the CPU the classic chain's recurrences run their kernels' plain
versions. The signals are sim.pm_bpsk_baseband (PM on a subcarrier at the
symbol rate), sim.fsk_baseband and a QPSK downlink, each from a seed.

Tolerances, and why: .cadu none, byte-identical to the JAX package's and
holding the CADUs sent (at most 2 missing at the stream's edges); .soft the
same length, every soft within 3 LSB and the mean below 0.05 LSB (the
loops' float64 transcendentals against XLA's float32 ones, and torch.fft
against XLA's FFT: tests/test_torch_classic.py).
"""

from pathlib import Path

import numpy as np
import pytest

from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
from satdump_tpu.pipeline.runner import run_pipeline as jrun
from satdump_tpu_torch import sim
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file as tparse
from satdump_tpu_torch.pipeline.runner import run_pipeline as trun

ROOT = Path(__file__).resolve().parents[1]
PIPELINES = ROOT / "resources" / "pipelines"
DECODER_BUFFER = 131072


def _steps(parse, fname, pipe_id, start, stop):
    pipe = parse(PIPELINES / fname)[pipe_id]
    pipe.steps = pipe.steps[pipe.level_index(start): pipe.level_index(stop) + 1]
    return pipe


def _run_both(tmp_path, fname, pipe_id, bb, params, decoder_params=None):
    """bb -> .soft -> .cadu in both packages; returns the two .cadu paths."""
    src = tmp_path / "bb.cf32"
    write_baseband(src, "cf32", bb)
    outs = []
    for run, parse, extra, name in ((trun, tparse, {"torch_device": "cpu"},
                                     "torch"), (jrun, jparse, {}, "jax")):
        soft = run(_steps(parse, fname, pipe_id, "baseband", "soft"),
                   str(src), str(tmp_path / name),
                   user_params=dict(params, **extra))
        outs.append(run(_steps(parse, fname, pipe_id, "soft", "cadu"), soft,
                        str(tmp_path / name), start_level="soft",
                        user_params=dict(params, **(decoder_params or {}),
                                         **extra)))
    return outs


def _assert_match(tout, jout, cadus):
    tc, jc = Path(tout).read_bytes(), Path(jout).read_bytes()
    assert tc == jc
    got = np.frombuffer(tc, np.uint8).reshape(-1, cadus.shape[1])
    sent = [c.tobytes() for c in cadus]
    assert len(got) >= len(cadus) - 2
    assert all(g.tobytes() in sent for g in got)
    ts = np.fromfile(Path(tout).with_suffix(".soft"), np.int8)
    js = np.fromfile(Path(jout).with_suffix(".soft"), np.int8)
    assert ts.shape == js.shape and len(ts) > cadus.size * 8
    d = np.abs(ts.astype(np.int16) - js)
    assert d.max() <= 3 and d.mean() < 0.05, (d.max(), d.mean())


def test_elektro_ggak_pm_simple_psk(tmp_path):
    rng = np.random.default_rng(21)
    body = rng.integers(0, 256, (6, 220)).astype(np.uint8)
    cadus = np.concatenate([np.tile(np.array([0x1A, 0xCF, 0xFC, 0x1D],
                                             np.uint8), (6, 1)), body], 1)
    bb = sim.pm_bpsk_baseband(sim.encode_cadu_stream_uncoded(
        cadus, randomize=False), 8, rng, tail_bits=1024)
    _assert_match(*_run_both(tmp_path, "Elektro_Arktika.json",
                             "elektro_ggak", bb,
                             {"samplerate": 40e3, "buffer_size": 16384}),
                  cadus)


def test_integral_s_link_pm_conv_concat(tmp_path):
    """bpsk_90: the second code symbol of each pair is sent inverted, as
    CCSDS sends it."""
    rng = np.random.default_rng(22)
    cadus = sim.make_cadus(3, rng, rs=ReedSolomon(k=239))
    bits = sim.encode_cadu_stream(cadus)
    bits[1::2] ^= 1
    bb = sim.pm_bpsk_baseband(bits, 8, rng)
    _assert_match(*_run_both(tmp_path, "Integral.json", "integral_s_link",
                             bb, {"samplerate": 2.096e6,
                                  "buffer_size": 32768},
                             {"buffer_size": DECODER_BUFFER}), cadus)


def test_sts1_9k6_fsk_simple_psk(tmp_path):
    """140 ksps (sps 14.6) resampled by 4/7 to 80 ksps (MAX_SPS 8)."""
    rng = np.random.default_rng(23)
    cadus = sim.make_cadus(6, rng, cadu_bytes=259, rs_i=1)
    bb = sim.fsk_baseband(sim.encode_cadu_stream_uncoded(cadus), 140e3, 9600,
                          rng, 2400.0)
    _assert_match(*_run_both(tmp_path, "spaceteamsat1.json", "sts1_9k6", bb,
                             {"buffer_size": 16384}), cadus)


def test_gk2a_cdas_psk_simple_psk(tmp_path):
    """QPSK at 7.74 Msps (sps 2.5: the polyphase symbol pick), uncoded,
    on the dual deframer; RS(255,223) x 5."""
    rng = np.random.default_rng(24)
    cadus = sim.make_cadus(4, rng, cadu_bytes=1279, rs_i=5)
    bits = sim.encode_cadu_stream_uncoded(cadus)
    bits = np.concatenate([rng.integers(0, 2, 2048).astype(np.uint8), bits,
                           rng.integers(0, 2, 2048).astype(np.uint8)])
    # the decoder takes each symbol's Q bit first (constellation.cpp)
    syms = sim.bits_to_qpsk_symbols(bits.reshape(-1, 2)[:, ::-1].reshape(-1))
    bb = sim.ChannelModel(snr_db=15.0, freq_offset=1e-4, phase=0.4,
                          seed=5).apply(sim.qpsk_modulate_rational(syms, 5, 2))
    _assert_match(*_run_both(tmp_path, "GK2A.json", "gk2a_cdas", bb,
                             {"samplerate": 7.74e6, "buffer_size": 16384,
                              "cadu_size": 10232}), cadus)
