"""The port's Inmarsat STD-C and Aero modules against the JAX package's, on
the CPU, on the same inputs made from a seed: the frame coding (sync
search, permutation, interleaving, scrambling, puncturing, the LFSR), the
block Viterbi of both decoders, the Aero correlator, both decoder modules
and both parsers.

Tolerances, and why:
* frames, .frm, the parsers' JSON files: none (the same bits in both
  packages: the block Viterbi is exact in float32 on either side);
* the Aero correlator's normalized peak `cor`: 1e-5. The port correlates
  with torch.fft, the JAX package with XLA's FFT, and the two round their
  sums differently in the last bits; the offset, phase and swap it picks
  are equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from satdump_tpu.ops import inmarsat_aero as jaero
from satdump_tpu.ops import inmarsat_stdc as jstdc
from satdump_tpu.ops.fec.correlator import CorrelatorGeneric as JCorr
from satdump_tpu.pipeline.modules.inmarsat import aero_decoder as jad
from satdump_tpu.pipeline.modules.inmarsat import aero_parser as jap
from satdump_tpu.pipeline.modules.inmarsat import stdc_decoder as jsd
from satdump_tpu.pipeline.modules.inmarsat import stdc_parser as jsp
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.ops import inmarsat_aero as taero
from satdump_tpu_torch.ops import inmarsat_stdc as tstdc
from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric as TCorr
from satdump_tpu_torch.pipeline.modules.inmarsat import aero_decoder as tad
from satdump_tpu_torch.pipeline.modules.inmarsat import aero_parser as tap
from satdump_tpu_torch.pipeline.modules.inmarsat import stdc_decoder as tsd
from satdump_tpu_torch.pipeline.modules.inmarsat import stdc_parser as tsp

START = 86400 * 1000          # the parsers' start_timestamp (no wall clock)
P_CFG = dict(oqpsk=False, dummy_bits=0, inter_cols=6, inter_blocks=3)
R_CFG = dict(oqpsk=True, dummy_bits=178, inter_cols=78, inter_blocks=1)
C_CFG = dict(is_c=True, oqpsk=True, dummy_bits=0, inter_cols=4,
             inter_blocks=16, ber_thresold=0.25)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The block Viterbi is a loop of ~15 small torch ops a trellis step;
    with one intra-op thread it does not wait on a thread pool that the
    other test workers of a parallel run keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(bits: np.ndarray, rng, sigma: float = 0.3, pad: int = 700,
           invert: bool = False) -> np.ndarray:
    """Channel bits -> int8 softs of +-100 with Gaussian noise of sigma x
    100, random softs before and after."""
    soft = np.where(bits > 0, 100.0, -100.0) + rng.normal(0, sigma * 100,
                                                           len(bits))
    if invert:
        soft = -soft
    noise = rng.integers(-50, 50, pad)
    return np.concatenate([noise, soft, noise]).clip(-127, 127).astype(
        np.int8)


def _rotate90(soft: np.ndarray) -> np.ndarray:
    c = (soft[0::2].astype(np.float32) + 1j * soft[1::2]) * 1j
    out = np.empty(len(soft), np.float32)
    out[0::2], out[1::2] = c.real, c.imag
    return out.clip(-127, 127).astype(np.int8)


def _json_tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*.json"))}


def _run(cls, src, out, params):
    mod = cls(str(src), str(out), dict(params))
    mod.process()
    return mod


# -- STD-C --------------------------------------------------------------------

def test_stdc_coding_equals_jax(rng):
    frame = rng.integers(0, 256, tstdc.FRAME_SIZE_BYTES).astype(np.uint8)
    bits = tstdc.encode_frame(frame)
    np.testing.assert_array_equal(bits, jstdc.encode_frame(frame))
    np.testing.assert_array_equal(tstdc.scramble(frame),
                                  jstdc.scramble(frame))
    soft = _noisy(np.concatenate([bits, tstdc.encode_frame(frame[::-1])]),
                  rng, 0.45)
    np.testing.assert_array_equal(tstdc.frame_match_scores(soft),
                                  jstdc.frame_match_scores(soft))
    assert tstdc.find_frames(soft) == jstdc.find_frames(soft) == \
        [(700, False), (700 + tstdc.ENCODED_FRAME_SIZE, False)]
    f = soft[700: 700 + tstdc.ENCODED_FRAME_SIZE]
    np.testing.assert_array_equal(tstdc.deinterleave(tstdc.depermute(f)),
                                  jstdc.deinterleave(jstdc.depermute(f)))


def test_stdc_decode_frames_equal_jax(rng):
    """Three noisy frames, one inverted, as rows of one block decode and
    one at a time: bytes and BER equal the JAX package's per frame."""
    frames = rng.integers(0, 256, (3, 640)).astype(np.uint8)
    rows = np.stack([_noisy(tstdc.encode_frame(f), rng, s, pad=0)
                     for f, s in zip(frames, (0.3, 0.45, 0.5))])
    data, bers = tstdc.decode_frames(rows, "cpu")
    for i, row in enumerate(rows):
        jd, jb = jstdc.decode_frame(row)
        td, tb = tstdc.decode_frame(row, "cpu")
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(data[i], jd)
        assert tb == jb == bers[i]
    np.testing.assert_array_equal(data, frames)


def test_stdc_modules_equal_jax(tmp_path, rng):
    """sim.stdc_frames() (Bulletin Boards, a two-piece message, an EGC
    message), inverted and noisy -> .frm -> the parser's JSON files."""
    frames = sim.stdc_frames()
    soft = _noisy(np.concatenate([tstdc.encode_frame(f) for f in frames]),
                  rng, 0.3, invert=True)
    soft.tofile(tmp_path / "x.soft")
    dec = {"jax": _run(jsd.STDCDecoderModule, tmp_path / "x.soft",
                       tmp_path / "jax", {}),
           "torch": _run(tsd.STDCDecoderModule, tmp_path / "x.soft",
                         tmp_path / "torch", {"torch_device": "cpu"})}
    frm = {k: Path(m.d_output_file).read_bytes() for k, m in dec.items()}
    assert frm["torch"] == frm["jax"] == frames.tobytes()
    assert dec["torch"].stats == dec["jax"].stats
    par = {k: _run(cls, dec[k].d_output_file, tmp_path / k / "msg" / "x",
                   {"start_timestamp": START})
           for k, cls in (("jax", jsp.STDCParserModule),
                          ("torch", tsp.STDCParserModule))}
    assert par["torch"].stats == par["jax"].stats
    tree = _json_tree(tmp_path / "torch" / "msg")
    assert tree == _json_tree(tmp_path / "jax" / "msg")
    full = [json.loads(v) for k, v in tree.items()
            if k.startswith("Full Message")]
    assert [m["message"] for m in full] == ["THE QUICK BROWN FOX JUMPS OVER"]
    assert any(k.startswith("EGC Message") for k in tree)


def test_stdc_decoder_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default")
    with pytest.raises(SatdumpError):
        tsd.STDCDecoderModule("x.soft", "out", {})


# -- Aero ---------------------------------------------------------------------

def test_aero_coding_equals_jax(rng):
    for cols in (4, 6, 9, 78):
        data = rng.integers(-100, 100, 64 * cols).astype(np.int8)
        np.testing.assert_array_equal(taero.interleave(data, cols),
                                      jaero.interleave(data, cols))
        np.testing.assert_array_equal(taero.deinterleave(data, cols),
                                      jaero.deinterleave(data, cols))
    for n in (1152, 5460, 4992):
        np.testing.assert_array_equal(taero.randomization_seq(n),
                                      jaero.randomization_seq(n))
    soft = rng.integers(-127, 128, 4095).astype(np.int8)
    for shift in (2, 3):
        np.testing.assert_array_equal(taero.depuncture(soft, shift),
                                      jaero.depuncture(soft, shift))
    packed = taero.pack_c84(rng.integers(0, 256, 300).astype(np.uint8),
                            rng.integers(0, 256, 36).astype(np.uint8))
    for a, b in zip(taero.unpack_c84(packed), jaero.unpack_c84(packed)):
        np.testing.assert_array_equal(a, b)
    for cfg in (P_CFG, R_CFG, C_CFG):
        geo = dict(cfg)
        geo.pop("ber_thresold", None)
        n = 336 if cfg is C_CFG else taero.frame_geometry(**geo)["info"] // 16
        payload = rng.integers(0, 256, n).astype(np.uint8)
        seed = int(rng.integers(1 << 30))
        np.testing.assert_array_equal(
            taero.encode_frame(payload, **geo,
                               rng=np.random.default_rng(seed)),
            jaero.encode_frame(payload, **geo,
                               rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", range(8))
def test_aero_correlator_equals_jax(seed):
    """The decoder's window (two frames) of noisy 10.5k OQPSK softs, rotated
    by 0 / 90 / 180 / 270 degrees and with the Q rail a symbol late in
    turn: the same offset, phase and swap, `cor` within 1e-5 and on the
    same side of the decoder's 0.5."""
    rng = np.random.default_rng(seed)
    frames = [taero.encode_frame(rng.integers(0, 256, 312).astype(np.uint8),
                                 **R_CFG, rng=rng) for _ in range(2)]
    soft = _noisy(np.concatenate(frames), rng, 0.5, pad=int(rng.integers(
        2, 400)) * 2)
    for _ in range(seed % 4):
        soft = _rotate90(soft)
    if seed >= 4:
        soft = sim.oqpsk_q_late(soft)
    window = soft[:2 * len(frames[0])]
    t = TCorr("oqpsk", taero.SYNC_OQPSK, "cpu").correlate(window)
    j = JCorr("oqpsk", jaero.SYNC_OQPSK).correlate(window)
    assert t[:3] == tuple(j[:3])
    assert abs(t[3] - float(j[3])) <= 1e-5
    assert (t[3] < 0.5) == (float(j[3]) < 0.5)     # the decoder's lock test


def _sus_payload(n_bytes: int, msg: str) -> np.ndarray:
    """An ACARS message's signal units, then zero filler (a failed CRC the
    parser skips), cut to one frame's payload."""
    sus = sim.acars_signal_units("G-ABCD", "Q0", msg)
    return np.frombuffer(sus.ljust(n_bytes, b"\0")[:n_bytes], np.uint8)


@pytest.mark.parametrize("cfg,rotate", [(P_CFG, False), (R_CFG, True),
                                        (C_CFG, True)],
                         ids=["p_600", "r_10500", "c_8400"])
def test_aero_modules_equal_jax(tmp_path, rng, cfg, rotate):
    """Three frames per channel type (OQPSK streams at +90 degrees, as a
    real demod gives them) -> .frm -> the parser's JSON files. Both modules
    take the best sync of a two-frame window, which with noise may be the
    second frame's, so a frame can be passed over in both: every frame out
    must be one sent."""
    geo = dict(cfg)
    geo.pop("ber_thresold", None)
    if cfg is C_CFG:
        payloads = [taero.pack_c84(rng.integers(0, 256, 300).astype(np.uint8),
                                   _sus_payload(36, "VOICE"))
                    for _ in range(3)]
    else:
        n = taero.frame_geometry(**geo)["info"] // 16
        payloads = [_sus_payload(n, f"HELLO AERO {i}") for i in range(3)]
    bits = np.concatenate([taero.encode_frame(p, **geo, rng=rng)
                           for p in payloads])
    soft = _noisy(bits, rng, 0.3, pad=500)
    if rotate:
        soft = _rotate90(soft)
    soft.tofile(tmp_path / "a.soft")
    dec = {"jax": _run(jad.AeroDecoderModule, tmp_path / "a.soft",
                       tmp_path / "jax", cfg),
           "torch": _run(tad.AeroDecoderModule, tmp_path / "a.soft",
                         tmp_path / "torch", dict(cfg, torch_device="cpu"))}
    frm = {k: Path(m.d_output_file).read_bytes() for k, m in dec.items()}
    assert frm["torch"] == frm["jax"]
    assert dec["torch"].stats == dec["jax"].stats
    n_out = dec["torch"].stats["frames"]
    assert n_out >= 2
    size = 336 if cfg is C_CFG else len(payloads[0])
    got = np.frombuffer(frm["torch"], np.uint8).reshape(n_out, size)
    if cfg is C_CFG:
        sent = {taero.unpack_c84(p)[1].tobytes() for p in payloads}
        assert all(g[:36].tobytes() in sent for g in got)
    else:
        assert all(g.tobytes() in {p.tobytes() for p in payloads}
                   for g in got)
    par = {k: _run(cls, dec[k].d_output_file, tmp_path / k / "msg" / "x",
                   {"start_timestamp": START, "is_c": cfg is C_CFG})
           for k, cls in (("jax", jap.AeroParserModule),
                          ("torch", tap.AeroParserModule))}
    assert par["torch"].stats == par["jax"].stats
    tree = _json_tree(tmp_path / "torch" / "msg")
    assert tree == _json_tree(tmp_path / "jax" / "msg")
    if cfg is not C_CFG:
        acars = [json.loads(v)["message"] for k, v in tree.items()
                 if k.startswith("ACARS")]
        assert len(acars) == n_out
        assert set(acars) <= {f"HELLO AERO {i}" for i in range(3)}


def test_aero_decoder_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default")
    with pytest.raises(SatdumpError):
        tad.AeroDecoderModule("x.soft", "out", dict(P_CFG))
