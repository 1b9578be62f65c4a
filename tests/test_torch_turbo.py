"""The port's CCSDS turbo code, correlator and `ccsds_turbo_decoder` against
the JAX package's, on the CPU.

Inputs come from numpy seeds. Tolerances:
- the permutation, trellis, puncture and encoder tables: equal;
- the plain max-log BCJR (`turbo_bcjr`'s CPU path) against `_bcjr_maxlog`:
  equal where a branch metric sums at most three components (C <= 3: every
  operation is an add, a max or an exact scaling, in the same order); at
  C = 4 (the 1/6 upper code) XLA's dot sums the four signed LLRs in another
  order, so the APP is held within 1e-5 relative + 1e-4 absolute, and its
  signs equal wherever it is farther than that from 0;
- the iterative decode and the module: decoded bits and `.frm` bytes
  identical;
- the correlator: positions, phases and swaps equal, the normalized
  correlation within 1e-5 (torch.fft and jnp.fft differ in the last bits).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops.fec import turbo as jt
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops.cuda.turbo_bcjr import turbo_bcjr
from satdump_tpu_torch.ops.fec import turbo as tt
from satdump_tpu_torch.ops.fec import turbo_trellis as tr

RATES = ("1/2", "1/3", "1/4", "1/6")
# the Eb/N0 of tests/test_turbo.py's decode test, per rate
EBN0 = {"1/2": 2.0, "1/3": 1.5, "1/4": 1.0, "1/6": 0.5}


def _awgn_llr(rng, cw, ebn0_db, rate_actual):
    """tests/test_turbo.py's BPSK AWGN channel LLRs."""
    x = 2.0 * cw.astype(np.float32) - 1.0
    sigma = np.sqrt(1.0 / (2 * rate_actual * 10 ** (ebn0_db / 10)))
    y = x + sigma * rng.standard_normal(cw.shape)
    return (2 * y / sigma ** 2).astype(np.float32)


@pytest.mark.parametrize("base", tt.BASES)
def test_permutation_matches_jax(base):
    np.testing.assert_array_equal(tt.ccsds_permutation(base),
                                  jt.ccsds_permutation(base))


@pytest.mark.parametrize("rate", RATES)
def test_trellis_and_puncture_tables_match_jax(rate):
    t, j = tt.CCSDSTurbo(223, rate), jt.CCSDSTurbo(223, rate)
    for comps in (t._up, t._lo):
        for a, b in zip(tr._trellis(comps), jt._trellis(comps)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tr._bcjr_tables(comps), jt._bcjr_tables(comps)):
            np.testing.assert_array_equal(a, b)
    assert (t._up, t._lo, t.cu, t.cl) == (j._up, j._lo, j.cu, j.cl)
    assert (t.mux_length, t.encoded_length) == (j.mux_length,
                                                j.encoded_length)
    np.testing.assert_array_equal(t._punct_keep, j._punct_keep)


@pytest.mark.parametrize("rate", RATES)
def test_encode_bits_matches_jax(rate, rng):
    bits = rng.integers(0, 2, (2, 223 * 8)).astype(np.uint8)
    t, j = tt.CCSDSTurbo(223, rate), jt.CCSDSTurbo(223, rate)
    cw = t.encode_bits(bits)
    np.testing.assert_array_equal(cw, j.encode_bits(bits))
    np.testing.assert_array_equal(t.depuncture(cw * 2.0 - 1),
                                  j.depuncture(cw * 2.0 - 1))


def _bcjr_inputs(rng, rate, kind):
    """(Lu, Ll, La) for both constituent codes of `rate` at base 223, three
    frames: N(0, 3) LLRs with N(0, 4) a-priori ones, or the AWGN channel of
    a codeword at the rate's Eb/N0 with zero a-priori."""
    t = tt.CCSDSTurbo(223, rate)
    B, K = 3, t.info_length
    S = K + tr.MEMORY
    if kind == "random":
        full = rng.normal(0, 3, (B, t.mux_length)).astype(np.float32)
        La = rng.normal(0, 4, (B, K)).astype(np.float32)
    else:
        bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
        llr = _awgn_llr(rng, t.encode_bits(bits), EBN0[rate],
                        K / t.encoded_length)
        full = t.depuncture(llr)
        La = np.zeros((B, K), np.float32)
    mux = full.reshape(B, S, t.cu + t.cl)
    return (t, np.ascontiguousarray(mux[:, :, : t.cu]),
            np.ascontiguousarray(mux[:, :, t.cu:]), La)


@pytest.mark.parametrize("kind", ("random", "awgn"))
@pytest.mark.parametrize("rate", RATES)
def test_plain_bcjr_matches_jax(rate, kind):
    rng = np.random.default_rng([RATES.index(rate), kind == "awgn"])
    t, Lu, Ll, La = _bcjr_inputs(rng, rate, kind)
    for comps, L in ((t._up, Lu), (t._lo, Ll)):
        got = turbo_bcjr(torch.from_numpy(L), torch.from_numpy(La),
                         comps).numpy()
        ref = np.asarray(jt._bcjr_maxlog(jnp.asarray(L), jnp.asarray(La),
                                         comps, True))
        if len(comps) <= 3:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
            far = np.abs(ref) > 1e-4 + 1e-5 * np.abs(ref)
            np.testing.assert_array_equal(np.sign(got[far]),
                                          np.sign(ref[far]))


@pytest.mark.parametrize("rate", RATES)
def test_turbo_decode_matches_jax(rate):
    """tests/test_turbo.py's decode case: four frames at the rate's Eb/N0,
    eight iterations; the bits equal the JAX package's and the frames
    sent."""
    rng = np.random.default_rng(100 + RATES.index(rate))
    t, j = tt.CCSDSTurbo(223, rate), jt.CCSDSTurbo(223, rate)
    bits = np.unpackbits(rng.integers(0, 256, (4, 223), dtype=np.uint8),
                         axis=-1)
    llr = _awgn_llr(rng, t.encode_bits(bits), EBN0[rate],
                    t.info_length / t.encoded_length)
    got, app = t.decode(llr, iterations=8, device="cpu")
    ref, ref_app = j.decode(llr, iterations=8)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, bits)
    if rate != "1/6":
        np.testing.assert_array_equal(app, ref_app)


@pytest.mark.parametrize("modulation", ("bpsk", "qpsk", "oqpsk"))
def test_correlator_matches_jax(modulation, rng):
    from satdump_tpu.ops.fec.correlator import CorrelatorGeneric as J
    from satdump_tpu.ops.fec.correlator import build_replicas as jb
    from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric as T
    from satdump_tpu_torch.ops.fec.correlator import build_replicas as tb
    sync = rng.integers(0, 2, 64).astype(np.uint8)
    np.testing.assert_array_equal(tb(sync, modulation), jb(sync, modulation))
    tc, jc = T(modulation, sync, device="cpu"), J(modulation, sync)
    for r, rep in enumerate(tc.replicas):
        soft = rng.normal(0, 40, 6000)
        pos = int(rng.integers(0, 6000 - 64)) & ~1
        soft[pos: pos + 64] += 80 * rep
        soft = np.clip(soft, -127, 127).astype(np.int8)
        got, ref = tc.correlate(soft), jc.correlate(soft)
        assert got[:3] == ref[:3], (r, got, ref)
        assert got[0] == pos
        assert abs(got[3] - ref[3]) <= 1e-5 * max(1.0, abs(ref[3]))


def _turbo_module(name, src, out, params):
    """The `ccsds_turbo_decoder` of the port ("torch", on the CPU) or of the
    JAX package ("jax") on the soft file `src`."""
    if name == "torch":
        from satdump_tpu_torch.pipeline.module import module_registry as reg
        from satdump_tpu_torch.pipeline.module import register_all_modules
        params = dict(params, torch_device="cpu")
    else:
        from satdump_tpu.pipeline.module import module_registry as reg
        from satdump_tpu.pipeline.module import register_all_modules
    register_all_modules()
    return reg.get("ccsds_turbo_decoder")(str(src), str(out), params)


@pytest.mark.parametrize("rate", ("1/2",))
def test_turbo_module_matches_jax(tmp_path, rate):
    """The same soft stream (ASM-framed, randomized base-223 codewords with
    valid CRCs behind 777 random softs, noise of 12) through both packages'
    ccsds_turbo_decoder at four iterations. The port writes every frame
    sent, each with its CRC. The JAX module decodes the chunk from its best
    correlation on, so it drops the frames ahead of that one (one here);
    the frames it writes are byte for byte the port's last ones."""
    rng = np.random.default_rng(7 + RATES.index(rate))
    frames = sim.crc_frames(6, rng, 223)
    soft = sim.soft_stream(sim.turbo_stream_bits(frames, 223, rate), rng)
    src = tmp_path / "x.soft"
    soft.tofile(src)
    params = {"constellation": "bpsk", "turbo_base": 223, "turbo_rate": rate,
              "turbo_iters": 4}
    out = {}
    for name in ("torch", "jax"):
        m = _turbo_module(name, src, tmp_path / name, params)
        m.process()
        rows = np.frombuffer(Path(m.d_output_file).read_bytes(), np.uint8)
        out[name] = (rows.reshape(-1, 4 + 223), m.stats)
    got, ref = out["torch"][0], out["jax"][0]
    np.testing.assert_array_equal(got[:, 4:], frames)
    assert out["torch"][1] == {"frames": 6, "crc_ok": 6}
    assert 1 <= len(ref) < 6
    np.testing.assert_array_equal(got[len(got) - len(ref):], ref)
    assert out["jax"][1] == {"frames": len(ref), "crc_ok": len(ref)}


@pytest.mark.parametrize("rate", ("1/3", "1/4", "1/6"))
def test_turbo_module_long_markers(tmp_path, rate):
    """Rates 1/3, 1/4 and 1/6 (Hera's and Psyche's pipelines run 1/4 and
    1/6): the JAX module cannot be built (its `_asm_bits` overflows on a
    96-bit or longer marker); the port decodes every frame sent, each with
    its CRC."""
    rng = np.random.default_rng(17 + RATES.index(rate))
    frames = sim.crc_frames(3, rng, 223)
    soft = sim.soft_stream(sim.turbo_stream_bits(frames, 223, rate), rng)
    src = tmp_path / "x.soft"
    soft.tofile(src)
    params = {"constellation": "bpsk", "turbo_base": 223, "turbo_rate": rate,
              "turbo_iters": 4}
    with pytest.raises(OverflowError):
        _turbo_module("jax", src, tmp_path / "jax", params)
    m = _turbo_module("torch", src, tmp_path / "torch", params)
    m.process()
    rows = np.fromfile(m.d_output_file, np.uint8).reshape(-1, 4 + 223)
    np.testing.assert_array_equal(rows[:, 4:], frames)
    assert m.stats == {"frames": 3, "crc_ok": 3}


def test_turbo_module_block_holds_two_codewords(tmp_path):
    """A pipeline's buffer_size below two codewords (16384 softs, as the
    demods' CPU runs take it, against base 1115's 17,912-soft unit): the
    JAX module's loop would step by block - unit < 0 and never end; the
    port's block holds two codewords and decodes every frame."""
    rng = np.random.default_rng(31)
    frames = sim.crc_frames(3, rng, 1115)
    soft = sim.soft_stream(sim.turbo_stream_bits(frames, 1115, "1/2"), rng)
    src = tmp_path / "x.soft"
    soft.tofile(src)
    m = _turbo_module("torch", src, tmp_path / "torch", {
        "turbo_base": 1115, "turbo_rate": "1/2", "turbo_iters": 1,
        "buffer_size": 16384})
    assert m.block == 2 * m.unit
    m.process()
    rows = np.fromfile(m.d_output_file, np.uint8).reshape(-1, 4 + 1115)
    np.testing.assert_array_equal(rows[:, 4:], frames)


def test_turbo_bcjr_refuses_other_devices():
    x = torch.zeros((1, 12, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        turbo_bcjr(x, torch.zeros((1, 8), device="meta"), ("sys", "p1"))
    assert turbo_bcjr.launches == 0
