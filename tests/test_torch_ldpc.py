"""The port's LDPC codes, min-sum decoder and `ccsds_ldpc_decoder` against
the JAX package's, on the CPU.

Inputs come from numpy seeds. Tolerances: none.
- AR4JA (three rates at k = 1024 and 4096) and C2: the dense check layout,
  the edge lists, M and the frame sizes equal; the systematic encoders
  give the same codewords.
- The min-sum: bits and parity-ok mask equal to `_minsum_iters`, on frames
  that decode and frames that do not. (The port sums each variable's check
  messages in the order in which XLA's scatter adds them, so no sum is
  taken in another order.)
- The module: the port writes every frame (or every inner CADU) sent. The
  JAX module starts each run at the best correlation of its window and
  drops the frames ahead of it; the frames it writes are, byte for byte and
  in order, among the port's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops.fec import ldpc as jl
from satdump_tpu.ops.fec import ldpc_ccsds as jc
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops.fec import ldpc as tl
from satdump_tpu_torch.ops.fec import ldpc_ccsds as tc

ASM_AR4JA, ASM_C2 = 0x034776C7272895B0, 0x1ACFFC1D


def _same_code(a, b):
    for f in ("n", "m", "dc_max", "dv_max"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("chk_vars", "edge_var", "edge_slot", "edge_chk"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("block", (1024, 4096))
@pytest.mark.parametrize("rate", ("1/2", "2/3", "4/5"))
def test_ar4ja_matches_jax(rate, block):
    (code, M), (jcode, jM) = tc.make_ar4ja(rate, block), \
        jc.make_ar4ja(rate, block)
    assert M == jM
    _same_code(code, jcode)
    t, j = tc.CCSDSLDPC(rate, block), jc.CCSDSLDPC(rate, block)
    assert (t.frame_bits, t.data_bits, t.codeword_bits) == \
        (j.frame_bits, j.data_bits, j.codeword_bits)


def test_c2_matches_jax():
    _same_code(tc.make_c2(), jc.make_c2())
    t, j = tc.CCSDSLDPC("7/8"), jc.CCSDSLDPC("7/8")
    assert (t.frame_bits, t.data_bits, t.codeword_bits, t.M) == \
        (j.frame_bits, j.data_bits, j.codeword_bits, j.M)


@pytest.mark.parametrize("rate,block", (("7/8", 0), ("1/2", 1024)))
def test_encoders_match_jax(rate, block, rng):
    t, j = tc.CCSDSLDPC(rate, block), jc.CCSDSLDPC(rate, block)
    te, je = t.encoder(), j.encoder()
    np.testing.assert_array_equal(te.pivots, je.pivots)
    np.testing.assert_array_equal(te.P, je.P)
    data = rng.integers(0, 2, (3, t.data_bits)).astype(np.uint8)
    np.testing.assert_array_equal(t.encode_frames(te, data),
                                  j.encode_frames(je, data))


def _codes():
    """Name -> (port code, JAX code, the noise sigmas of the frames)."""
    return {"regular_96_3_6": lambda: (tl.make_regular_code(96, 3, 6, seed=1),
                                       jl.make_regular_code(96, 3, 6, seed=1),
                                       (0.5, 1.4)),
            "c2": lambda: (tc.make_c2(), jc.make_c2(), (0.3, 0.6)),
            "ar4ja_1/2_1024": lambda: (tc.make_ar4ja("1/2", 1024)[0],
                                       jc.make_ar4ja("1/2", 1024)[0],
                                       (0.5, 1.4))}


@pytest.mark.parametrize("name", sorted(_codes()))
def test_minsum_matches_jax(name):
    """Eight frames of a codeword of the code under BPSK noise from mild
    to past what ten iterations correct (the zero codeword for C2 and
    AR4JA, a systematic codeword for the regular code): bits and ok
    equal."""
    code, jcode, (lo, hi) = _codes()[name]()
    rng = np.random.default_rng(sorted(_codes()).index(name))
    B = 8
    if name.startswith("regular"):
        enc = tl.SystematicEncoder(code)
        je = jl.SystematicEncoder(jcode)
        msg = rng.integers(0, 2, (B, enc.k)).astype(np.uint8)
        cw = enc.encode(msg)
        np.testing.assert_array_equal(cw, je.encode(msg))
    else:
        cw = np.zeros((B, code.n), np.uint8)
    sigma = np.linspace(lo, hi, B)[:, None]
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    llr = (2 * y / sigma ** 2).astype(np.float32)
    if name.startswith("ar4ja"):
        llr[:, -code.n // 5:] = 0            # the punctured M columns
    dec = tl.MinSumDecoder(code, iters=10)
    bits, ok = dec.decode(llr, device="cpu")
    jbits, jok = jl._minsum_iters(
        jnp.asarray(llr), jnp.asarray(jcode.chk_vars),
        jnp.asarray(jcode.chk_vars >= 0), 10, 0.75)
    np.testing.assert_array_equal(bits, np.asarray(jbits))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    assert ok.any() and not ok.all(), ok
    assert bits.dtype == np.uint8 and ok.dtype == bool


def test_var_slot_table_is_check_major():
    code = tl.make_regular_code(96, 3, 6, seed=1)
    table = tl.var_slot_table(code.chk_vars, code.n)
    flat = code.chk_vars.reshape(-1)
    for v in range(code.n):
        slots = table[v][table[v] < flat.size]
        np.testing.assert_array_equal(slots, np.flatnonzero(flat == v))


def _ldpc_module(name, src, out, params):
    """`ccsds_ldpc_decoder` of the port ("torch", on the CPU) or the JAX
    package ("jax"), run on the soft file `src`."""
    if name == "torch":
        from satdump_tpu_torch.pipeline.module import module_registry as reg
        from satdump_tpu_torch.pipeline.module import register_all_modules
        params = dict(params, torch_device="cpu")
    else:
        from satdump_tpu.pipeline.module import module_registry as reg
        from satdump_tpu.pipeline.module import register_all_modules
    register_all_modules()
    m = reg.get("ccsds_ldpc_decoder")(str(src), str(out), params)
    m.process()
    return np.fromfile(m.d_output_file, np.uint8), m.stats


def _in_order(rows, within):
    """Whether every row of `rows` is a row of `within`, in the same
    order."""
    it = iter(r.tobytes() for r in within)
    return all(any(r.tobytes() == w for w in it) for r in rows)


# GOES-R raw sounder data (C2 7/8, internal stream of 8192-bit CADUs);
# AR4JA 1/2 k = 1024 (Orion's code) in BPSK and in OQPSK with the Q rail a
# symbol late and both rails negated (the correlator's swap path, 180)
MODULE_CASES = {
    "c2_internal_goes_raw_sounder": ("7/8", 0, "bpsk", {
        "ldpc_iterations": 10, "derandomize": True, "internal_stream": True,
        "internal_cadu_size": 8192}),
    "ar4ja_1/2_bpsk": ("1/2", 1024, "bpsk", {"ldpc_block_size": 1024,
                                              "ldpc_iterations": 10}),
    "ar4ja_1/2_oqpsk_q_late": ("1/2", 1024, "oqpsk", {
        "ldpc_block_size": 1024, "ldpc_iterations": 10}),
}


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_ldpc_module_matches_jax(tmp_path, case):
    rate, block, const, params = MODULE_CASES[case]
    rng = np.random.default_rng(sorted(MODULE_CASES).index(case) + 40)
    ld = tc.CCSDSLDPC(rate, block)
    asm_val, asm_size = (ASM_C2, 32) if rate == "7/8" else (ASM_AR4JA, 64)
    if params.get("internal_stream"):
        sent = sim.make_cadus(6, rng)
        frames = sim.ldpc_internal_frames(sent, ld, rng)
    else:
        frames = ld.encode_frames(ld.encoder(), rng.integers(
            0, 2, (9, ld.data_bits)).astype(np.uint8))
        sent = np.concatenate([np.tile(np.frombuffer(
            asm_val.to_bytes(asm_size // 8, "big"), np.uint8),
            (len(frames), 1)), np.packbits(frames, axis=-1)], axis=1)
    soft = sim.soft_stream(sim.ldpc_stream_bits(frames, asm_val, asm_size),
                           rng, mag=100, sigma=20.0, prefix=778)
    if const == "oqpsk":
        soft = sim.oqpsk_q_late(soft)
        from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric
        from satdump_tpu_torch.ops.fec.deframer import asm_bits
        corr = CorrelatorGeneric("oqpsk", asm_bits(asm_val, asm_size),
                                 device="cpu")
        assert corr.correlate(soft[:4 * (ld.frame_bits + asm_size)])[2]
    src = tmp_path / "x.soft"
    soft.tofile(src)
    params = dict(params, constellation=const, ldpc_rate=rate)
    got, stats = _ldpc_module("torch", src, tmp_path / "torch", params)
    ref, jstats = _ldpc_module("jax", src, tmp_path / "jax", params)
    row = sent.shape[1]
    got, ref = got.reshape(-1, row), ref.reshape(-1, row)
    np.testing.assert_array_equal(got, sent)
    # the JAX module drops at least one frame on each of these streams
    assert 1 <= len(ref) < len(got) and _in_order(ref, got)
    assert stats["frames"] == len(sent) and stats["ldpc_bad"] == 0
    assert stats["correlator_lock"] and jstats["correlator_lock"]
    assert jstats["frames"] == len(ref)


def test_minsum_tables_stay_on_their_device():
    dec = tl.MinSumDecoder(tl.make_regular_code(96, 3, 6, seed=1), iters=2)
    bits, ok = dec.decode_tensor(torch.zeros((2, 96)))
    assert bits.device.type == "cpu" and ok.shape == (2,)
    assert set(dec._dev) == {torch.device("cpu")}
