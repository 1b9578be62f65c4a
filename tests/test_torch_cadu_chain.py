"""The port's device RS decoder and fused soft->CADU chain against the JAX
package's, on the CPU.

Tolerance: none. Every stage is integer arithmetic (or float sums of 0/1
values that are exact), the Viterbi is the bit-identical plain version of
K1, and `argmax` takes the first index on ties in both frameworks, so
every output of `CaduChain._step` — words, ASM distances, RS error counts,
the lock residue `r`, the polarity, the hit count, the carries and the
re-encode BER — must be equal, chunk by chunk, as must the emitted CADUs.
"""

import jax
import numpy as np
import pytest
import torch

from satdump_tpu.ops.fec.cadu_chain import CaduChain as JChain
from satdump_tpu.ops.fec.rs_device import RSDevice as JRS
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops.fec.cadu_chain import CaduChain as TChain
from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
from satdump_tpu_torch.ops.fec.rotation import rotate_soft
from satdump_tpu_torch.ops.fec.rs_device import RSDevice as TRS
from satdump_tpu_torch.utils.state import (cadu_chain_state_from_numpy,
                                           cadu_chain_state_to_numpy)

CHUNK_PAIRS = 1 << 15
STEP_OUTPUTS = ("words", "fdist", "rs_errs", "r", "inverted", "nhits",
                "new_carry", "new_ctx", "new_nrzm", "ber")


# ---------------------------------------------------------------- RSDevice
@pytest.fixture(scope="module")
def rs_pair():
    """(jitted JAX decode, port decoder) for RS(255,223) dual basis, the
    MetOp code; both tests below decode 12 codewords, so JAX compiles once."""
    return jax.jit(JRS(k=223).decode), TRS(k=223, device="cpu")


def test_rs_device_matches_jax(rng, rs_pair):
    """Codewords with 0 .. t errors (corrected) and beyond t (reported -1
    or, rarely, miscorrected: whatever JAX does, the port must do)."""
    jdecode, trs = rs_pair
    rs = ReedSolomon(k=223)
    t = 16
    nerr = [0, 1, 2, 8, 15, 16, 17, 19, 24, 32, 40, 100]
    cw = rs.to_dual(rs.encode(rng.integers(0, 256, (len(nerr), 223)
                                           ).astype(np.uint8)))
    rx = cw.copy()
    for row, ne in enumerate(nerr):
        pos = rng.choice(255, ne, replace=False)
        rx[row, pos] ^= rng.integers(1, 256, ne).astype(np.uint8)
    jout, jn = jdecode(rx.astype(np.int32))
    tout, tn = trs.decode(torch.from_numpy(rx))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    ok = nerr.index(t) + 1
    np.testing.assert_array_equal(tn.numpy()[:ok], nerr[:ok])
    np.testing.assert_array_equal(tout.numpy()[:ok], cw[:ok])
    assert (tn.numpy() == -1).any()


def test_rs_device_interleaved_matches_jax(rng, rs_pair):
    """decode_interleaved at depth 4 (a CADU payload): byte errors in every
    codeword, and one frame past correction."""
    jdecode, trs = rs_pair
    rs = ReedSolomon(k=223)
    data = rs.encode_interleaved(rng.integers(0, 256, (3, 223 * 4)
                                              ).astype(np.uint8),
                                 ccsds_dual=True, depth=4)
    rx = data.copy()
    for row, ne in enumerate((5, 12, 90)):
        pos = rng.choice(255 * 4, ne, replace=False)
        rx[row, pos] ^= rng.integers(1, 256, ne).astype(np.uint8)
    # JAX's decode_interleaved layout, with the jitted decode inside
    cws = rx.reshape(3, 255, 4).transpose(0, 2, 1).reshape(12, 255)
    jout, jn = jdecode(cws.astype(np.int32))
    jout = np.asarray(jout).reshape(3, 4, 255).transpose(0, 2, 1
                                                         ).reshape(3, -1)
    tout, tn = trs.decode_interleaved(torch.from_numpy(rx.astype(np.int32)),
                                      4)
    np.testing.assert_array_equal(tout.numpy(), jout)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).reshape(3, 4))
    np.testing.assert_array_equal(tout.numpy()[:2], data[:2])


# ---------------------------------------------------------------- CaduChain
KW = dict(cadu_bits=8192, chunk_pairs=CHUNK_PAIRS, rs_i=4)


@pytest.fixture(scope="module")
def chains():
    """One (JAX, port) chain pair for the tests without NRZ-M: JAX compiles
    `_step` once per instance."""
    return JChain(**KW), TChain(**KW, device="cpu")


def _run(chain, soft, phase, swap, chunk):
    """Drive `work` chunk by chunk, then `flush`; return the emitted CADUs,
    their RS error counts and every `_step` call's outputs as numpy."""
    calls = []
    step = chain._step

    def rec(*args):
        out = step(*args)
        calls.append({k: np.asarray(v) for k, v in zip(STEP_OUTPUTS, out)})
        return out

    chain._step = rec
    try:
        st = chain.init_state()
        res = [chain.work(st, soft[off: off + chunk], phase, swap)
               for off in range(0, len(soft), chunk)]
        res.append(chain.flush(st, phase, swap))
    finally:
        chain._step = step
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res]), calls)


def _both(pair, soft, phase=0, swap=False, chunk=2 * CHUNK_PAIRS):
    jcadus, jerrs, jcalls = _run(pair[0], soft, phase, swap, chunk)
    tcadus, terrs, tcalls = _run(pair[1], soft, phase, swap, chunk)
    assert len(tcalls) == len(jcalls) > 1
    for i, (jc, tc) in enumerate(zip(jcalls, tcalls)):
        for name in STEP_OUTPUTS:
            assert tc[name].shape == jc[name].shape, (i, name)
            np.testing.assert_array_equal(tc[name], jc[name],
                                          err_msg=f"call {i} {name}")
    np.testing.assert_array_equal(tcadus, jcadus)
    np.testing.assert_array_equal(terrs, jerrs)
    return tcadus, terrs, tcalls


def test_chain_steps_multi_chunk_seams(chains):
    """Chunks shorter than the chunk width, so frames straddle the seams
    and the carried bits, soft context and dedup positions all act."""
    rng = np.random.default_rng(12)
    cadus = sim.make_cadus(10, rng)
    soft = sim.symbols_to_soft_int8(sim.encode_cadu_stream(cadus))
    got, errs, calls = _both(chains, soft, chunk=2 * CHUNK_PAIRS - 4096)
    assert len(calls) == 4          # 3 chunks and the flush
    np.testing.assert_array_equal(got, cadus)
    assert (errs == 0).all()


@pytest.mark.parametrize("phase,swap", [(1, False), (2, False), (3, True)],
                         ids=["rot90", "rot180", "rot270_swap"])
def test_chain_steps_rotation_and_swap(chains, phase, swap):
    """The channel rotates (and swaps) the softs; the chain's rotation
    hypothesis that undoes it is the inverse turn, or the same turn when
    the rails are swapped (swap·R^p·swap = R^-p)."""
    rng = np.random.default_rng(13)
    cadus = sim.make_cadus(4, rng)
    soft = sim.symbols_to_soft_int8(sim.encode_cadu_stream(cadus))
    rx = rotate_soft(soft, phase, swap)
    hyp = phase if swap else (4 - phase) % 4
    got, _, _ = _both(chains, rx, hyp, swap)
    np.testing.assert_array_equal(got, cadus)


def test_chain_steps_inverted_polarity(chains):
    """Both rails negated, identity hypothesis: both polynomials have odd
    weight, so the decoded bits come out complemented and the deframer's
    inverted-ASM branch must lock and flip the frames back."""
    rng = np.random.default_rng(14)
    cadus = sim.make_cadus(4, rng)
    soft = sim.symbols_to_soft_int8(sim.encode_cadu_stream(cadus))
    inv = (-soft.astype(np.int16)).clip(-127, 127).astype(np.int8)
    got, _, calls = _both(chains, inv)
    assert calls[0]["inverted"] == 1
    np.testing.assert_array_equal(got, cadus)


def test_chain_steps_nrzm_noisy_rs_corrections():
    """NRZ-M, with noise strong enough for RS to correct bytes."""
    rng = np.random.default_rng(15)
    cadus = sim.make_cadus(8, rng)
    soft = sim.symbols_to_soft_int8(
        sim.encode_cadu_stream(cadus, nrzm=True)).astype(np.float32)
    noisy = np.clip(soft + rng.normal(0, 70, soft.shape), -127, 127
                    ).astype(np.int8)
    pair = JChain(**KW, nrzm=True), TChain(**KW, nrzm=True, device="cpu")
    got, errs, _ = _both(pair, noisy, chunk=3 * (1 << 14))
    np.testing.assert_array_equal(got, cadus)
    assert errs.sum() > 0


def test_chain_state_from_jax_midstream(chains):
    """Start the port's chain from the JAX chain's carried state after the
    first chunk: the rest of the stream gives the same CADUs."""
    jchain, tchain = chains
    rng = np.random.default_rng(16)
    cadus = sim.make_cadus(6, rng)
    soft = sim.symbols_to_soft_int8(sim.encode_cadu_stream(cadus))
    jst = jchain.init_state()
    half = 2 * CHUNK_PAIRS - 6000
    first, _, _ = jchain.work(jst, soft[:half], 0, False)
    tst = cadu_chain_state_from_numpy(
        np.asarray(jst["bit_carry"]), np.asarray(jst["soft_ctx"]),
        np.asarray(jst["nrzm_carry"]), jst["abs_base"], jst["last_emitted"],
        device="cpu")
    jrest = [jchain.work(jst, soft[half:], 0, False)[0],
             jchain.flush(jst)[0]]
    trest = [tchain.work(tst, soft[half:], 0, False)[0],
             tchain.flush(tst)[0]]
    for t, j in zip(trest, jrest):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(np.concatenate([first, *trest]), cadus)
    back = cadu_chain_state_to_numpy(tst)
    for name in ("bit_carry", "soft_ctx", "nrzm_carry"):
        np.testing.assert_array_equal(back[name], np.asarray(jst[name]))
    assert (back["abs_base"], back["last_emitted"]) == \
        (jst["abs_base"], jst["last_emitted"])
