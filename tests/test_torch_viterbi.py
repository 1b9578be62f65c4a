"""The port's Viterbi decoders against the JAX package's, on the CPU.

`viterbi_re` on a CPU tensor runs the plain register-exchange decoder (the
plain version of the CUDA kernel K1). Tolerance: none — bit-identical
output, for integer and non-integer softs alike (every float op has the
reference's order; the strict `cand_b < cand_a` tie rule is kept).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops.fec import convolutional as jcc
from satdump_tpu.ops.pallas.viterbi import viterbi_re_pallas
from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
from satdump_tpu_torch.ops.fec import convolutional as tcc


def _soft_from_bits(bits, rng, noise=12.0):
    enc = jcc.conv_encode_batch(bits)
    soft = np.where(enc > 0, 235.0, 20.0) + rng.normal(0, noise, enc.shape)
    return np.clip(soft, 0, 255).astype(np.float32).reshape(-1, 2)


def _both(soft):
    ref = np.asarray(jcc.viterbi_decode_tiled_re(
        jnp.asarray(soft), seg=1024, ovl=128, unroll=1))
    got = viterbi_re(torch.from_numpy(soft), seg=1024, ovl=128).numpy()
    return ref, got


@pytest.mark.parametrize("nbits,noise", [(4096, 0.0), (8192, 12.0),
                                         (8192, 40.0)])
def test_tiled_re_matches_jax(rng, nbits, noise):
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    soft = _soft_from_bits(bits, rng, noise)
    ref, got = _both(soft)
    assert got.dtype == np.uint8 and got.shape == (nbits,)
    np.testing.assert_array_equal(got, ref)
    if noise <= 12.0:
        assert (got != bits).mean() == 0.0


def test_tiled_re_five_lanes(rng):
    """L=5 lanes: no lane padding leaks into the stream."""
    nbits = 5 * 1024
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    soft = _soft_from_bits(bits, rng, 10.0)
    ref, got = _both(soft)
    np.testing.assert_array_equal(got, ref)
    assert (got != bits).mean() == 0.0


def test_tiled_re_erasure_tail(rng):
    """Erasure (128) tail — the CADU chain pads chunks this way."""
    nbits = 2048
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    soft = np.concatenate([_soft_from_bits(bits, rng, 0.0),
                           np.full((1024, 2), 128.0, np.float32)])
    ref, got = _both(soft)
    np.testing.assert_array_equal(got, ref)
    assert (got[:nbits] != bits).mean() == 0.0


def test_tiled_re_non_integer_and_integer_softs(rng):
    """Uniform random softs (pure noise: ties and near-ties everywhere),
    fractional and rounded to integers."""
    soft = rng.uniform(0, 255, (3072, 2)).astype(np.float32)
    for s in (soft, np.round(soft)):
        ref, got = _both(s)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seg,ovl", [(512, 64), (1024, 200)])
def test_tiled_re_other_seg_ovl_matches_jax(rng, seg, ovl):
    """Shapes the card's K1 chunking touches (ovl+63+seg not a multiple of
    the kernel's 32-step chunk, odd step counts): the plain decoder, the
    card's oracle, equals JAX's bit for bit."""
    bits = rng.integers(0, 2, 3 * seg).astype(np.uint8)
    soft = _soft_from_bits(bits, rng, 40.0)
    ref = np.asarray(jcc.viterbi_decode_tiled_re(
        jnp.asarray(soft), seg=seg, ovl=ovl, unroll=1))
    got = tcc.viterbi_decode_tiled_re(torch.from_numpy(soft), seg=seg,
                                      ovl=ovl).numpy()
    np.testing.assert_array_equal(got, ref)


def test_tiled_re_matches_pallas_interpret(rng):
    """Second oracle: the TPU kernel itself, in interpret mode."""
    bits = rng.integers(0, 2, 2048).astype(np.uint8)
    soft = _soft_from_bits(bits, rng, 30.0)
    pal = np.asarray(viterbi_re_pallas(jnp.asarray(soft), seg=1024, ovl=128,
                                       interpret=True))
    got = viterbi_re(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(got, pal)


def test_tiled_re_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tcc.viterbi_decode_tiled_re(torch.zeros((1000, 2)))
    with pytest.raises(ValueError):
        tcc.viterbi_decode_tiled_re(torch.zeros((1024, 2)), ovl=32)


def test_decode_block_lock_search_batch(rng):
    """viterbi_decode_block on a lock-search batch: one 2048-soft window
    under the 4 phase rotations x 2 pair shifts (integer u8 softs, as the
    search feeds), bits and final metrics equal to JAX."""
    from satdump_tpu.ops.fec.rotation import rotate_soft
    bits = rng.integers(0, 2, 1100).astype(np.uint8)
    enc = jcc.conv_encode_batch(bits)
    soft = np.clip(np.where(enc > 0, 90, -90) + rng.normal(0, 50, enc.shape),
                   -127, 127).astype(np.int8)[:2048]
    wins = []
    for ph in range(4):
        u8 = jcc.soft_int8_to_u8(rotate_soft(soft, ph, False))
        for shift in range(2):
            wins.append(u8[shift: shift + 2046])
    W = np.stack(wins).astype(np.float32).reshape(len(wins), -1, 2)
    rb, rp = jcc.viterbi_decode_block(jnp.asarray(W))
    tb, tp = tcc.viterbi_decode_block(torch.from_numpy(W))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


def test_tiled_traceback_matches_jax(rng):
    """The punctured rates' full-traceback tiled decoder."""
    bits = rng.integers(0, 2, 3072).astype(np.uint8)
    soft = _soft_from_bits(bits, rng, 40.0)
    ref = np.asarray(jcc.viterbi_decode_tiled(jnp.asarray(soft), seg=1024,
                                              ovl=128))
    got = tcc.viterbi_decode_tiled(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(got, ref)
