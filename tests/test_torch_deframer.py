"""The port's ASM search (`ops/fec/deframer.py`) on the CPU.

`correlate_bits` against the convolution formula it replaced (kept here as
the oracle), for patterns of up to 64 bits (one packed word) and longer
(summed over 64-bit pieces). `CCSDSDeframer`
against the JAX package's (host NumPy, the reference): the frames and the
whole `DeframerState` after every call, on clean, inverted and noisy
streams, ASM bit errors below and at each threshold (lock loss and
re-acquisition), fed whole and in uneven chunks that split ASMs and frames.
"""

import dataclasses

import numpy as np
import pytest

from satdump_tpu.ops.fec import deframer as jdf
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops.fec import deframer as tdf


def _conv_distance(bits, pattern):
    """The integer-convolution formula: sum(p) + window sum - 2 corr."""
    n, m = len(bits), len(pattern)
    if n < m:
        return np.zeros(0, np.int32)
    b = bits.astype(np.int32)
    p = pattern.astype(np.int32)
    win_sum = np.convolve(b, np.ones(m, np.int32), "valid")
    corr = np.convolve(b, p[::-1], "valid")
    return (p.sum() + win_sum - 2 * corr).astype(np.int32)


@pytest.mark.parametrize("extra", [-1, 0, 5, 1003])
@pytest.mark.parametrize("m", [8, 32, 60, 64, 65, 128, 141])
def test_correlate_bits_equals_convolution(m, extra):
    """Streams shorter than, as long as and longer than the pattern (of
    lengths that are no multiple of 8), with the pattern and its inverse
    planted at the first, a middle and the last offset."""
    rng = np.random.default_rng(1000 * m + extra)
    pattern = tdf.asm_bits() if m == 32 else \
        rng.integers(0, 2, m).astype(np.uint8)
    n = m + extra
    bits = rng.integers(0, 2, n).astype(np.uint8)
    if n >= m:
        bits[:m] = pattern
    if n >= 2 * m:
        bits[n - m:] = 1 - pattern
    if n >= 3 * m:
        bits[n // 2: n // 2 + m] = pattern
    got = tdf.correlate_bits(bits, pattern)
    want = _conv_distance(bits, pattern)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (max(n - m + 1, 0),)
    if n >= 2 * m:
        assert got[0] == 0 and got[-1] == m


CADUS = 30
CADU_BITS = 1024 * 8

# {frame: bits flipped in its ASM}, and the frames that come out. Syncing
# takes 11 good ASMs (d < 2) to SYNCED; 3 bad ones (d >= 2) in a row while
# syncing, or one with d >= 6 once synced, drop the lock, that frame is
# lost, and the next exact ASM (either polarity) takes the lock again
ERRORS = {
    "clean": ({}, CADUS),
    "inverted": ({}, CADUS),
    "noise_lead": ({}, CADUS),
    "syncing_below": ({1: 1, 2: 1, 4: 1}, CADUS),
    "syncing_at": ({1: 2, 2: 2, 3: 2, 5: 2}, CADUS - 1),
    "synced_below": ({14: 5, 15: 5, 20: 3}, CADUS),
    "synced_at": ({14: 6, 16: 2, 17: 2, 18: 2}, CADUS - 2),
    "inverted_at": ({2: 2, 14: 6, 22: 32}, CADUS - 1),
}


def _stream(kind, rng):
    cadus = sim.make_cadus(CADUS, rng)
    bits = np.unpackbits(cadus, axis=1)
    for frame, nflip in ERRORS[kind][0].items():
        flip = rng.choice(tdf.ASM_SIZE, nflip, replace=False)
        bits[frame, flip] ^= 1
    bits = bits.reshape(-1)
    if kind.startswith("inverted"):
        bits = 1 - bits
    lead = 5003 if kind == "noise_lead" else 0
    noise = rng.integers(0, 2, lead + 777).astype(np.uint8)
    return cadus, np.concatenate([noise[:lead], bits, noise[lead:]])


def _chunks(stream, feed, rng):
    if feed == "whole":
        return [stream]
    cuts, pos = [], 0
    while pos < len(stream):
        size = int(rng.choice([1, 17, 31, 33, 4093, CADU_BITS + 9,
                               2 * CADU_BITS - 5, 25000]))
        cuts.append(stream[pos: pos + size])
        pos += size
    return cuts


def _assert_state_equal(t, j):
    for f in dataclasses.fields(jdf.DeframerState):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("feed", ["whole", "chunks"])
@pytest.mark.parametrize("kind", list(ERRORS))
def test_ccsds_deframer_equals_jax(kind, feed):
    rng = np.random.default_rng(sum(map(ord, kind + feed)))
    cadus, stream = _stream(kind, rng)
    t, j = tdf.CCSDSDeframer(CADU_BITS), jdf.CCSDSDeframer(CADU_BITS)
    frames = []
    for chunk in _chunks(stream, feed, rng):
        tf, jf = t.work(chunk), j.work(chunk)
        assert len(tf) == len(jf)
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(a, b)
        _assert_state_equal(t.st, j.st)
        frames += tf
    errors, nframes = ERRORS[kind]
    if feed == "whole":
        assert len(frames) == nframes
    else:
        # out of lock, a block keeps no tail: an ASM that a block's end
        # splits is not found, and its frame is lost, in both packages
        assert 0 < len(frames) <= nframes
    if not errors:
        np.testing.assert_array_equal(np.stack(frames), cadus)
