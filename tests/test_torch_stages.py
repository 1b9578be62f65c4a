"""The port's DSP stages (ops/stages.py) against the JAX package's, on the
CPU, each over two consecutive blocks (the state carried across the seam
in each package), and the blocked linear recurrence against a sequential
float64 model.

Tolerances, and why:
* freq_shift, doppler_correct: the phase n*delta (a float32 cumsum for the
  Doppler) is formed alike, but XLA's float32 sin/cos reduce a large
  argument otherwise than the port's float64 ones, and the Doppler cumsum
  sums in another order. A phase error of a few float32 ulps of the
  block's largest phase turns x by as many radians: samples within
  8 ulp(max phase) * max|x| (freq_shift) and 2e-3 (doppler, phases to ~400
  rad, whose float32 ulp is 3e-5), the carried phase equal (freq_shift) or
  within 1e-3 rad (doppler).
* dc_block: JAX's associative scan is itself 1e-4 from the float64 model
  at alpha 1e-4 over 2^15 samples; the port's blocked recurrence is
  within 1e-6 of it. Samples and the accumulator within 2e-4 of JAX's.
* agc_block: the sub-block means sum in another order: within 1e-6.
* quadrature_demod: XLA's float32 atan2 against the port's float64 one:
  within 2e-7 (gain 1/pi).
* bpsk_soft: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import stages as J
from satdump_tpu_torch.ops import stages as T
from satdump_tpu_torch.utils.state import (dc_block_state_from_numpy,
                                           freq_shift_state_from_numpy,
                                           stage_state_to_numpy)

N = 1 << 15


def _x(rng, n=N, dc=0.7 - 0.3j):
    """Complex noise plus a DC term; |x| stays below 5 at these sizes."""
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n) + dc
    return (x / max(1.0, np.abs(x).max() / 5)).astype(np.complex64)


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _two_blocks(rng, jfn, tfn, jstate, tstate, atol, state_atol, key, n=N):
    for _ in range(2):
        x = _x(rng, n)
        jstate, jy = jfn(jstate, jnp.asarray(x))
        tstate, ty = tfn(tstate, torch.from_numpy(x))
        _close(ty, jy, atol)
        _close(getattr(tstate, key), getattr(jstate, key), state_atol)


def _shift_tol(delta, n):
    """8 float32 ulps of the largest phase of a block, times max |x| (5)."""
    return 8 * float(np.spacing(np.float32(abs(delta) * n + 2 * np.pi))) * 5


@pytest.mark.parametrize("delta", [0.0123, -2 * np.pi * 2400 / 50e3])
def test_freq_shift_matches_jax(rng, delta):
    _two_blocks(rng, jax.jit(lambda s, x: J.freq_shift(s, x, delta)),
                lambda s, x: T.freq_shift(s, x, delta), J.freq_shift_init(),
                T.freq_shift_init("cpu"), _shift_tol(delta, 4096), 0.0,
                "phase", n=4096)


def test_dc_block_matches_jax(rng):
    _two_blocks(rng, jax.jit(J.dc_block), T.dc_block, J.dc_block_init(),
                T.dc_block_init(device="cpu"), 2e-4, 2e-4, "acc")


@pytest.mark.parametrize("rate", [1e-2, 1e-5])
def test_agc_block_matches_jax(rng, rate):
    """rate 1e-2 gives a sub-block weight of 1 (the pipelines' default);
    1e-5 smooths over sub-blocks. The block is not a whole number of
    sub-blocks, so the tail takes the last gain."""
    _two_blocks(rng, jax.jit(lambda s, x: J.agc_block(s, x, rate=rate)),
                lambda s, x: T.agc_block(s, x, rate=rate), J.agc_init(),
                T.agc_init(device="cpu"), 1e-6, 1e-6, "gain", n=N - 100)


def test_quadrature_demod_matches_jax(rng):
    _two_blocks(rng, jax.jit(lambda s, x: J.quadrature_demod(s, x, 1 / np.pi)),
                lambda s, x: T.quadrature_demod(s, x, 1 / np.pi),
                J.quadrature_demod_init(), T.quadrature_demod_init("cpu"),
                2e-7, 0.0, "last")


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["scalar", "per_sample"])
def test_doppler_correct_matches_jax(rng, per_sample):
    fs = 1e6
    dop = np.linspace(2e3, 5e3, N).astype(np.float32) if per_sample \
        else np.float32(1234.0)
    _two_blocks(rng, jax.jit(lambda s, x: J.doppler_correct(
                    s, x, jnp.asarray(dop), fs)),
                lambda s, x: T.doppler_correct(s, x, dop, fs),
                J.freq_shift_init(), T.freq_shift_init("cpu"), 2e-3, 1e-3,
                "phase")


def test_bpsk_soft_matches_jax(rng):
    x = _x(rng, 4096) * 1.7
    np.testing.assert_array_equal(T.bpsk_soft(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.bpsk_soft(jnp.asarray(x))))
    np.testing.assert_array_equal(
        T.to_soft_int8(torch.from_numpy(x.imag), 100.0).numpy(),
        np.asarray(J.to_soft_int8(jnp.asarray(x.imag), 100.0)))


def _seq(b, beta):
    acc, out = 0.0, np.empty(len(b), np.complex128)
    for i, v in enumerate(b):
        acc = beta * acc + v
        out[i] = acc
    return out


@pytest.mark.parametrize("n,beta", [(1, 0.9999), (256, 0.9999),
                                    (257, 0.999), (70_001, 0.9999),
                                    (5000, 0.0)])
def test_linear_recurrence_matches_sequential(rng, n, beta):
    """One chunk, a chunk and one, three levels of chunks (70,001 > 256^2)
    and beta 0 (the AGC's default weight of 1): within 1e-6 of a
    sequential float64 model, real and complex."""
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 1e-2
    ref = _seq(b, beta)
    got = T.linear_recurrence(torch.from_numpy(b.astype(np.complex64)), beta)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    got = T.linear_recurrence(torch.from_numpy(b.real.astype(np.float32)),
                              beta)
    np.testing.assert_allclose(got.numpy(), ref.real, atol=1e-6, rtol=0)


def test_dc_block_accuracy_against_sequential(rng):
    """alpha 1e-4 over 2^15 samples: the port's accumulator is within 1e-6
    of a sequential float64 model, the JAX package's associative scan
    within 2e-4 (about 1e-4 off), so the port is the closer of the two."""
    x = _x(rng)
    ref = _seq(1e-4 * x.astype(np.complex128), 1 - 1e-4)
    _, ty = T.dc_block(T.dc_block_init(device="cpu"), torch.from_numpy(x))
    _, jy = jax.jit(J.dc_block)(J.dc_block_init(), jnp.asarray(x))
    t_err = np.abs(x - ty.numpy() - ref).max()
    j_err = np.abs(x - np.asarray(jy) - ref).max()
    assert t_err < 1e-6 and j_err < 2e-4 and t_err < j_err, (t_err, j_err)


def test_dc_block_seam_is_exact(rng):
    """Two blocks with the accumulator carried equal one block of both."""
    x = _x(rng, 8192)
    s1, y1 = T.dc_block(T.dc_block_init(device="cpu"), torch.from_numpy(x[:4096]))
    s1, y2 = T.dc_block(s1, torch.from_numpy(x[4096:]))
    s2, y = T.dc_block(T.dc_block_init(device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y.numpy(),
                               atol=1e-6, rtol=0)
    _close(s1.acc, s2.acc.numpy(), 1e-6)


def test_stage_states_from_jax_block(rng):
    """freq_shift and dc_block: block 1 in JAX, its state carried through
    numpy into the port, block 2 in both, within the tolerances above."""
    delta = 0.0123
    x1, x2 = _x(rng, 4096), _x(rng, 4096)
    fs = jax.jit(lambda s, x: J.freq_shift(s, x, delta))
    js, _ = fs(J.freq_shift_init(), jnp.asarray(x1))
    ts = freq_shift_state_from_numpy(np.asarray(js.phase), device="cpu")
    js, jy = fs(js, jnp.asarray(x2))
    ts, ty = T.freq_shift(ts, torch.from_numpy(x2), delta)
    _close(ty, jy, _shift_tol(delta, 4096))
    assert stage_state_to_numpy(ts)["phase"] == np.asarray(js.phase)

    dc = jax.jit(J.dc_block)
    js, _ = dc(J.dc_block_init(), jnp.asarray(x1))
    ts = dc_block_state_from_numpy(np.asarray(js.acc), device="cpu")
    js, jy = dc(js, jnp.asarray(x2))
    ts, ty = T.dc_block(ts, torch.from_numpy(x2))
    _close(ty, jy, 2e-4)
    np.testing.assert_allclose(stage_state_to_numpy(ts)["acc"],
                               np.asarray(js.acc), atol=2e-4)
