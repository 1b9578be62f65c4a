"""The plain version of the CUDA kernel K2 (resample_arith_grid on a CPU
tensor) against the JAX package's ff_resample_at and its Pallas kernel in
interpret mode.

Tolerances:
* against ff_resample_at: the positions are formed by the same float32 ops
  in the same order, so every branch pick is the same and only the order
  of the 8-term sum differs — every valid symbol within 1e-5 (unit-variance
  input), the valid masks equal;
* against the Pallas kernel: the contract of tests/test_pallas_resample.py
  (> 90% of symbols within 1e-5, max error < 0.1), since that kernel may
  pick a neighbouring branch on rounding boundaries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import ffsync as jff
from satdump_tpu.ops.firdes import mm_interpolator_bank
from satdump_tpu.ops.pallas.resample import resample_arith_grid as jgrid
from satdump_tpu_torch.ops import ffsync as tff
from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid

CASES = {
    "zero_skew": (np.float32(0.37), np.float32(2.0004), 2.04),
    "skew_0.008": (np.float32(1.8), np.float32(2.0 * (1.0 + 0.008)), 2.04),
    "sps_18/7": (np.float32(0.61), np.float32(18 / 7), 18 / 7 * 1.02),
}


def _inputs(rng, n, omega):
    """Unit-variance complex samples with a zero 7-sample history, and a
    symbol count that stays inside them for every case's omega (one count
    for all cases, so JAX compiles each shape once)."""
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    ext = np.concatenate([np.zeros(7, np.complex64), x])
    cap = int(n / (18 / 7 * 1.001)) - 8
    return ext, cap


def _port(ext, start, omega, cap, n):
    bank = torch.as_tensor(mm_interpolator_bank())
    y = resample_arith_grid(torch.from_numpy(ext), torch.tensor(start),
                            torch.tensor(omega), bank, out_cap=cap)
    k = torch.arange(cap, dtype=torch.float32)
    valid = tff._valid_mask(torch.tensor(start) + k * torch.tensor(omega),
                            8, n)
    return y.numpy(), valid.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k2_matches_ff_resample_at(rng, case):
    start, omega, _ = CASES[case]
    n = 1 << 14
    ext, cap = _inputs(rng, n, omega)
    pos = (start + np.arange(cap, dtype=np.float32) * omega).astype(np.float32)
    ref, rvalid = jff.ff_resample_at(jnp.asarray(ext), jnp.asarray(pos),
                                     mm_interpolator_bank(), n)
    got, valid = _port(ext, start, omega, cap, n)
    np.testing.assert_array_equal(valid, np.asarray(rvalid))
    err = np.abs(got[valid] - np.asarray(ref)[valid])
    assert valid.sum() > 0.95 * cap, valid.sum()
    assert err.max() < 1e-5, err.max()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k2_matches_pallas_interpret(rng, case):
    start, omega, sps_max = CASES[case]
    n = 1 << 13
    ext, cap = _inputs(rng, n, omega)
    ref = np.asarray(jgrid(jnp.asarray(ext), jnp.float32(start),
                           jnp.float32(omega),
                           jnp.asarray(mm_interpolator_bank()), out_cap=cap,
                           sps_max=sps_max, interpret=True))
    got, valid = _port(ext, start, omega, cap, n)
    err = np.abs(got[valid] - ref[valid])
    assert (err < 1e-5).mean() > 0.9, (err < 1e-5).mean()
    assert err.max() < 0.1, err.max()


def test_ff_resample_at_masks_like_jax(rng):
    """The port's ff_resample_at (masked) equals JAX's, including the
    zeroed symbols outside the emission window."""
    n = 4096
    ext, _ = _inputs(rng, n, 2.0)
    pos = np.linspace(-6.0, n + 2.0, 3000).astype(np.float32)
    ref, rvalid = jff.ff_resample_at(jnp.asarray(ext), jnp.asarray(pos),
                                     mm_interpolator_bank(), n)
    got, valid = tff.ff_resample_at(torch.from_numpy(ext),
                                    torch.from_numpy(pos),
                                    mm_interpolator_bank(), n)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert (~valid.numpy()).sum() > 0
    np.testing.assert_array_equal(got.numpy()[~valid.numpy()], 0)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5
