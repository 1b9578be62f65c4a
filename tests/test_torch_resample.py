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
  pick a neighbouring branch on rounding boundaries;
* the Python mirror of the CUDA kernel's loads (`_k2_layout`) against the
  plain version and ff_resample_at: every symbol within 1e-5 of the plain
  version, every valid one within 1e-5 of ff_resample_at, masks equal (the
  same branch picks; only the sum order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import ffsync as jff
from satdump_tpu.ops.firdes import mm_interpolator_bank
from satdump_tpu.ops.pallas.resample import resample_arith_grid as jgrid
from satdump_tpu_torch.ops import ffsync as tff
from satdump_tpu_torch.ops.cuda import resample
from satdump_tpu_torch.ops.cuda.resample import (resample_arith_grid,
                                                 resample_arith_grid_plain)

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


def _k2_layout(ext, start, omega, bank, out_cap, a0=0):
    """Python mirror of what csrc/resample_arith.cu loads for each symbol.
    The 8 samples come from five 16-byte loads starting at the aligned pair
    at or before src (a0: the parity of ext's address in 8-byte units),
    shifted by one where src is odd in that layout; a symbol whose ten
    samples would leave ext reads its eight one by one. Every load is
    checked to lie inside ext, and every 16-byte one to be aligned.
    Returns (symbols, symbols read one by one)."""
    f32 = np.float32
    n_ext = ext.shape[0]
    p = (f32(start) + np.arange(out_cap, dtype=f32) * f32(omega)) \
        + f32(resample.NTAPS / 2)
    ip = np.floor(p)
    src = np.clip(ip.astype(np.int64), 0, n_ext - resample.NTAPS)
    branch = np.clip(np.rint((p - ip) * f32(resample.NFILT)), 0,
                     resample.NFILT - 1).astype(np.int64)
    e = src - ((src + a0) & 1)
    wide = (e >= 0) & (e + 10 <= n_ext)
    first = np.where(wide, e, src)                  # first sample loaded
    count = np.where(wide, 10, resample.NTAPS)      # samples loaded
    assert first.min() >= 0 and (first + count).max() <= n_ext
    assert not ((e[wide] + a0) % 2).any()            # 16-byte aligned loads
    idx = src[:, None] + np.arange(resample.NTAPS)  # after the select
    taps = ext[idx]
    return (taps * bank[branch]).sum(axis=1), int((~wide).sum())


METOP_SPS, METEOR_SPS = 18 / 7, 35 / 9
CTA = 256       # symbols a CTA of csrc/resample_arith.cu, one a thread
# (sps, skew, start, a0): omega = sps * (1 + skew); a start below -4 clips
# the first symbols' windows at ext's start, and the last symbols then lie
# past its end
LAYOUT = {
    "metop_skew0": (METOP_SPS, 0.0, 0.61, 0),
    "metop_skew+0.008": (METOP_SPS, 0.008, 1.8, 0),
    "metop_skew-0.008": (METOP_SPS, -0.008, 0.37, 0),
    "meteor_skew0": (METEOR_SPS, 0.0, 0.61, 0),
    "meteor_skew+0.008": (METEOR_SPS, 0.008, 2.9, 0),
    "meteor_skew-0.008": (METEOR_SPS, -0.008, 0.05, 0),
    "skew_0.03_above_the_tpu_window": (METOP_SPS, 0.03, 0.61, 0),
    "clipped_at_both_ends": (METOP_SPS, 0.0, -21.3, 0),
    "clipped_ext_at_odd_8_bytes": (METOP_SPS, 0.008, -21.3, 1),
}


@pytest.mark.parametrize("case", list(LAYOUT))
def test_k2_layout_mirror_matches_plain_and_jax(rng, case):
    sps, skew, start, a0 = LAYOUT[case]
    start, omega = np.float32(start), np.float32(sps * (1 + skew))
    n = 1 << 13
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    ext = np.concatenate([np.zeros(7, np.complex64), x])
    clipped = start < -resample.NTAPS / 2
    if clipped:
        cap = int((n + 40 - start) / omega)
    else:
        cap = int(n / (sps * 1.01)) - 8
    assert cap % CTA, "out_cap must not be a multiple of the CTA"
    bank = mm_interpolator_bank()
    got, narrow = _k2_layout(ext, start, omega, bank, cap, a0)
    if clipped:          # the loads one by one at both ends are exercised
        assert narrow > 0

    plain = resample_arith_grid_plain(
        torch.from_numpy(ext), torch.tensor(start), torch.tensor(omega),
        torch.as_tensor(bank), out_cap=cap).numpy()
    assert np.abs(got - plain).max() < 1e-5

    pos = (start + np.arange(cap, dtype=np.float32) * omega).astype(np.float32)
    ref, rvalid = jff.ff_resample_at(jnp.asarray(ext), jnp.asarray(pos),
                                     bank, n)
    valid = tff._valid_mask(torch.from_numpy(pos), 8, n).numpy()
    np.testing.assert_array_equal(valid, np.asarray(rvalid))
    if clipped:
        assert not valid[0] and not valid[-1]
    assert valid.sum() > 0.9 * cap
    assert np.abs(got[valid] - np.asarray(ref)[valid]).max() < 1e-5
