"""The port's baseline-JPEG level (METEOR MSU-MR LRPT) against satdump_tpu's
on the CPU: the host entropy decoder and tables (copied), the batched
dequantize + IDCT (torch matmuls against the JAX einsum), and the port's
test-signal encoder against the JAX tests' encoder.

Tolerance of the IDCT: at most 1 LSB on at most 0.01 % of the pixels. The
two contractions run in the reference's order, but the 8-term sums inside
each product are ordered by the matmul library (torch's against XLA's), so
a pixel whose value lands within a float32 rounding of .5 can round the
other way.
"""

import numpy as np
import pytest
import torch

from satdump_tpu.image import jpeg as jj
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.image import jpeg as tj
from tests.test_meteor import encode_blocks, quantize_forward


def _coeffs(rng, n, qf):
    """Quantized zig-zag coefficients of n random-content 8x8 blocks."""
    y, x = np.indices((8, 8))
    base = 128 + 60 * np.sin(x[None] * rng.random((n, 1, 1)) * 2
                             + y[None] * rng.random((n, 1, 1)))
    px = np.clip(base + rng.normal(0, 25, (n, 8, 8)), 0, 255).astype(np.uint8)
    return quantize_forward(px, qf)


@pytest.mark.parametrize("qf", [25, 50, 80, 95])
def test_dequantize_idct_matches_jax(qf, rng):
    zz = _coeffs(rng, 3000, qf)
    q = np.tile(jj.quantization_table(qf), (len(zz), 1))
    ref = jj.dequantize_idct(zz, q)
    got = tj.dequantize_idct(zz, q, device="cpu")
    assert got.dtype == np.uint8 and got.shape == ref.shape == (3000, 8, 8)
    d = np.abs(got.astype(int) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())


def test_dequantize_idct_random_coefficients(rng):
    """Dense random dequantized coefficients, mixed quant tables."""
    zz = rng.integers(-60, 60, (5000, 64)).astype(np.int32)
    q = np.stack([tj.quantization_table(float(f))
                  for f in rng.integers(10, 100, 5000)])
    ref = jj.dequantize_idct(zz, q)
    got = tj.dequantize_idct(zz, q, device="cpu")
    d = np.abs(got.astype(int) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())


def test_dequantize_idct_empty_and_device():
    out = tj.dequantize_idct(np.zeros((0, 64), np.int32),
                             np.zeros((0, 64)), device="cpu")
    assert out.shape == (0, 8, 8) and out.dtype == np.uint8
    if not torch.cuda.is_available():
        with pytest.raises(SatdumpError, match="cuda"):
            tj.dequantize_idct(np.zeros((1, 64), np.int32), np.ones((1, 64)))


def test_tables_and_entropy_decoder_match_jax(rng):
    for qf in range(1, 101):
        assert np.array_equal(tj.quantization_table(qf),
                              jj.quantization_table(qf))
    assert np.array_equal(tj.ZIGZAG, jj.ZIGZAG)
    zz = _coeffs(rng, 14, 70)
    data = encode_blocks(zz)
    for blob, n in ((data, 14), (data[: len(data) // 2], 14), (data, 20)):
        (a, na), (b, nb) = tj.decode_mcus(blob, n), jj.decode_mcus(blob, n)
        assert na == nb and np.array_equal(a, b)
    assert tj.decode_mcus(data, 14)[1] == 14
    assert np.array_equal(tj.decode_mcus(data, 14)[0], zz)


@pytest.mark.parametrize("qf", [30, 77, 90])
def test_sim_encoder_matches_the_tests_encoder(qf, rng):
    px = rng.integers(0, 256, (14, 8, 8)).astype(np.uint8)
    zz = sim.jpeg_quantize_forward(px, qf)
    assert np.array_equal(zz, quantize_forward(px, qf))
    assert sim.jpeg_encode_blocks(zz) == encode_blocks(zz)
