"""The port's earth-curvature correction (image/geometry.py) and its last
DSP stages (ops/stages.py: qpsk_soft_interleave, fft_pan) against the JAX
package's, on the CPU, with the inputs made by numpy from a seed.

Tolerances, and why:
* earth curvature: host NumPy in both packages, the same float64
  arithmetic: equal.
* qpsk_soft_interleave: a float32 product, a clip and a truncation in
  both: equal.
* fft_pan: pocketfft (XLA's CPU FFT) and torch's FFT sum in another order,
  so the magnitudes differ by a few float32 ulps; the spectrum in dB
  within 1e-5 relative over three blocks with the state carried, and the
  carried average too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.image import geometry as JG
from satdump_tpu.ops import stages as J
from satdump_tpu_torch.image import geometry as TG
from satdump_tpu_torch.ops import stages as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the other workers of a parallel run keep the
    cores busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------- earth curvature
@pytest.mark.parametrize("width,height,swath,res", [
    (2048, 820.0, 2900.0, 1.0),        # tests/test_geo_image.py's inputs
    (2048, 817.0, 2800.0, 1.1),        # AVHRR-like, output narrower
    (90, 830.0, 2300.0, 16.0),         # MHS-like, a few columns
])
def test_earth_curvature_table_equal(width, height, swath, res):
    want = JG.earth_curvature_table(width, height, swath, res)
    got = TG.earth_curvature_table(width, height, swath, res)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,dtype", [
    ((3, 10, 2048), np.uint8),         # tests/test_geo_image.py's inputs
    ((10, 2048), np.uint8),
    ((2, 7, 2048), np.uint16),
    ((4, 5, 333), np.uint16),
    ((3, 6, 512), np.float32),
])
def test_correct_earth_curvature_equal(shape, dtype):
    rng = np.random.default_rng(21)
    if np.issubdtype(dtype, np.integer):
        img = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
    else:
        img = rng.standard_normal(shape).astype(dtype)
    w_out, w_rev = JG.correct_earth_curvature(img, 820.0, 2900.0, 1.0)
    t_out, t_rev = TG.correct_earth_curvature(img, 820.0, 2900.0, 1.0)
    assert t_out.dtype == img.dtype and t_out.shape == w_out.shape
    assert t_out.shape == shape[:-1] + (2900,)
    np.testing.assert_array_equal(t_out, w_out)
    np.testing.assert_array_equal(t_rev, w_rev)
    assert t_rev.dtype == np.int64
    assert t_rev.min() >= 0 and t_rev.max() <= shape[-1] - 1


# --------------------------------------------------- qpsk_soft_interleave
def test_qpsk_soft_interleave_test_stages_values():
    """tests/test_stages.py's values."""
    sym = np.array([0.5 + 0.25j, -2.0 + 1.3j], dtype=np.complex64)
    got = T.qpsk_soft_interleave(torch.from_numpy(sym), 100.0)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), [50, 25, -127, 127])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.qpsk_soft_interleave(jnp.asarray(sym),
                                                       100.0)))


@pytest.mark.parametrize("scale", [100.0, 127.0, 37.5])
def test_qpsk_soft_interleave_random_block(scale):
    rng = np.random.default_rng(22)
    sym = (rng.standard_normal(4099) * 1.4
           + 1j * rng.standard_normal(4099) * 1.4).astype(np.complex64)
    want = np.asarray(J.qpsk_soft_interleave(jnp.asarray(sym), scale))
    got = T.qpsk_soft_interleave(torch.from_numpy(sym), scale).numpy()
    assert got.shape == (2 * len(sym),)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ fft_pan
@pytest.mark.parametrize("nbins,n", [(512, 5000), (64, 4096), (64, 100)])
def test_fft_pan_three_carried_blocks(nbins, n):
    rng = np.random.default_rng(23 + nbins)
    t = np.arange(3 * n)
    tone = np.exp(2j * np.pi * 0.11 * t)
    x = (tone + 0.3 * (rng.standard_normal(3 * n)
                       + 1j * rng.standard_normal(3 * n))).astype(np.complex64)
    js = J.fft_pan_init(nbins)
    ts = T.fft_pan_init(nbins, device="cpu")
    assert ts.avg.shape == (nbins,) and ts.avg.dtype == torch.float32
    for b in range(3):
        blk = x[b * n: (b + 1) * n]
        js, jdb = J.fft_pan(js, jnp.asarray(blk), 0.1)
        ts, tdb = T.fft_pan(ts, torch.from_numpy(blk), 0.1)
        assert tdb.shape == (nbins,) and tdb.dtype == torch.float32
        np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), rtol=1e-5)
        np.testing.assert_allclose(ts.avg.numpy(), np.asarray(js.avg),
                                   rtol=1e-5)
    # the tone's bin stands out of the noise
    db = tdb.numpy()
    assert db.argmax() == nbins // 2 + round(0.11 * nbins)


def test_fft_pan_block_shorter_than_nbins():
    """No segment: a mean over none, NaN in both packages."""
    x = np.ones(100, np.complex64)
    _, jdb = J.fft_pan(J.fft_pan_init(512), jnp.asarray(x))
    ts, tdb = T.fft_pan(T.fft_pan_init(512, device="cpu"), torch.from_numpy(x))
    assert np.isnan(np.asarray(jdb)).all() and np.isnan(tdb.numpy()).all()
    assert np.isnan(ts.avg.numpy()).all()
