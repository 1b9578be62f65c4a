"""The port's Gardner clock recovery (ops/clock_recovery.py::
gardner_clock_recovery on the Gardner walker, ops/cuda/gardner.py) against
the JAX package's lax.scan, on the CPU, where the wrapper runs its plain
version (the kernel's float32 operations in the kernel's order).

Tolerance: none. Symbols, valid masks and the carried state are equal bit
for bit: the plain version sums the taps in XLA's CPU order and rounds the
three products that XLA's fusion contracts into their adds once, as XLA
does (ops/cuda/gardner.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import clock_recovery as jcr
from satdump_tpu.ops import firdes
from satdump_tpu_torch.ops import clock_recovery as tcr
from satdump_tpu_torch.ops.cuda import gardner
from satdump_tpu_torch.utils.state import (gardner_state_from_numpy,
                                           gardner_state_to_numpy)
from tests.test_torch_scaffold import _CudaLike


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shaped_bpsk(rng, n=8192, sps=2.37, phase=0.0):
    """tests/test_stages.py's stream: BPSK through an RRC at 100 samples a
    symbol, then every int(100 / sps)-th sample (sps 100/42 = 2.381)."""
    bits = rng.integers(0, 2, 4000, dtype=np.uint8)
    sym = (1.0 - 2.0 * bits).astype(np.float32)
    interp = 100
    up = np.zeros(len(sym) * interp, np.complex64)
    up[::interp] = sym
    taps = firdes.root_raised_cosine(1.0, interp, 1.0, 0.5, 801)
    shaped = np.convolve(up, taps * interp, "same")
    step = int(interp / sps)
    x = shaped[::step][:n] * np.exp(1j * phase)
    return x.astype(np.complex64), interp / step


def _kw(sps, limit=0.01, g_mu=8.7e-3):
    return dict(omega_mid=sps, gain_omega=g_mu ** 2 / 4, gain_mu=g_mu,
                omega_relative_limit=limit)


def _assert_same(js, jy, jv, ts, ty, tv):
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    for f in js._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)


def _run_both(x, bounds, sps, **kw):
    """Both packages over the blocks x[bounds[i]:bounds[i + 1]], the state
    carried; returns the port's symbols."""
    js = jcr.gardner_init(omega=sps)
    ts = tcr.gardner_init(omega=sps, device="cpu")
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        xb = x[a:b]
        js, jy, jv = jcr.gardner_clock_recovery(js, jnp.asarray(xb), **kw)
        ts, ty, tv = tcr.gardner_clock_recovery(ts, torch.from_numpy(xb),
                                                **kw)
        _assert_same(js, jy, jv, ts, ty, tv)
        out.append(ty[tv])
    return torch.cat(out).numpy()


@pytest.mark.parametrize("phase", [0.0, 0.7], ids=["bpsk", "rotated"])
def test_gardner_matches_jax_two_blocks(rng, phase):
    """tests/test_stages.py's shaped BPSK (8,192 samples), in two blocks;
    rotated, both windows' imaginary sums and the detector's Im term
    count."""
    x, sps = _shaped_bpsk(rng, phase=phase)
    syms = _run_both(x, [0, 4096, 8192], sps, **_kw(sps))
    assert len(syms) > 0.95 * len(x) / sps
    # the JAX test's eye-open check, on the port's output
    tail = np.real(syms[len(syms) // 2:] * np.exp(-1j * phase))
    assert (np.abs(np.abs(tail) - 1.0) < 0.35).mean() > 0.9


def test_gardner_matches_jax_high_gains_noise():
    """Large loop gains on noise: the loop's clips and every branch of the
    bank are reached, and the omega limit binds."""
    rng = np.random.default_rng(31)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
         ).astype(np.complex64)
    sps = 18 / 7                                       # MetOp's
    _run_both(x, [0, 1000, 1001, 3000], sps,
              omega_mid=sps, gain_omega=0.05, gain_mu=0.3,
              omega_relative_limit=0.05)


def test_gardner_blocks_shorter_than_the_zero_crossing_reach():
    """At sps 7.99 the zero-crossing window starts floor(omega / 2) = 3
    samples before the on-time one: blocks of 1, 2 and 3 samples clip
    both windows' starts to the block, and inc carries over several
    blocks."""
    rng = np.random.default_rng(32)
    sps = 7.99
    k = np.arange(600)
    sym = rng.integers(0, 2, 80) * 2 - 1
    x = (sym[(k / sps).astype(np.int64)]
         + 0.05 * rng.standard_normal(600)).astype(np.complex64)
    bounds = [0, 1, 3, 6, 9, 10, 200, 202, 600]
    _run_both(x, bounds, sps, **_kw(sps, limit=0.005))


def test_gardner_state_round_trip_from_jax(rng):
    """The port resumes from the JAX package's mid-stream state
    (utils/state.py) and gives JAX's next block."""
    x, sps = _shaped_bpsk(rng)
    kw = _kw(sps)
    js = jcr.gardner_init(omega=sps)
    js, _, _ = jcr.gardner_clock_recovery(js, jnp.asarray(x[:5000]), **kw)
    ts = gardner_state_from_numpy({f: np.asarray(getattr(js, f))
                                   for f in js._fields}, device="cpu")
    back = gardner_state_to_numpy(ts)
    for f in js._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(js, f)))
    js, jy, jv = jcr.gardner_clock_recovery(js, jnp.asarray(x[5000:]), **kw)
    ts, ty, tv = tcr.gardner_clock_recovery(ts, torch.from_numpy(x[5000:]),
                                            **kw)
    _assert_same(js, jy, jv, ts, ty, tv)


def test_gardner_out_cap_and_default():
    """An out_cap below the symbols available stops the walk there (the
    state is the one after the last slot), as in JAX; the default is
    ceil(n / (omega_mid (1 - limit))) + 2."""
    rng = np.random.default_rng(33)
    x = (rng.standard_normal(700) + 1j * rng.standard_normal(700)
         ).astype(np.complex64)
    sps = 100 / 42
    for cap in (1, 17, 150):
        js, jy, jv = jcr.gardner_clock_recovery(
            jcr.gardner_init(omega=sps), jnp.asarray(x), out_cap=cap,
            **_kw(sps))
        ts, ty, tv = tcr.gardner_clock_recovery(
            tcr.gardner_init(omega=sps, device="cpu"), torch.from_numpy(x),
            out_cap=cap, **_kw(sps))
        _assert_same(js, jy, jv, ts, ty, tv)
        assert bool(tv.all())
    _, ty, _ = tcr.gardner_clock_recovery(
        tcr.gardner_init(omega=sps, device="cpu"), torch.from_numpy(x),
        **_kw(sps))
    assert len(ty) == int(np.ceil(700 / (sps * (1 - 0.01)))) + 2


def test_gardner_walk_raises_on_cuda_without_fallback(monkeypatch):
    """No card here: the wrapper given a CUDA tensor tries its kernel and
    raises; it never runs the plain version instead."""
    class FellBack(Exception):
        pass

    def no_fallback(*a, **k):
        raise FellBack("wrapper fell back to the plain version")

    monkeypatch.setattr(gardner, "gardner_walk_plain", no_fallback)
    with pytest.raises(Exception) as e:
        gardner.gardner_walk(
            _CudaLike((4096 + 7,), torch.complex64), 4096,
            _CudaLike((gardner.STATE_SLOTS,), torch.float32),
            _CudaLike((128, 8), torch.float32), omega_mid=2.381,
            gain_omega=1e-5, gain_mu=8.7e-3, omega_limit=0.02, out_cap=1800)
    assert not isinstance(e.value, FellBack), e.value
    assert gardner.gardner_walk.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        gardner.gardner_walk(
            torch.zeros(15, dtype=torch.complex64, device="meta"), 8,
            torch.zeros(gardner.STATE_SLOTS), torch.zeros(128, 8),
            omega_mid=2.0, gain_omega=1e-5, gain_mu=8.7e-3,
            omega_limit=0.01, out_cap=8)
