"""The port's feedforward PSK demod block against the JAX package's, on the
CPU, over two consecutive blocks.

The first block starts both packages from their initial state; the second
starts the port from the JAX state carried across (utils/state.py), so
each block is compared on its own. Covered: sps 18/7 (MetOp; symbols come
from K2's plain version), sps 2.0 and FY-3D's 3 (the strip resampler,
K4's plain version), OQPSK and 8PSK.

Tolerances, and why: the reductions (AGC mean, O&M matvecs, FFT of x^4,
cumsums) sum in another order in torch than in XLA, so the estimates agree
to ~1e-6 and a symbol on an interpolator-branch boundary may take the
neighbouring branch (1/128 sample; a change of up to ~0.03 on a unit
symbol). Hence: equal valid masks; every valid symbol within 0.05 and the
median within 1e-3; state scalars within the bounds in STATE_TOL.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import ffsync as jff
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops import ffsync as tff
from satdump_tpu_torch.ops import firdes
from satdump_tpu_torch.utils.state import (ff_clock_state_from_numpy,
                                           ff_clock_state_to_numpy)

N = 1 << 15
STATE_TOL = {
    "next_pos": 1e-2,       # samples
    "history": 1e-4,
    "last_phase": 1e-4,     # rad
    "last_f": 1e-7,         # cycles/sample
    "nco_phase": 1e-4,      # rad (compared modulo 2π)
    "rrc_history": 1e-4,
    "oq_imag": 1e-4,
    "sym_phase": 1e-4,
}


def _signal(rng, up, down, oqpsk, order=4):
    sps = up / down
    nsym = int(2 * N / sps) + 64
    if order == 8:
        syms = np.exp(2j * np.pi * rng.integers(0, 8, nsym) / 8
                      ).astype(np.complex64)
    else:
        syms = sim.bits_to_qpsk_symbols(rng.integers(0, 2, 2 * nsym
                                                     ).astype(np.uint8))
    tx = sim.oqpsk_modulate(syms, 2.0) if oqpsk \
        else sim.qpsk_modulate_rational(syms, up, down)
    chan = sim.ChannelModel(snr_db=15.0, freq_offset=2e-4, phase=0.3, seed=4)
    return chan.apply(tx)[: 2 * N]


@pytest.mark.parametrize("up,down,oqpsk", [(18, 7, False), (2, 1, False),
                                           (2, 1, True), (3, 1, False)],
                         ids=["sps_18/7", "sps_2_strip", "oqpsk_sps_2",
                              "sps_3_strip"])
def test_two_blocks_match_jax(rng, up, down, oqpsk):
    _two_blocks_match_jax(rng, up, down, oqpsk, 4, STATE_TOL)


def test_8psk_two_blocks_match_jax(rng):
    """8PSK (smos_dump's `constellation: 8psk`): the x^8 carrier estimate
    and the order-8 V&V phase, at MetOp's sps 18/7. The eighth power
    magnifies the reductions' rounding eightfold before the angle is
    divided back, so the phases carried (and the carrier-corrected
    history) are held within 1e-3 where QPSK's are within 1e-4; symbols
    as above."""
    _two_blocks_match_jax(rng, 18, 7, False, 8, dict(
        STATE_TOL, history=1e-3, last_phase=1e-3, nco_phase=1e-3,
        sym_phase=1e-3))


def _two_blocks_match_jax(rng, up, down, oqpsk, order, state_tol):
    sps = up / down
    bb = _signal(rng, up, down, oqpsk, order)
    rrc = firdes.root_raised_cosine(1.0, sps, 1.0, 0.5, 31)
    bank = firdes.mm_interpolator_bank()
    cap = int(np.ceil(N / (sps * 0.99))) + 2
    kw = dict(order=order, sps=sps, rrc_taps=rrc, bank=bank, out_cap=cap,
              oqpsk=oqpsk)
    jstep = jax.jit(partial(jff.ff_psk_demod_block, **kw))
    jst = jff.ff_clock_init(rrc_ntaps=len(rrc))
    tst = tff.ff_clock_init(rrc_ntaps=len(rrc), device="cpu")
    for blk in range(2):
        x = bb[blk * N: (blk + 1) * N]
        if blk:
            tst = ff_clock_state_from_numpy(
                {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
        jst, js, jv, jsnr = jstep(jst, jnp.asarray(x))
        tst, ts, tv, tsnr = tff.ff_psk_demod_block(tst, torch.from_numpy(x),
                                                   **kw)
        js, jv = np.asarray(js), np.asarray(jv)
        ts, tv = ts.numpy(), tv.numpy()
        assert ts.shape == js.shape == (cap,) and ts.dtype == np.complex64
        np.testing.assert_array_equal(tv, jv)
        assert jv.sum() > 0.9 * N / sps
        err = np.abs(ts - js)[jv]
        assert err.max() < 0.05, err.max()
        assert np.median(err) < 1e-3, np.median(err)
        np.testing.assert_array_equal(ts[~tv], 0)
        assert abs(float(tsnr) - float(jsnr)) < 0.01
        jd = {k: np.asarray(v) for k, v in jst._asdict().items()}
        td = ff_clock_state_to_numpy(tst)
        for k, tol in state_tol.items():
            d = np.abs(td[k] - jd[k])
            if k == "nco_phase":
                d = np.minimum(d, 2 * np.pi - d)
            assert td[k].shape == jd[k].shape, k
            assert np.max(d, initial=0.0) <= tol, (blk, k, d)


def test_state_round_trip():
    st = tff.ff_clock_init(rrc_ntaps=31, device="cpu")
    st = st._replace(next_pos=torch.tensor(-1.25), history=torch.arange(
        7, dtype=torch.float32).to(torch.complex64) * (1 - 2j))
    back = ff_clock_state_from_numpy(ff_clock_state_to_numpy(st), "cpu")
    for a, b in zip(st, back):
        assert torch.equal(a, b)


def test_cfo_and_timing_estimates_match_jax(rng):
    """The two estimators alone, on a clean MetOp-rate signal."""
    bb = _signal(rng, 18, 7, False)[:N]
    f_j = float(jff.cfo_estimate(jnp.asarray(bb), 4))
    f_t = float(tff.cfo_estimate(torch.from_numpy(bb), 4))
    assert abs(f_j - f_t) < 1e-7
    tj, sj = jff.om_timing_fit(jnp.asarray(bb), 18 / 7, 2048)
    tt, st = tff.om_timing_fit(torch.from_numpy(bb), 18 / 7, 2048)
    assert abs(float(tj) - float(tt)) < 1e-3
    assert abs(float(sj) - float(st)) < 1e-7


def _cfo_by_index(x: torch.Tensor, order: int,
                  suppress_nyquist_image: bool = False) -> torch.Tensor:
    """cfo_estimate as it read the peak's neighbours before the gather:
    each indexed by a 0-dim tensor, which reads the index on the host."""
    n = x.shape[-1]
    u = x / x.abs().clamp_min(1e-12)
    xm = tff._ipow(u, order)
    if suppress_nyquist_image:
        xm = 0.5 * (xm + torch.roll(xm, -1))
    p = torch.fft.fft(xm).abs()
    k = torch.argmax(p)
    pm1, p0, pp1 = p[(k - 1) % n], p[k], p[(k + 1) % n]
    denom = pm1 - 2.0 * p0 + pp1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (pm1 - pp1) / denom,
                        torch.zeros_like(denom))
    delta = delta.clamp(-0.5, 0.5)
    f = (k.to(torch.float32) + delta) / n
    f = torch.remainder(f + 0.5, 1.0) - 0.5
    return f / order


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("order,nyq", [(4, False), (4, True), (2, False),
                                       (8, False)])
def test_cfo_gather_equals_the_peak_read_by_index(seed, order, nyq):
    """The peak's three neighbours by one gather give the same f, bit for
    bit, as indexing by the 0-dim peak index; seed 3 puts the peak at bin
    0, where the left neighbour wraps to the last bin."""
    r = np.random.default_rng([4040, seed, order])
    n = 1 << 12
    f0 = 0.0 if seed == 3 else r.uniform(-0.4, 0.4) / order
    x = np.exp(2j * np.pi * (f0 * np.arange(n) + r.integers(0, order, n)
                             / order)).astype(np.complex64)
    x += (0.3 * (r.standard_normal(n) + 1j * r.standard_normal(n))
          ).astype(np.complex64)
    xt = torch.from_numpy(x)
    got = tff.cfo_estimate(xt, order, suppress_nyquist_image=nyq)
    want = _cfo_by_index(xt, order, suppress_nyquist_image=nyq)
    assert got.dtype == want.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == want.numpy().tobytes()
    if seed == 3:
        p = torch.fft.fft(tff._ipow(xt / xt.abs(), order)).abs()
        assert int(torch.argmax(p)) == 0


class _HostReads(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ops that read a tensor's value on the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("up,down,oqpsk,order", [
    (18, 7, False, 4), (3, 1, False, 4), (2, 1, True, 4), (18, 7, False, 2)],
    ids=["metop_sps_18/7", "fy3d_sps_3", "oqpsk_sps_2", "bpsk_sps_18/7"])
def test_later_blocks_read_nothing_back_and_upload_nothing(
        rng, monkeypatch, up, down, oqpsk, order):
    """A block reads no 0-dim value on the host and, after the first block
    of a process has uploaded them, copies no constant to the device: so
    the chain can be captured as one CUDA graph (ops/cuda/graph.py)."""
    sps = up / down
    bb = _signal(rng, up, down, oqpsk)
    rrc = firdes.root_raised_cosine(1.0, sps, 1.0, 0.5, 31)
    cap = int(np.ceil(N / (sps * 0.99))) + 2
    uploads = []
    for name in ("_f32", "_c64"):
        monkeypatch.setattr(tff, name, (lambda f: lambda *a: (
            uploads.append(a[-1]), f(*a))[1])(getattr(tff, name)))
    tff._CONSTS.clear()
    st = tff.ff_clock_init(rrc_ntaps=len(rrc), device="cpu")
    reads, made = [], []
    for blk in range(3):
        x = torch.from_numpy(bb[blk * (N // 2): (blk + 1) * (N // 2)])
        uploads.clear()
        with _HostReads() as hr:
            st, s, v, snr = tff.ff_psk_demod_block(
                st, x, order=order, sps=sps, rrc_taps=rrc, out_cap=cap,
                oqpsk=oqpsk)
        reads.append(hr.n)
        made.append(sorted(uploads))
        assert v.sum() > 0.9 * (N // 2) / sps
    # the timing tones (five near 2 sps, where the estimator runs on the
    # doubled rate) and, for QPSK's diagonal points, the V&V rotation (the
    # OQPSK chain's two V&V stages share it)
    tones = ["psk_demod.tones"] * (5 if sps < 2.1 else 3)
    rot = ["psk_demod.rotation"] if order == 4 else []
    assert made == [sorted(tones + rot), [], []]
    assert reads == [0, 0, 0]
