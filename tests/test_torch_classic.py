"""The classic demod chain of the port against the JAX package's, on the
CPU: the four per-sample recurrences (agc_scan, pll_carrier_scan,
costas_scan, mm_clock_recovery), fir_apply, and the `.soft` of pm_demod,
fsk_demod, sdpsk_demod and psk_demod `fast: false`.

On the CPU each recurrence runs its kernel's plain version (ops/cuda/
{sample_walk,mm_clock}.py), which does the kernel's float operations. Each
is run over two blocks with its state carried, from the same numpy inputs.

Tolerances, and why:
* M&M: none. Both packages do the same float32 operations in the same
  order (the 8-tap sums in order, the imaginary products fused into their
  adds, as XLA's CPU fusion does), so symbols, valid masks and state are
  bit-identical.
* AGC: 1e-6, over eight seeds. |out| is sqrt(re re + im im) in float32 in
  the port (abs_f32, unscaled, as the card does it) and XLA's scaled
  float32 hypot in the JAX package; they differ by an ulp now and then.
* PLL: outputs within 1e-4 (mean 1e-5), state within 1e-5, over eight
  seeds. Both packages form e^{-j phase} and arg() in float32, the port
  with its own sincos_f32 / atan2_f32 (within 2 ulp, built from correctly
  rounded operations so that the card equals the CPU), XLA with its own
  polynomials; they round an ulp apart now and then, and the loop carries
  those last-bit steps on.
* Costas: the same tolerances. The port forms e^{-j phase} in float64 and
  rounds once; XLA's float32 sin / cos round otherwise.
* .soft: the same length; every soft within 3 LSB, the mean below 0.05
  LSB: a last-bit difference moves a symbol by ~1e-5, which the int8
  truncation turns into 1 LSB now and then.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import clock_recovery as jcr
from satdump_tpu.ops import costas as jcs
from satdump_tpu.ops import fir as jfir
from satdump_tpu.ops import stages as jst
from satdump_tpu_torch import sim
from satdump_tpu_torch.ops import clock_recovery as tcr
from satdump_tpu_torch.ops import costas as tcs
from satdump_tpu_torch.ops import fir as tfir
from satdump_tpu_torch.ops import firdes
from satdump_tpu_torch.ops import stages as tst

N = 4096


def _psk(rng, order: int, n: int = 2 * N, sps: float = 4.5,
         offset: float = 2e-3) -> np.ndarray:
    """`order`-PSK symbols held for sps samples, a carrier offset (cycles a
    sample), a gain of 1.7 and AWGN: what the loops lock to."""
    k = np.arange(n)
    rot = np.pi / 4 if order == 4 else 0.0
    sym = np.exp(1j * (2 * np.pi * rng.integers(0, order, n) / order + rot))
    x = 1.7 * sym[(k / sps).astype(np.int64)] * np.exp(
        1j * (2 * np.pi * offset * k + 0.3))
    x = x + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _blocks(x):
    return [x[i * N:(i + 1) * N] for i in range(2)]


def _close(t, j, tol, mean_tol=None):
    d = np.abs(np.asarray(t) - np.asarray(j))
    assert d.max(initial=0.0) <= tol, d.max()
    if mean_tol is not None:
        assert d.mean() <= mean_tol, d.mean()


# the conftest's rng seed and seven more
SEEDS = [0xC0FFEE + k for k in range(8)]


@pytest.mark.parametrize("seed", SEEDS)
def test_agc_scan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = _psk(rng, 4) * np.linspace(0.2, 3.0, 2 * N).astype(np.float32)
    js, ts = jst.agc_init(), tst.agc_init(device="cpu")
    for xb in _blocks(x.astype(np.complex64)):
        js, jy = jst.agc_scan(js, jnp.asarray(xb), rate=1e-2)
        ts, ty = tst.agc_scan(ts, torch.from_numpy(xb), rate=1e-2)
        _close(ty.numpy(), jy, 1e-6)
        _close(ts.gain.numpy(), js.gain, 1e-6)


def test_agc_scan_ceiling_and_no_ceiling():
    """max_gain caps the gain; max_gain <= 0 leaves it uncapped."""
    x = torch.full((64,), 1e-6, dtype=torch.complex64)
    for mg, want in ((65536.0, 65536.0), (0.0, None)):
        st, _ = tst.agc_scan(tst.agc_init(device="cpu"), x, rate=1e4,
                             max_gain=mg)
        js, _ = jst.agc_scan(jst.agc_init(), jnp.asarray(x.numpy()),
                             rate=1e4, max_gain=mg)
        assert float(st.gain) == float(js.gain)
        if want is not None:
            assert float(st.gain) == want
        else:
            assert float(st.gain) > 65536.0


@pytest.mark.parametrize("seed", SEEDS)
def test_pll_carrier_scan_matches_jax(seed):
    x = _psk(np.random.default_rng(seed), 2, offset=3e-3)
    js, ts = jcs.pll_init(), tcs.pll_init("cpu")
    for xb in _blocks(x):
        js, jy = jcs.pll_carrier_scan(js, jnp.asarray(xb), 0.01,
                                      max_offset=0.5)
        ts, ty = tcs.pll_carrier_scan(ts, torch.from_numpy(xb), 0.01,
                                      max_offset=0.5)
        _close(ty.numpy(), jy, 1e-4, 1e-5)
        _close(ts.phase.numpy(), js.phase, 1e-5)
        _close(ts.freq.numpy(), js.freq, 1e-5)


@pytest.mark.parametrize("order,freq_limit", [(2, 1.0), (4, 1.0), (8, 1.0),
                                              (2, 2e-3)],
                         ids=["order2", "order4", "order8",
                              "order2_freq_limit"])
def test_costas_scan_matches_jax(rng, order, freq_limit):
    """Each order on its own constellation; freq_limit 2e-3 below the
    carrier offset (2.5e-3 cycles, 0.0157 rad a sample) holds the
    frequency at the limit."""
    x = _psk(rng, order, offset=2.5e-3)
    js, ts = jcs.costas_init(), tcs.costas_init("cpu")
    for xb in _blocks(x):
        js, jy = jcs.costas_scan(js, jnp.asarray(xb), 0.01, order,
                                 freq_limit=freq_limit)
        ts, ty = tcs.costas_scan(ts, torch.from_numpy(xb), 0.01, order,
                                 freq_limit=freq_limit)
        _close(ty.numpy(), jy, 1e-4, 1e-5)
        _close(ts.phase.numpy(), js.phase, 1e-5)
        _close(ts.freq.numpy(), js.freq, 1e-5)
    if freq_limit < 1.0:
        assert abs(float(ts.freq)) == np.float32(freq_limit)


@pytest.mark.parametrize("complex_mode,sps", [(True, 4.5), (False, 7.99)],
                         ids=["complex", "real"])
def test_mm_clock_recovery_matches_jax(rng, complex_mode, sps):
    """Two blocks, bit-identical: symbols, valid masks and the carried
    state (inc past the block end, history, registers)."""
    x = _psk(rng, 2 if not complex_mode else 4, sps=sps)
    if not complex_mode:
        x = x.real.astype(np.complex64)
    bank = firdes.mm_interpolator_bank()
    kw = dict(omega_mid=sps, gain_omega=8.7e-3 ** 2 / 4, gain_mu=8.7e-3,
              omega_relative_limit=0.005, complex_mode=complex_mode)
    js, ts = jcr.mm_init(omega=sps), tcr.mm_init(omega=sps, device="cpu")
    carried = []
    for xb in _blocks(x):
        js, jsy, jv = jcr.mm_clock_recovery(js, jnp.asarray(xb), bank=bank,
                                            **kw)
        ts, tsy, tv = tcr.mm_clock_recovery(ts, torch.from_numpy(xb),
                                            bank=torch.as_tensor(bank), **kw)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tsy.numpy(), np.asarray(jsy))
        assert tv.sum() > 0.95 * N / sps
        for f in js._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        carried.append(int(ts.inc))
    assert any(carried), carried


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_fir_apply_matches_jax(rng, dtype):
    taps = firdes.root_raised_cosine(1.0, 4.0, 1.0, 0.35, 31)
    x = (rng.standard_normal(2 * N) + 1j * rng.standard_normal(2 * N))
    x = (x if dtype == np.complex64 else x.real).astype(dtype)
    js = jfir.fir_init(len(taps), dtype=jnp.complex64 if dtype ==
                       np.complex64 else jnp.float32)
    ts = tfir.fir_init(len(taps), dtype=torch.complex64 if dtype ==
                       np.complex64 else torch.float32, device="cpu")
    for xb in _blocks(x):
        js, jy = jfir.fir_apply(js, jnp.asarray(xb), taps)
        ts, ty = tfir.fir_apply(ts, torch.from_numpy(xb), taps)
        assert ty.numpy().dtype == dtype
        _close(ty.numpy(), jy, 1e-5)
        _close(ts.history.numpy(), js.history, 0.0)


def test_delay_one_imag_and_snr_match_jax(rng):
    x = _psk(rng, 4)
    js, ts = jst.delay_one_imag_init(), tst.delay_one_imag_init("cpu")
    for xb in _blocks(x):
        js, jy = jst.delay_one_imag(js, jnp.asarray(xb))
        ts, ty = tst.delay_one_imag(ts, torch.from_numpy(xb))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert float(ts.last_imag) == float(js.last_imag)
        assert abs(float(tst.snr_m2m4(torch.from_numpy(xb)))
                   - float(jst.snr_m2m4(jnp.asarray(xb)))) < 1e-3


def test_dc_block_at_fsk_alpha_matches_jax(rng):
    """fsk_demod's DC block runs at alpha 1e-3 on the discriminator's
    output cast to complex: within 2e-4, as tests/test_torch_stages.py
    holds it at 1e-4."""
    x = (0.3 + rng.standard_normal(2 * N)).astype(np.complex64)
    js, ts = jst.dc_block_init(), tst.dc_block_init(device="cpu")
    for xb in _blocks(x):
        js, jy = jst.dc_block(js, jnp.asarray(xb), alpha=1e-3)
        ts, ty = tst.dc_block(ts, torch.from_numpy(xb), alpha=1e-3)
        _close(ty.numpy(), jy, 2e-4)


# -- the demodulators' .soft ----------------------------------------------

def _soft_matches_jax(jcls, tcls, params, x, blocks=2):
    """stream_work on `blocks` consecutive blocks in both packages: softs
    of one length, within 3 LSB, mean below 0.05."""
    mods = [tcls("x.cf32", "out", dict(params, torch_device="cpu")),
            jcls("x.cf32", "out", params)]
    softs = []
    for m in mods:
        m.stream_start()
        b = m.block_size
        softs.append(np.concatenate([
            m.stream_work(x[i * b:(i + 1) * b]) for i in range(blocks)]))
    t, j = softs
    assert t.shape == j.shape and len(t) > 1000
    d = np.abs(t.astype(np.int16) - j)
    assert d.max() <= 3 and d.mean() < 0.05, (d.max(), d.mean())
    return t


def test_pm_demod_soft_matches_jax(rng):
    """PM on a subcarrier at the symbol rate, sps 10 (as tests/
    test_pm_fsk.py builds it)."""
    from satdump_tpu.pipeline.modules.demod.pm import PMDemodModule as J
    from satdump_tpu_torch.pipeline.modules.demod.pm import PMDemodModule
    x = sim.pm_bpsk_baseband(rng.integers(0, 2, 3000), 10, rng,
                             freq_offset=1e-3)
    _soft_matches_jax(J, PMDemodModule, {
        "samplerate": 80e3, "symbolrate": 8e3, "pll_bw": 0.01,
        "rrc_alpha": 0.5, "costas_bw": 0.005, "buffer_size": 8192}, x)


@pytest.mark.parametrize("module,extra", [
    ("fsk_demod", {"basic_shaping": True}),
    ("fsk_demod", {"rrc_alpha": 0.35}),
    ("sdpsk_demod", {"rrc_alpha": 0.5}),
], ids=["fsk_boxcar", "fsk_rrc", "sdpsk"])
def test_fsk_family_soft_matches_jax(rng, module, extra):
    """2-FSK at 96 ksps and 9.6 ksym/s, resampled to 80 ksps (MAX_SPS 8);
    for SDPSK, +-pi/2 a symbol (a deviation of a quarter of the symbol
    rate)."""
    from satdump_tpu.pipeline.modules.demod import fsk as jfsk
    from satdump_tpu_torch.pipeline.modules.demod import fsk as tfsk
    cls = {"fsk_demod": "FSKDemodModule", "sdpsk_demod": "SDPSKDemodModule"}
    dev = 2400.0 if module == "sdpsk_demod" else 9600.0
    x = sim.fsk_baseband(rng.integers(0, 2, 2000), 96e3, 9600, rng, dev)
    _soft_matches_jax(getattr(jfsk, cls[module]), getattr(tfsk, cls[module]),
                      dict({"samplerate": 96e3, "symbolrate": 9600,
                            "buffer_size": 8192}, **extra), x)


@pytest.mark.parametrize("constellation,extra", [
    ("bpsk", {}),
    ("qpsk", {}),
    ("oqpsk", {"post_costas_dc": True}),
], ids=["bpsk", "qpsk", "oqpsk_post_costas_dc"])
def test_psk_demod_classic_soft_matches_jax(rng, constellation, extra):
    """psk_demod `fast: false` at sps 3 (OQPSK at 2), a carrier offset and
    (with post_costas_dc) a DC term after the loop."""
    from satdump_tpu.pipeline.modules.demod.psk import PSKDemodModule as J
    from satdump_tpu_torch.pipeline.modules.demod.psk import PSKDemodModule
    bits = rng.integers(0, 2, 2 * 12000).astype(np.uint8)
    if constellation == "oqpsk":
        tx = sim.oqpsk_modulate(sim.bits_to_qpsk_symbols(bits), 2.0)
        fs = 2e6
    else:
        syms = sim.bits_to_qpsk_symbols(bits) if constellation == "qpsk" \
            else (bits * 2.0 - 1).astype(np.complex64)
        tx = sim.qpsk_modulate_rational(syms, 3, 1)
        fs = 3e6
    x = sim.ChannelModel(snr_db=15, freq_offset=1e-3, phase=0.4, seed=3,
                         dc=0.02 if extra else 0.0).apply(tx)
    soft = _soft_matches_jax(J, PSKDemodModule, dict({
        "samplerate": fs, "symbolrate": 1e6, "constellation": constellation,
        "rrc_alpha": 0.5, "pll_bw": 0.005, "fast": False,
        "buffer_size": 8192}, **extra), x)
    assert np.mean(np.abs(soft) > 20) > 0.9     # locked: a clean eye
