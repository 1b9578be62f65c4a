"""The port's rational resampler (ops/resamp.py) and psk_demod's rate and
block decisions against the JAX package's, on the CPU.

Tolerances, and why:
* make_rational, design_resampler_taps, every rate and block size: none.
* rational_resampler over three consecutive blocks: valid masks, the
  carried position numerator and history equal; samples within 1e-6, and
  more than 99.9 % of them bit-identical. The port sums the 8 taps in tap
  order with the imaginary products fused into their adds, which is how
  XLA's CPU fusion sums them; the margin is for the rare case where the
  port's float64 stand-in for the fused add rounds twice.
* The port forms positions in int64 where the reference wraps its int32
  ones: started 3,125 units below 2^31, the reference's later positions
  wrap negative and count as valid, the port's do not.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satdump_tpu.ops import firdes as jfirdes
from satdump_tpu.ops import resamp as jresamp
from satdump_tpu.pipeline.modules.demod.psk import PSKDemodModule as JPSK
from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.ops import firdes, resamp
from satdump_tpu_torch.pipeline.modules.demod.psk import PSKDemodModule as TPSK
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file as tparse
from satdump_tpu_torch.utils.state import (rational_resampler_state_from_numpy,
                                           stage_state_to_numpy)

ROOT = Path(__file__).resolve().parents[1]
PIPELINES = ROOT / "resources" / "pipelines"
RATES = [(1e6, 280e3), (1e6, 72e3 * 35 / 9), (6e6, 3.6e6), (50e3, 16640.0),
         (1e6, 50e3), (2.4e6, 1.0e6), (1e6, 333333.3), (6e6, 2333333.0)]


@pytest.mark.parametrize("srate_in,srate_out", RATES)
def test_make_rational_and_taps_match_jax(srate_in, srate_out):
    pair = resamp.make_rational(srate_in, srate_out)
    assert pair == jresamp.make_rational(srate_in, srate_out)
    if pair[0] <= 1000:
        np.testing.assert_array_equal(resamp.design_resampler_taps(*pair),
                                      jresamp.design_resampler_taps(*pair))


def _bank(interp, decim):
    proto = jresamp.design_resampler_taps(interp, decim)
    bank = firdes.polyphase_bank(proto, interp)
    np.testing.assert_array_equal(bank, jfirdes.polyphase_bank(proto, interp))
    return bank


@pytest.mark.parametrize("interp,decim", [(7, 25), (21, 125), (3, 5)],
                         ids=["meteor_m2_7/25", "meteor_m2x_21/125",
                              "goes_hrit_3/5"])
def test_three_blocks_match_jax(rng, interp, decim):
    """Three consecutive blocks of block*interp/decim outputs, as psk_demod
    runs them; each block's outputs and carried state equal the JAX
    package's."""
    bank = _bank(interp, decim)
    n = decim * 96
    out = n * interp // decim
    step = jax.jit(jresamp.rational_resampler, static_argnums=(3, 4, 5))
    js = jresamp.rational_resampler_init(interp, bank.shape[1])
    ts = resamp.rational_resampler_init(interp, device="cpu")
    for _ in range(3):
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        js, jy, jv = step(js, jnp.asarray(x), bank, interp, decim, out)
        ts, ty, tv = resamp.rational_resampler(ts, torch.from_numpy(x), bank,
                                               interp, decim, out_cap=out)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                                   rtol=0)
        assert (ty.numpy() == np.asarray(jy)).mean() > 0.999
        assert int(ts.pos_num) == int(js.pos_num)
        np.testing.assert_array_equal(ts.history.numpy(),
                                      np.asarray(js.history))


def test_block_from_jax_state_matches(rng):
    """Block 1 in JAX, its state carried through numpy into the port, block
    2 in both: equal outputs and state (a nonzero start numerator)."""
    interp, decim = 208, 625
    bank = _bank(interp, decim)
    n = 625 * 8
    step = jax.jit(jresamp.rational_resampler, static_argnums=(3, 4, 5))
    x1, x2 = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)
               ).astype(np.complex64) for _ in range(2))
    js = jresamp.rational_resampler_init(interp, bank.shape[1])
    js = js._replace(pos_num=jnp.int32(interp * 3 + 101))
    js, _, _ = step(js, jnp.asarray(x1), bank, interp, decim, None)
    ts = rational_resampler_state_from_numpy(np.asarray(js.history),
                                             np.asarray(js.pos_num),
                                             device="cpu")
    js, jy, jv = step(js, jnp.asarray(x2), bank, interp, decim, None)
    ts, ty, tv = resamp.rational_resampler(ts, torch.from_numpy(x2), bank,
                                           interp, decim)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    got = stage_state_to_numpy(ts)
    assert int(got["pos_num"]) == int(js.pos_num)
    np.testing.assert_array_equal(got["history"], np.asarray(js.history))


def test_positions_past_int32_do_not_wrap(rng):
    """NOAA APT's 208/625 with the position numerator 3,125 units below
    2^31 (as a 206 s whole-recording call reaches it): the reference's
    int32 positions wrap negative after 5 outputs and count as valid
    samples; the port's int64 ones stay beyond the block, so no output is
    valid and the numerator advances by exactly -n*L."""
    interp, decim = 208, 625
    bank = _bank(interp, decim)
    n = 64
    start = 2 ** 31 - 5 * decim
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    js = jresamp.rational_resampler_init(interp, bank.shape[1])
    js = js._replace(pos_num=jnp.int32(start))
    _, _, jv = jax.jit(jresamp.rational_resampler, static_argnums=(3, 4, 5))(
        js, jnp.asarray(x), bank, interp, decim, 32)
    assert np.asarray(jv)[5:].all() and not np.asarray(jv)[:5].any()
    ts = rational_resampler_state_from_numpy(np.zeros(7, np.complex64), start,
                                             device="cpu")
    ts, ty, tv = resamp.rational_resampler(ts, torch.from_numpy(x), bank,
                                           interp, decim, out_cap=32)
    assert not tv.any() and not ty.abs().any()
    assert int(ts.pos_num) == start - n * interp


def _psk_steps():
    """Every psk_demod step in resources/pipelines/ that states a
    samplerate and needs the input resampler (or is refused for too low a
    rate): (file, pipeline id, parameters)."""
    out = []
    for f in sorted(PIPELINES.glob("*.json")):
        for pid, pipe in tparse(f).items():
            for st in pipe.steps:
                if st.module_id != "psk_demod":
                    continue
                params = pipe.prepare_parameters(st, {})
                if "samplerate" not in params:
                    continue
                sps = float(params["samplerate"]) / float(
                    params.get("symbolrate", 0) or 1)
                hi = 2.4 if params.get("constellation") == "oqpsk" else 4.0
                lo = 1.6 if params.get("constellation") == "oqpsk" else 1.1
                if not lo <= sps <= hi:
                    out.append(pytest.param(f.name, pid, params,
                                            id=f"{f.stem}:{pid}"))
    return out


RESAMPLED = _psk_steps()


def test_resampled_pipelines_listed():
    """16 of the 31 psk_demod pipelines that state a samplerate need the
    input resampler (two of them are refused for too low a rate)."""
    assert len(RESAMPLED) == 16


@pytest.mark.parametrize("fname,pipe_id,params", RESAMPLED)
def test_rates_and_block_match_jax(fname, pipe_id, params):
    """compute_rates and choose_block_size at the pipeline's own rates:
    resample flag, final samplerate, sps and block equal the JAX
    package's (or both refuse the rate)."""
    jp = jparse(PIPELINES / fname)[pipe_id]
    jparams = jp.prepare_parameters(
        next(s for s in jp.steps if s.module_id == "psk_demod"), {})
    tm = TPSK("x.cf32", "out", dict(params, torch_device="cpu"))
    jm = JPSK("x.cf32", "out", jparams)
    try:
        jm.compute_rates()
    except Exception as e:  # the reference refuses; so must the port
        with pytest.raises(PipelineError, match=str(e)):
            tm.compute_rates()
        return
    tm.compute_rates()
    assert tm.resample and jm.resample
    assert tm.final_samplerate == jm.final_samplerate
    assert tm.final_sps == jm.final_sps
    assert tm.choose_block_size(tm.block_base) == \
        jm.choose_block_size(jm.block_base)
    assert (tm.r_interp, tm.r_decim) == (jm.r_interp, jm.r_decim)
