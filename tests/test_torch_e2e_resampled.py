"""The resampled PSK pipelines at their own default rates, baseband -> .soft
-> .cadu through both packages on the CPU: METEOR-M2 LRPT (QPSK, 7/25) and
METEOR-M2-x LRPT (OQPSK with NRZ-M, 21/125) at 1 Msps, GOES-R HRIT (BPSK
with NRZ-M, 3/5) at 6 Msps, and a psk_demod run with freq_shift, dc_block
and a Doppler provider. Every path ends in ff_clock_recovery at an sps far
from an integer, so symbols come from K2's plain version and bits from K1's.

psk_demod runs with a small `buffer_size` (its block is that times the
resampler's decim, as the reference aligns it) and the decoder with 128 Ki
(chunks of 65,536 pairs; much smaller chunks are refused by both packages'
CADU chains).

Tolerances, and why:
* .cadu: none — byte-identical to the JAX package's and to the CADUs sent;
* .soft: the same length; the reductions, the FFTs and the stages' float32
  rounding differ between torch and XLA (test_torch_stages.py), so a symbol
  moves by up to ~0.03 and the int8 truncation turns that into up to a few
  LSB: every soft within 3 LSB, the mean |difference| below 0.25 LSB;
* METEOR-M2-x products, dataset.json and the 321_false_color composite:
  none, the JAX package's products module and processor run on the port's
  .cadu.
"""

from pathlib import Path

import numpy as np
import pytest

from satdump_tpu.pipeline.module import module_registry as jregistry
from satdump_tpu.pipeline.module import register_all_modules as jregister
from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
from satdump_tpu.pipeline.runner import run_pipeline as jrun
from satdump_tpu_torch import sim
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.pipeline.module import module_registry as tregistry
from satdump_tpu_torch.pipeline.module import register_all_modules as tregister
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file as tparse
from satdump_tpu_torch.pipeline.runner import run_pipeline as trun

ROOT = Path(__file__).resolve().parents[1]
PIPELINES = ROOT / "resources" / "pipelines"
DECODER_BUFFER = 131072


def _steps(parse, fname, pipe_id, start, stop):
    pipe = parse(PIPELINES / fname)[pipe_id]
    pipe.steps = pipe.steps[pipe.level_index(start): pipe.level_index(stop) + 1]
    return pipe


def _baseband_to_cadu(run, parse, fname, pipe_id, src, out, params):
    soft = run(_steps(parse, fname, pipe_id, "baseband", "soft"), str(src),
               str(out), user_params=params)
    return run(_steps(parse, fname, pipe_id, "soft", "cadu"), soft, str(out),
               user_params=dict(params, buffer_size=DECODER_BUFFER),
               start_level="soft")


def _assert_match(tout, jout, cadus):
    """.cadu byte-identical to JAX's and to the CADUs sent; .soft within 3
    LSB, mean below 0.25."""
    tc, jc = np.fromfile(tout, np.uint8), np.fromfile(jout, np.uint8)
    assert tc.tobytes() == jc.tobytes()
    np.testing.assert_array_equal(tc.reshape(-1, cadus.shape[1]), cadus)
    ts = np.fromfile(Path(tout).with_suffix(".soft"), np.int8)
    js = np.fromfile(Path(jout).with_suffix(".soft"), np.int8)
    assert ts.shape == js.shape and len(ts) > cadus.size * 8
    d = np.abs(ts.astype(np.int16) - js)
    assert d.max() <= 3, d.max()
    assert d.mean() < 0.25, d.mean()


def _run_both(tmp_path, fname, pipe_id, src, cadus, params):
    tout = _baseband_to_cadu(trun, tparse, fname, pipe_id, src,
                             tmp_path / "torch",
                             dict(params, torch_device="cpu"))
    jout = _baseband_to_cadu(jrun, jparse, fname, pipe_id, src,
                             tmp_path / "jax", params)
    _assert_match(tout, jout, cadus)
    return tout


@pytest.mark.parametrize("fname,pipe_id,constellation,nrzm,buffer_size", [
    ("Meteor-M.json", "meteor_m2_lrpt", "qpsk", False, 16384),
    ("GOES.json", "goes_hrit", "bpsk", True, 65536),
], ids=["meteor_m2_lrpt_1msps", "goes_hrit_6msps"])
def test_baseband_to_cadu_matches_jax(tmp_path, fname, pipe_id,
                                      constellation, nrzm, buffer_size):
    """At the pipeline's own samplerate (1 Msps and 6 Msps): sps 125/9 ->
    35/9 and 6.47 -> 3.88 through the input resampler."""
    rng = np.random.default_rng(12)
    cadus = sim.make_cadus(8, rng)
    sps = sim.METEOR_1M_SPS if pipe_id.startswith("meteor") \
        else sim.GOES_HRIT_SPS
    src = tmp_path / "bb.cf32"
    write_baseband(src, "cf32", sim.ccsds_psk_baseband(
        cadus, rng, sps, constellation, nrzm=nrzm))
    _run_both(tmp_path, fname, pipe_id, src, cadus,
              {"buffer_size": buffer_size})


def test_meteor_m2x_lrpt_1msps_to_products_matches_jax(tmp_path):
    """METEOR-M2-x LRPT (OQPSK, NRZ-M) at 1 Msps, sps 125/9 -> 7/3, on
    CADUs carrying two 8-line strips of MSU-MR channels 1-3: the .cadu as
    above, then the port's products level on its .cadu: the MSU-MR product,
    dataset.json and the 321_false_color composite equal the JAX
    package's."""
    from satdump_tpu.models.meteor import MeteorMSUMRLRPTModule
    from satdump_tpu.products.processor import process_path
    from test_torch_e2e import _assert_products_and_composites_match
    rng = np.random.default_rng(13)
    cadus, _ = sim.msumr_lrpt_cadus(rng, 2)
    src = tmp_path / "bb.cf32"
    write_baseband(src, "cf32", sim.ccsds_psk_baseband(
        cadus, rng, sim.METEOR_1M_SPS, "oqpsk", nrzm=True))
    tout = _run_both(tmp_path, "Meteor-M.json", "meteor_m2x_lrpt", src,
                     cadus, {"buffer_size": 4096})
    out = Path(tout).parent
    trun(_steps(tparse, "Meteor-M.json", "meteor_m2x_lrpt", "cadu",
                "products"), tout, str(out), user_params={
                    "torch_device": "cpu"}, start_level="cadu")
    ref = tmp_path / "ref"
    ref.mkdir()
    MeteorMSUMRLRPTModule(tout, str(ref / "meteor_m2x_lrpt"),
                          {"m2x_mode": True, "satellite": "METEOR-M2-4"}
                          ).process()
    written = process_path(str(ref / "dataset.json"))
    assert (out / "dataset.json").read_text() == \
        (ref / "dataset.json").read_text()
    _assert_products_and_composites_match(out, ref, written, {
        "MSU-MR": ("msu_mr", ["321_false_color"])})


def _doppler_signal(rng, cadus):
    """METEOR-M2 LRPT at 1 Msps with a DC term, a carrier offset of -3 kHz
    (undone by freq_shift 3000) and a Doppler ramp from 2 to 6 kHz (undone
    by the provider); returns (baseband, Doppler in Hz a sample)."""
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS,
                                freq_offset=-3e-3, dc=0.05 + 0.03j)
    dop = np.linspace(2e3, 6e3, len(bb))
    bb = bb * np.exp(2j * np.pi * np.cumsum(dop) / 1e6)
    return bb.astype(np.complex64), dop.astype(np.float32)


def test_freq_shift_dc_block_doppler_match_jax(tmp_path):
    """psk_demod with freq_shift, dc_block and a Doppler provider (set on
    the module, as a tracker sets it), then meteor_lrpt_decoder, each
    package's modules on the same input."""
    rng = np.random.default_rng(14)
    cadus = sim.make_cadus(8, rng)
    bb, dop = _doppler_signal(rng, cadus)
    src = tmp_path / "bb.cf32"
    write_baseband(src, "cf32", bb)

    def provider(pos, n):
        d = dop[pos: pos + n]
        return np.concatenate([d, np.full(n - len(d), dop[-1], np.float32)])

    pipe = tparse(PIPELINES / "Meteor-M.json")["meteor_m2_lrpt"]
    params = pipe.prepare_parameters(pipe.steps[1], {
        "freq_shift": 3000.0, "dc_block": True, "buffer_size": 16384})
    dec = dict(pipe.prepare_parameters(pipe.steps[2], {}),
               buffer_size=DECODER_BUFFER)
    outs = {}
    for name, registry, register, extra in (
            ("torch", tregistry, tregister, {"torch_device": "cpu"}),
            ("jax", jregistry, jregister, {})):
        register()
        demod = registry.get("psk_demod")(str(src), str(tmp_path / name),
                                          dict(params, **extra))
        demod.doppler_provider = provider
        demod.process()
        decoder = registry.get("meteor_lrpt_decoder")(
            demod.d_output_file, str(tmp_path / name), dict(dec, **extra))
        decoder.process()
        outs[name] = decoder.d_output_file
    _assert_match(outs["torch"], outs["jax"], cadus)
