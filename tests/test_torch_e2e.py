"""MetOp AHRPT and METEOR-M LRPT baseband -> .soft -> .cadu through both
packages' run_pipeline, on the CPU, with the pipeline files' psk_demod and
decoder parameters: MetOp at its real 18/7 samples per symbol (6 Msps,
2.333 Msym/s), METEOR-M2 LRPT at 35/9 (72 ksym/s recorded at 280 ksps; the
pipeline's default 1 Msps needs the input resampler, not yet ported).

At both rates the port picks symbols with K2's plain version and decodes
with K1's plain version. Tolerances, and why:
* .cadu: none — byte-identical to the JAX package's and to the sent CADUs;
* .soft: the same length; the FFTs and reductions sum in another order in
  torch than in XLA, so a symbol may move by up to ~0.03 (an interpolator
  branch flip, see test_torch_ffsync.py) and the x100 int8 truncation turns
  a tiny move across an integer into 1 LSB: every soft within 3 LSB, the
  mean |difference| below 0.25 LSB.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
from satdump_tpu.pipeline.runner import run_pipeline as jrun
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file as tparse
from satdump_tpu_torch.pipeline.runner import run_pipeline as trun

ROOT = Path(__file__).resolve().parents[1]
METOP = ROOT / "resources" / "pipelines" / "MetOp.json"
METEOR = ROOT / "resources" / "pipelines" / "Meteor-M.json"


@pytest.fixture(scope="module")
def metop_12(tmp_path_factory):
    """12 random CADUs and their MetOp AHRPT baseband (.cf32) at SNR 18 dB
    with a carrier offset and phase."""
    rng = np.random.default_rng(5)
    cadus = sim.make_cadus(12, rng)
    src = tmp_path_factory.mktemp("metop") / "metop.cf32"
    write_baseband(src, "cf32",
                   sim.ccsds_qpsk_baseband(cadus, rng, sim.METOP_SPS))
    return cadus, src


def _to_cadu(parse, path, pipe_id):
    pipe = parse(path)[pipe_id]
    pipe.steps = pipe.steps[: pipe.level_index("cadu") + 1]
    return pipe


def _assert_baseband_to_cadu_matches_jax(path, pipe_id, cadus, src, tmp_path,
                                         params=None):
    params = dict(params or {})
    tout = trun(_to_cadu(tparse, path, pipe_id), str(src),
                str(tmp_path / "torch"),
                user_params=dict(params, torch_device="cpu"))
    jout = jrun(_to_cadu(jparse, path, pipe_id), str(src),
                str(tmp_path / "jax"), user_params=params)

    tc, jc = np.fromfile(tout, np.uint8), np.fromfile(jout, np.uint8)
    assert tc.tobytes() == jc.tobytes()
    np.testing.assert_array_equal(tc.reshape(-1, 1024), cadus)

    ts = np.fromfile(Path(tout).with_suffix(".soft"), np.int8)
    js = np.fromfile(Path(jout).with_suffix(".soft"), np.int8)
    assert ts.shape == js.shape and len(ts) > len(cadus) * 8192 * 2
    d = np.abs(ts.astype(np.int16) - js)
    assert d.max() <= 3, d.max()
    assert d.mean() < 0.25, d.mean()


def test_metop_ahrpt_12_cadus_match_jax(metop_12, tmp_path):
    cadus, src = metop_12
    _assert_baseband_to_cadu_matches_jax(METOP, "metop_ahrpt", cadus, src,
                                         tmp_path)


def test_meteor_m2_lrpt_12_cadus_match_jax(tmp_path):
    """METEOR-M2 LRPT (QPSK, meteor_lrpt_decoder without NRZ-M) at 280
    ksps, sps 35/9: as far from an integer as MetOp's, so K2's path."""
    rng = np.random.default_rng(7)
    cadus = sim.make_cadus(12, rng)
    src = tmp_path / "meteor.cf32"
    write_baseband(src, "cf32",
                   sim.ccsds_qpsk_baseband(cadus, rng, sim.METEOR_SPS))
    _assert_baseband_to_cadu_matches_jax(
        METEOR, "meteor_m2_lrpt", cadus, src, tmp_path,
        {"samplerate": 72000 * sim.METEOR_SPS[0] / sim.METEOR_SPS[1]})


def test_meteor_m2x_lrpt_decoder_nrzm_matches_jax(tmp_path):
    """METEOR-M2-x's decoder step (meteor_lrpt_decoder with diff_decode,
    i.e. NRZ-M) from noisy softs: the .cadu byte-identical to the JAX
    package's and equal to the sent CADUs. (A 128 Ki `buffer_size` keeps
    the CPU's plain Viterbi to 65 lanes a chunk.)"""
    rng = np.random.default_rng(11)
    cadus = sim.make_cadus(8, rng)
    clean = sim.symbols_to_soft_int8(
        sim.encode_cadu_stream(cadus, nrzm=True)).astype(np.float32)
    soft = np.clip(clean + rng.normal(0, 40.0, clean.shape), -127, 127)
    src = tmp_path / "meteor.soft"
    soft.astype(np.int8).tofile(src)
    params = {"buffer_size": 131072}
    outs = [run(_to_cadu(parse, METEOR, "meteor_m2x_lrpt"), str(src),
                str(tmp_path / name), user_params=up, start_level="soft")
            for run, parse, name, up in (
                (trun, tparse, "torch", dict(params, torch_device="cpu")),
                (jrun, jparse, "jax", params))]
    tc, jc = (np.fromfile(o, np.uint8) for o in outs)
    assert tc.tobytes() == jc.tobytes()
    got = tc.reshape(-1, 1024)
    assert len(got) >= len(cadus) - 2
    sent = {c.tobytes() for c in cadus}
    assert all(g.tobytes() in sent for g in got)


@pytest.fixture(scope="module")
def metop_instruments_pass(tmp_path_factory):
    """MetOp-B CADUs carrying 2 AVHRR/3 and 2 MHS lines (33 CADUs) and
    their MetOp AHRPT baseband (.cf32), as `metop_12`."""
    rng = np.random.default_rng(6)
    cadus, truth = sim.metop_instrument_cadus(rng, 2, 2)
    src = tmp_path_factory.mktemp("metop_instr") / "metop.cf32"
    write_baseband(src, "cf32",
                   sim.ccsds_qpsk_baseband(cadus, rng, sim.METOP_SPS))
    return cadus, truth, src


def test_cli_pipeline_baseband_to_products(metop_instruments_pass, tmp_path):
    """`pipeline metop_ahrpt baseband` with `--torch_device cpu` writes the
    .soft, the .cadu, the product directories, dataset.json and the
    autogen composites in one call. The AVHRR channels are the lines sent;
    products, dataset.json and composites equal the JAX package's from the
    same .cadu. (A 128 Ki `buffer_size` keeps the CPU's plain Viterbi to 65
    lanes a chunk.)"""
    from satdump_tpu.models.metop import MetOpInstrumentsDecoderModule
    from satdump_tpu.products.processor import process_path
    from satdump_tpu_torch.products.product import load_product
    cadus, truth, src = metop_instruments_pass
    out = tmp_path / "cli"
    assert cli.main(["pipeline", "metop_ahrpt", "baseband", str(src),
                     str(out), "--torch_device", "cpu",
                     "--buffer_size", "131072"]) == 0
    got = np.fromfile(out / "metop_ahrpt.cadu", np.uint8).reshape(-1, 1024)
    np.testing.assert_array_equal(got, cadus)
    assert (out / "metop_ahrpt.soft").stat().st_size > len(cadus) * 8192 * 2
    avhrr = load_product(str(out / "AVHRR"))
    for slot, name in enumerate(("1", "2")):
        assert np.array_equal(avhrr.get_channel(name).image >> 6,
                              truth["avhrr"][:, :, slot])

    ref = tmp_path / "jax"
    ref.mkdir()
    MetOpInstrumentsDecoderModule(str(out / "metop_ahrpt.cadu"),
                                  str(ref / "metop_ahrpt"), {}).process()
    written = process_path(str(ref / "dataset.json"))
    assert (out / "dataset.json").read_text() == \
        (ref / "dataset.json").read_text()
    _assert_products_and_composites_match(out, ref, written, {
        "AVHRR": ("avhrr_3", ["221", "321", "ch4_thermal"]),
        "MHS": ("mhs", ["221"])})


def _assert_products_and_composites_match(out, ref, written, products):
    """Each product's product.json and channel PNGs, and the composites,
    equal the JAX package's; products = {dir: (instrument, composites)}."""
    from PIL import Image
    from satdump_tpu_torch.image.io import load_img
    for prod, (inst, _) in products.items():
        meta = json.loads((out / prod / "product.json").read_text())
        assert meta == json.loads((ref / prod / "product.json").read_text())
        for img in meta["contents"]["images"]:
            assert np.array_equal(
                load_img(out / prod / img["file"]),
                np.asarray(Image.open(ref / prod / img["file"])))
    names = sorted(str(Path(f).relative_to(ref)) for f in written)
    assert names == sorted(f"{prod}/{inst}_{c}.png" for prod, (inst, cs)
                           in products.items() for c in cs)
    for rel in names:
        assert np.array_equal(load_img(out / rel),
                              np.asarray(Image.open(ref / rel))), rel


def test_meteor_m2_lrpt_baseband_to_products(tmp_path):
    """`meteor_m2_lrpt` at 280 ksps (sps 35/9) on CADUs carrying two
    8-line strips of MSU-MR channels 1-3, through the port's run_pipeline
    on the CPU to products (with `m2x_mode` true, so that no wall-clock day
    enters the timestamps): the MSU-MR product, dataset.json and the
    321_false_color composite equal the JAX package's from the same
    .cadu."""
    from satdump_tpu.models.meteor import MeteorMSUMRLRPTModule
    from satdump_tpu.products.processor import process_path
    rng = np.random.default_rng(9)
    cadus, _ = sim.msumr_lrpt_cadus(rng, 2)
    src = tmp_path / "meteor.cf32"
    write_baseband(src, "cf32",
                   sim.ccsds_qpsk_baseband(cadus, rng, sim.METEOR_SPS))
    out = tmp_path / "torch"
    trun(tparse(METEOR)["meteor_m2_lrpt"], str(src), str(out),
         user_params={"samplerate": 280e3, "m2x_mode": True,
                      "torch_device": "cpu"})
    got = np.fromfile(out / "meteor_m2_lrpt.cadu", np.uint8).reshape(-1, 1024)
    np.testing.assert_array_equal(got, cadus)
    ref = tmp_path / "jax"
    ref.mkdir()
    MeteorMSUMRLRPTModule(str(out / "meteor_m2_lrpt.cadu"),
                          str(ref / "meteor_m2_lrpt"),
                          {"m2x_mode": True, "satellite": "METEOR-M2"}
                          ).process()
    written = process_path(str(ref / "dataset.json"))
    assert (out / "dataset.json").read_text() == \
        (ref / "dataset.json").read_text()
    _assert_products_and_composites_match(out, ref, written, {
        "MSU-MR": ("msu_mr", ["321_false_color"])})


def test_cli_pipeline_stops_at_unported_products(metop_12, tmp_path):
    """A pipeline whose products module is not ported (every file of
    resources/pipelines/ is now: here ELEKTRO-L LRIT's pipeline from an
    extra directory, its products module swapped for an id that neither
    package registers) stops there with the registry's unknown-module
    error."""
    cadus, src = metop_12
    cadu = tmp_path / "in.cadu"
    cadus.tofile(cadu)
    pipes = json.loads((ROOT / "resources" / "pipelines" /
                        "Elektro_Arktika.json").read_text())
    pipe = pipes["elektro_lrit"]
    pipe["work"]["products"]["module"] = "no_such_module"
    extra = tmp_path / "pipelines"
    extra.mkdir()
    (extra / "unported.json").write_text(json.dumps(
        {"elektro_lrit_unported": pipe}))
    with pytest.raises(SatdumpError,
                       match="unknown module 'no_such_module'"):
        cli.main(["--pipelines-dir", str(extra), "pipeline",
                  "elektro_lrit_unported", "cadu", str(cadu),
                  str(tmp_path / "out"), "--torch_device", "cpu"])
