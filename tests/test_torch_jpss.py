"""The port's JPSS instruments (`models/jpss.py`: VIIRS, ATMS, OMPS and
`jpss_instruments`) against the JAX package's, on the CPU, on the same
inputs made from a seed; the sim builders of JPSS HRD CADUs against the JAX
suite's packet fixtures and the JAX module; and `jpss_hrd` / `npp_hrd`
through the port's CLI from .soft and .cadu.

Everything here is host code in both packages, so there is no tolerance:
reader images, product.json, product.cbor, dataset.json and the OMPS PNGs'
pixels are equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from satdump_tpu.models import jpss as jj
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.models import jpss as tj
from satdump_tpu_torch.products.product import load_product
from tests.test_jpss import _atms_scan_packets, _viirs_segment_packets
from tests.test_torch_hrpt import _assert_products_equal, _run_both

JPSS_FILE = Path(__file__).resolve().parents[1] / "resources" / \
    "pipelines" / "JPSS.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CLI tests run the CADU decoder's lock search, a loop of small
    torch ops; with one intra-op thread it does not wait on a thread pool
    that the other test workers of a parallel run keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _total(name):
    ch = tj.VIIRS_CHANNELS[name]
    return sum(w * o for w, o in zip(ch.zone_width, ch.oversample))


def _same_packets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert bytes(x.payload) == bytes(y.payload)
        assert (x.header.apid, x.header.sequence_flag,
                x.header.packet_sequence_count) == \
            (y.header.apid, y.header.sequence_flag,
             y.header.packet_sequence_count)


def test_sim_packets_equal_the_jax_suites_fixtures(rng):
    det = rng.integers(0, 4096, (16, _total("M6"))).astype(np.uint16)
    _same_packets(sim.viirs_segment_packets("M6", det, day=20000, ms=0),
                  _viirs_segment_packets("M6", det))
    chans = rng.integers(0, 65535, (22, 104), dtype=np.uint16)
    _same_packets(sim.atms_scan_packets(chans, 0, day=20000),
                  _atms_scan_packets(chans, 0))


@pytest.mark.parametrize("name", ["M6", "M4", "DNB"])
def test_viirs_reader_equals_jax(name, rng):
    ch = tj.VIIRS_CHANNELS[name]
    det = rng.integers(0, 8000, (ch.zone_height, _total(name))
                       ).astype(np.uint16)
    pkts = sim.viirs_segment_packets(name, det, seq0=5) + \
        sim.viirs_segment_packets(name, det[::-1].copy(), ms=1785, seq0=40)
    got, ref = tj.VIIRSReader(ch), jj.VIIRSReader(jj.VIIRS_CHANNELS[name])
    for p in pkts:
        got.feed(p)
        ref.feed(p)
    img = got.get_image()
    np.testing.assert_array_equal(img, ref.get_image())
    assert got.timestamps == ref.timestamps
    np.testing.assert_array_equal(img[:ch.zone_height],
                                  sim.viirs_rows(name, det))


@pytest.mark.parametrize("dst,src,dec", [("M5", "M4", 1), ("I4", "M12", 2)])
def test_viirs_differential_decode_equals_jax(dst, src, dec, rng):
    pkts = {}
    for n in (src, dst):
        ch = tj.VIIRS_CHANNELS[n]
        det = rng.integers(4000, 20000, (ch.zone_height, _total(n))
                           ).astype(np.uint16)
        pkts[n] = sim.viirs_segment_packets(n, det)
    images = []
    for pkg in (tj, jj):
        r = {n: pkg.VIIRSReader(pkg.VIIRS_CHANNELS[n]) for n in pkts}
        for n, ps in pkts.items():
            for p in ps:
                r[n].feed(p)
        r[dst].differential_decode(r[src], dec)
        images.append(r[dst].get_image())
    np.testing.assert_array_equal(*images)


def test_atms_and_omps_readers_equal_jax(rng):
    chans = rng.integers(0, 65535, (3, 22, 104), dtype=np.uint16)
    got, ref = tj.ATMSReader(), jj.ATMSReader()
    for ln in range(3):
        for p in sim.atms_scan_packets(chans[ln], ln, seq0=104 * ln):
            got.work(p)
            ref.work(p)
    assert got.lines == ref.lines == 3
    assert got.timestamps == ref.timestamps
    for c in range(22):
        np.testing.assert_array_equal(got.get_channel(c), ref.get_channel(c))
        np.testing.assert_array_equal(got.get_channel(c),
                                      chans[:, c, :96][:, ::-1])
    vals = rng.integers(0, 60000, (339, 142), dtype=np.int64)
    pkts = sim.omps_nadir_packets(vals) + sim.omps_nadir_packets(
        vals[::-1].copy(), ms=8000)[:1]
    got, ref = tj.omps_nadir_reader(), jj.omps_nadir_reader()
    for p in pkts:
        got.work(p)
        ref.work(p)
    assert got.lines == ref.lines == 1
    assert got.timestamps == ref.timestamps
    for c in (0, 100, 338):
        np.testing.assert_array_equal(got.get_channel(c), ref.get_channel(c))
        np.testing.assert_array_equal(got.get_channel(c)[0], vals[c])


def _assert_omps_equal(tmp: Path) -> int:
    pngs = sorted((tmp / "jax" / "OMPS").rglob("*.png"))
    for p in pngs:
        q = tmp / "torch" / p.relative_to(tmp / "jax")
        np.testing.assert_array_equal(load_img(q), np.asarray(Image.open(p)))
    assert len(pngs) == len(list((tmp / "torch" / "OMPS").rglob("*.png")))
    return len(pngs)


@pytest.mark.parametrize("npp", [False, True])
def test_jpss_instruments_equal_jax_on_sim_cadus(tmp_path, npp, rng):
    """sim.jpss_instrument_cadus -> both packages' jpss_instruments: the
    JAX module decodes every instrument sent, and the port's products
    equal its."""
    bands = ("M6", "M4") if npp else ("M10", "M15")
    cadus, truth = sim.jpss_instrument_cadus(rng, bands, 2, 1, npp=npp,
                                             idle=2)
    assert cadus.shape[1] == (1024 if npp else 1279)
    src = tmp_path / "x.cadu"
    cadus.tofile(src)
    mods = _run_both(tmp_path, src, jj.JPSSInstrumentsDecoderModule,
                     tj.JPSSInstrumentsDecoderModule, {"npp_mode": npp})
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["jax"].stats["satellite"] == \
        ("Suomi NPP" if npp else "NOAA 21 (JPSS-2)")
    assert mods["jax"].stats["atms_lines"] == 2
    assert mods["jax"].stats["omps_nadir_lines"] == 1
    assert _assert_products_equal(tmp_path) == ["VIIRS", "ATMS"]
    assert _assert_omps_equal(tmp_path) == 339
    check_truth(tmp_path / "torch", truth)


def check_truth(out: Path, truth: dict) -> None:
    """The products in `out` hold what sim.jpss_instrument_cadus sent."""
    vp = load_product(str(out / "VIIRS"))
    for band, rows in truth["viirs"].items():
        ch = tj.VIIRS_CHANNELS[band]
        img = tj.correct_generic_bowtie(rows, ch.zone_height, 1.0 / 1.9,
                                        0.52333)
        np.testing.assert_array_equal(
            vp.get_channel(band.lower()).image[:ch.zone_height], img)
    ap = load_product(str(out / "ATMS"))
    for c in range(22):
        np.testing.assert_array_equal(ap.get_channel(str(c + 1)).image,
                                      truth["atms"][:, c, :96][:, ::-1])
    omps = load_img(out / "OMPS" / "Nadir" / "OMPS-Nadir-1.png")
    np.testing.assert_array_equal(omps, truth["omps"][:, 0, :])


def test_jpss_hrd_baseband_to_cadu_equals_jax(tmp_path, rng):
    """The slice's card path on the CPU: JPSS-2 HRD baseband (OQPSK, sps
    1.6) through the port's and the JAX package's psk_demod and CADU
    decoder at 2^16-sample blocks (ROADMAP S5): both .cadu files hold
    every CADU sent."""
    from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
    from satdump_tpu.pipeline.runner import run_pipeline as jrun
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    cadus, _ = sim.jpss_instrument_cadus(rng, ("M6",), 1, 0, idle=1)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.JPSS_HRD_SPS, "oqpsk",
                                nrzm=True)
    src = tmp_path / "x.cf32"
    write_baseband(src, "cf32", bb)
    params = {"buffer_size": 1 << 16, "samplerate": 40e6}
    got = {}
    for name, parse, run, extra in (
            ("jax", jparse, jrun, {}),
            ("torch", parse_pipeline_file, run_pipeline,
             {"torch_device": "cpu"})):
        pipe = parse(JPSS_FILE)["jpss_hrd"]
        pipe.steps = pipe.steps[:3]
        out = run(pipe, str(src), str(tmp_path / name),
                  user_params=dict(params, **extra))
        got[name] = np.fromfile(out, np.uint8).reshape(-1, 1279)
    np.testing.assert_array_equal(got["torch"], got["jax"])
    np.testing.assert_array_equal(got["torch"], cadus)


def test_cli_jpss_hrd_from_soft(tmp_path, rng):
    """JPSS-2 HRD from ideal softs (OQPSK rails realigned, as psk_demod
    gives them) to products through the CLI, on the CPU."""
    cadus, truth = sim.jpss_instrument_cadus(rng, ("M6",), 1, 0, idle=2)
    bits = sim.encode_cadu_stream(cadus, nrzm=True)
    soft = sim.symbols_to_soft_int8(np.concatenate(
        [rng.integers(0, 2, 3000).astype(np.uint8), bits,
         rng.integers(0, 2, 4000).astype(np.uint8)]))
    src = tmp_path / "in.soft"
    soft.tofile(src)
    out = tmp_path / "out"
    assert cli.main(["pipeline", "jpss_hrd", "soft", str(src), str(out),
                     "--torch_device", "cpu"]) == 0
    got = np.fromfile(out / "jpss_hrd.cadu", np.uint8).reshape(-1, 1279)
    np.testing.assert_array_equal(got, cadus)
    ds = json.loads((out / "dataset.json").read_text())
    assert ds["products"] == ["VIIRS", "ATMS"]
    vp = load_product(str(out / "VIIRS"))
    np.testing.assert_array_equal(
        vp.get_channel("m6").image[:16],
        tj.correct_generic_bowtie(truth["viirs"]["M6"], 16, 1.0 / 1.9,
                                  0.52333))


def test_cli_npp_hrd_from_cadu(tmp_path, rng):
    cadus, truth = sim.jpss_instrument_cadus(rng, ("M9",), 1, 1, npp=True,
                                             idle=1)
    src = tmp_path / "in.cadu"
    cadus.tofile(src)
    out = tmp_path / "out"
    assert cli.main(["pipeline", "npp_hrd", "cadu", str(src), str(out),
                     "--torch_device", "cpu"]) == 0
    check_truth(out, truth)
