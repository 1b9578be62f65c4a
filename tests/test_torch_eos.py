"""The port's EOS modules (`models/eos.py`: the MODIS reader,
`aqua_db_decoder`, `eos_instruments`) against the JAX package's, on the
CPU, on the same inputs made from a seed; the sim builders of Aqua DB CADUs
and baseband; and `aqua_db` through the port's CLI from .soft.

Everything here is host code in both packages, so there is no tolerance:
.cadu bytes, reader images, product.json, product.cbor and dataset.json are
equal.
"""

import json

import numpy as np
import pytest

from satdump_tpu.models import eos as je
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.models import eos as te
from satdump_tpu_torch.ops.fec import differential
from satdump_tpu_torch.products.product import load_product
from tests.test_eos_modis import _day_packet
from tests.test_torch_hrpt import _assert_products_equal, _run_both


def test_sim_modis_packet_equals_the_jax_suites_fixture(rng):
    w = rng.integers(0, 4096, 415).astype(np.uint16)
    for pos, seq in ((0, 1), (7, 2)):
        a, b = sim.modis_day_packet(w, pos, seq), _day_packet(w, pos, seq)
        assert bytes(a.payload) == bytes(b.payload)
        assert a.header.sequence_flag == b.header.sequence_flag


def test_modis_reader_equals_jax(rng):
    got, ref = te.MODISReader(), je.MODISReader()
    for scan in range(2):
        for pos in range(6):
            for seq in (1, 2):
                p = sim.modis_day_packet(
                    rng.integers(0, 4096, 415).astype(np.uint16), pos, seq,
                    scan_count=scan, ms=1000 * scan)
                if scan == 1 and pos == 3:
                    p.payload[30] ^= 0x40          # a failed checksum
                got.work(p)
                ref.work(p)
    assert (got.lines, got.day_count) == (ref.lines, ref.day_count)
    assert got.timestamps_1000 == ref.timestamps_1000
    for c in range(31):
        np.testing.assert_array_equal(got.get_image_1000m(c),
                                      ref.get_image_1000m(c))
    for c in range(5):
        np.testing.assert_array_equal(got.get_image_500m(c),
                                      ref.get_image_500m(c))
    for c in range(2):
        np.testing.assert_array_equal(got.get_image_250m(c),
                                      ref.get_image_250m(c))


def _rails_soft(cadus, rng):
    """Aqua DB's ideal softs: randomized, each OQPSK rail NRZ-M on its own,
    as psk_demod gives them (the JAX suite's loopback)."""
    bits = sim.encode_cadu_stream_uncoded(cadus)
    bits = np.concatenate([rng.integers(0, 2, 1000).astype(np.uint8), bits])
    chan = np.empty_like(bits)
    chan[0::2], _ = differential.nrzm_encode(bits[0::2])
    chan[1::2], _ = differential.nrzm_encode(bits[1::2])
    return sim.symbols_to_soft_int8(chan, 90)


@pytest.mark.parametrize("bowtie", [False, True])
def test_aqua_db_and_eos_instruments_equal_jax(tmp_path, bowtie, rng):
    """sim.aqua_modis_cadus -> softs -> both packages' aqua_db_decoder
    (.cadu identical, every CADU sent) -> both eos_instruments (products
    identical, MODIS holding the words sent)."""
    cadus, words = sim.aqua_modis_cadus(rng, 5, idle=2)
    soft = _rails_soft(cadus, rng)
    soft[5000:5040] = -soft[5000:5040]           # bit errors for RS
    src = tmp_path / "a.soft"
    soft.tofile(src)
    mods = _run_both(tmp_path / "cadu", src, je.AquaDBDecoderModule,
                     te.AquaDBDecoderModule, {})
    assert mods["torch"].stats == mods["jax"].stats
    got = {k: np.fromfile(m.d_output_file, np.uint8)
           for k, m in mods.items()}
    np.testing.assert_array_equal(got["torch"], got["jax"])
    np.testing.assert_array_equal(got["torch"].reshape(-1, 1024), cadus)
    params = {"satellite": "aqua", "modis_bowtie": bowtie}
    mods = _run_both(tmp_path / "prod", tmp_path / "cadu" / "torch" /
                     "pass.cadu", je.EOSInstrumentsDecoderModule,
                     te.EOSInstrumentsDecoderModule, params)
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["modis_lines"] == 10
    assert _assert_products_equal(tmp_path / "prod") == ["MODIS"]
    if not bowtie:
        img = load_product(str(tmp_path / "prod" / "torch" / "MODIS")
                           ).get_channel("8").image
        # channel 8 (1000 m, index 0) of frame f at row 5 + f, first half
        np.testing.assert_array_equal(img[5, :5],
                                      words[:, 0, 4 * 83 + 52] << 4)


def test_eos_instruments_terra_and_bad_satellite(tmp_path, rng):
    cadus, _ = sim.aqua_modis_cadus(rng, 2, idle=1)
    src = tmp_path / "x.cadu"
    cadus.tofile(src)
    mods = _run_both(tmp_path, src, je.EOSInstrumentsDecoderModule,
                     te.EOSInstrumentsDecoderModule, {"satellite": "terra"})
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["modis_lines"] == 0       # VCID 30 is Aqua
    from satdump_tpu_torch.core.exceptions import PipelineError
    with pytest.raises(PipelineError, match="invalid"):
        te.EOSInstrumentsDecoderModule(str(src), str(tmp_path / "o"),
                                       {"satellite": "suomi"})


def test_cli_aqua_db_from_soft(tmp_path, rng):
    cadus, words = sim.aqua_modis_cadus(rng, 3, idle=1)
    src = tmp_path / "in.soft"
    _rails_soft(cadus, rng).tofile(src)
    out = tmp_path / "out"
    assert cli.main(["pipeline", "aqua_db", "soft", str(src), str(out),
                     "--torch_device", "cpu"]) == 0
    np.testing.assert_array_equal(
        np.fromfile(out / "aqua_db.cadu", np.uint8).reshape(-1, 1024), cadus)
    assert json.loads((out / "dataset.json").read_text())["products"] == \
        ["MODIS"]
    prod = load_product(str(out / "MODIS"))
    assert len(prod.images) == 38
    assert prod.get_channel("1").image.shape == (40, 1354 * 4)
