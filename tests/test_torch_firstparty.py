"""The port's first-party ingest (SEVIRI .nat, Himawari HSD, netCDF / HDF5)
and its calibrators against satdump_tpu's, on the CPU: the products (every
field and channel image) and the calibrated values bit for bit, on the JAX
tests' fixtures and on the port's own writers (sim.seviri_nat at the
published 3,712 columns, sim.ahi_hsd_segments at band 13's 5,500), and
`ingest --process` through both CLIs to the same products and composites.
"""

import bz2
import json
from pathlib import Path

import numpy as np
import pytest

from satdump_tpu.products import calibration as jcal
from satdump_tpu.products import firstparty as jfp
from satdump_tpu.products.image_product import ImageProduct as JImageProduct
from satdump_tpu_torch import sim
from satdump_tpu_torch.products import calibration as tcal
from satdump_tpu_torch.products import firstparty as tfp
from satdump_tpu_torch.products.image_product import \
    ImageProduct as TImageProduct
from tests.test_firstparty import (make_abi_nc, make_hsd_segment,
                                   make_seviri_nat)


def _products_equal(a, b, tmp: Path):
    """Saved the same: product.json, product.cbor, every channel image;
    and every channel calibrated to the same values, where the product
    has a calibration."""
    assert type(a).__name__ == type(b).__name__
    da, db = tmp / "jax", tmp / "torch"
    a.save(str(da))
    b.save(str(db))
    assert json.loads((db / "product.json").read_text()) == \
        json.loads((da / "product.json").read_text())
    assert (db / "product.cbor").read_bytes() == \
        (da / "product.cbor").read_bytes()
    assert [h.channel_name for h in a.images] == \
        [h.channel_name for h in b.images]
    for ha, hb in zip(a.images, b.images):
        assert ha.image.dtype == hb.image.dtype
        np.testing.assert_array_equal(ha.image, hb.image)
        assert a.has_calibration() == b.has_calibration()
        if not b.has_calibration():
            continue
        ca = jcal.calibrate_channel(a, ha.channel_name)
        cb = tcal.calibrate_channel(b, hb.channel_name)
        np.testing.assert_array_equal(ca, cb)


def test_seviri_nat_fixture(tmp_path):
    raw = make_seviri_nat()[0]
    a, b = jfp.nat_seviri.parse_seviri_nat(raw), \
        tfp.nat_seviri.parse_seviri_nat(raw)
    _products_equal(a, b, tmp_path)
    assert [h.channel_name for h in b.images] == ["1", "2", "12"]


def test_seviri_nat_writer_at_full_width(tmp_path, rng):
    raw, truth = sim.seviri_nat(rng, 6)
    path = tmp_path / "MSG4-SEVI-MSG15-0100-NA-20240101121243.nat"
    path.write_bytes(raw)
    a, b = jfp.ingest_file(str(path)), tfp.ingest_file(str(path))
    _products_equal(a, b, tmp_path)
    assert len(b.images) == 12 and b.get_product_source() == "MSG-4"
    for ch in (0, 8, 10):
        np.testing.assert_array_equal(
            b.get_channel(str(ch + 1)).image,
            truth["vis"][ch][::-1, ::-1].astype(np.uint16) << 6)
    hrv = b.get_channel("12").image
    assert hrv.shape == (18, sim.SEVIRI_HRV_COLUMNS)
    # HRV lines at their window's east column, then the full mirror
    placed = np.zeros((18, sim.SEVIRI_HRV_COLUMNS), np.uint16)
    for y in range(18):
        col0 = 4000 if (y // 3) * 3 + 4 > truth["upper_south_line"] else 2000
        placed[y, col0: col0 + sim.SEVIRI_HRV_LINE] = truth["hrv"][y] << 6
    np.testing.assert_array_equal(hrv, placed[::-1, ::-1])
    cal = tcal.calibrate_channel(b, "1")
    counts = truth["vis"][0][::-1, ::-1].astype(np.float64)
    ok = counts > 0
    np.testing.assert_allclose(
        cal[ok], truth["offset"][0] + counts[ok] * truth["slope"][0],
        rtol=1e-12)


def test_hsd_fixture_and_writer(tmp_path, rng):
    paths = []
    for i in (1, 2):
        p = tmp_path / f"HS_H09_20240101_0000_B01_FLDK_R10_S{i:02d}10.DAT.bz2"
        p.write_bytes(bz2.compress(make_hsd_segment(i)[0]))
        paths.append(str(p))
    (a,), (b,) = jfp.ingest_files(paths), tfp.ingest_files(paths)
    _products_equal(a, b, tmp_path / "fixture")
    files, img = sim.ahi_hsd_segments(rng, seg_lines=4, nsegs=2)
    paths = []
    for i, f in enumerate(files, 1):
        p = tmp_path / f"HS_H09_20240101_0000_B13_FLDK_R20_S{i:02d}02.DAT.bz2"
        p.write_bytes(f)
        paths.append(str(p))
    (a,), (b,) = jfp.ingest_files(paths), tfp.ingest_files(paths)
    _products_equal(a, b, tmp_path / "writer")
    got = b.get_channel("13").image
    assert got.shape == (8, 5500)
    np.testing.assert_array_equal(
        got, np.where(img >= 65534, 0, img).astype(np.uint16) << 4)
    assert b.get_proj_cfg()["type"] == "geos"


h5py = pytest.importorskip("h5py")


def test_abi_nc_and_merge(tmp_path):
    p2 = tmp_path / "OR_ABI-L1b-RadF-M6C02_G16.nc"
    p7 = tmp_path / "OR_ABI-L1b-RadF-M6C07_G16.nc"
    make_abi_nc(str(p2), band=2, shape=(12, 16), kappa=0.0015)
    make_abi_nc(str(p7), band=7)
    _products_equal(jfp.ingest_file(str(p7)), tfp.ingest_file(str(p7)),
                    tmp_path / "one")
    (a,), (b,) = (jfp.ingest_files([str(p2), str(p7)]),
                  tfp.ingest_files([str(p2), str(p7)]))
    _products_equal(a, b, tmp_path / "merged")
    assert {h.channel_name for h in b.images} == {"2", "7"}


def test_fy4_agri_and_generic_hdf(tmp_path):
    path = tmp_path / "FY4A-AGRI-L1.hdf"
    img = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 9) % 4096
    img[0, 0] = 65535
    with h5py.File(path, "w") as f:
        g = f.create_group("Data")
        g.create_dataset("NOMChannel01", data=img)
        g.create_dataset("NOMChannel02", data=img[::-1])
        f.create_group("Calibration").create_dataset(
            "CALChannel01", data=np.linspace(180.0, 320.0, 4096))
    _products_equal(jfp.ingest_file(str(path)), tfp.ingest_file(str(path)),
                    tmp_path / "agri")
    path = tmp_path / "random_l1.h5"
    with h5py.File(path, "w") as f:
        f.create_group("obs").create_dataset(
            "tb_89ghz", data=np.random.default_rng(0).normal(size=(16, 16)))
        f.create_dataset("tiny", data=np.ones((4, 4)))
    _products_equal(jfp.ingest_file(str(path)), tfp.ingest_file(str(path)),
                    tmp_path / "generic")


def test_hdf_without_h5py_raises(tmp_path, monkeypatch):
    path = tmp_path / "x.nc"
    make_abi_nc(str(path))
    monkeypatch.setattr(tfp.hdf_nc, "HAVE_H5PY", False)
    with pytest.raises(RuntimeError, match="h5py unavailable"):
        tfp.ingest_file(str(path))
    (tmp_path / "y.bin").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="unrecognized firstparty"):
        tfp.ingest_file(str(tmp_path / "y.bin"))


@pytest.mark.parametrize("points", [
    [[0, 0.0], [100, 10.5], [400, 42.0], [1023, 99.0], [700, 0]],
    [[0, 0.0], [1023, 100.0]],
], ids=["spline", "two_points"])
def test_generic_xrit_calibrator(points, rng):
    counts = rng.integers(0, 1024, (12, 20)).astype(np.uint16)
    counts[0, :3] = 0
    out = []
    for cls in (JImageProduct, TImageProduct):
        p = cls()
        p.instrument_name = "xrit"
        p.add_channel(counts, "IR_108", abs_index=0, bit_depth=10)
        p.add_channel(counts, "VIS", abs_index=1, bit_depth=10)
        p.set_calibration("generic_xrit", {"vars": {
            "IR_108": points, "VIS": points,
            "bits_for_calib": {"VIS": 8}}})
        cal = jcal if cls is JImageProduct else tcal
        out.append([cal.calibrate_channel(p, n) for n in ("IR_108", "VIS")])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(out[1][0][counts > 0]).all()


def _cli_ingest(main, paths, out, extra=()):
    assert main(["ingest", *map(str, paths), "-o", str(out), "--process",
                 *extra]) == 0


def test_cli_ingest_and_process(tmp_path, rng):
    from satdump_tpu.cli import main as jmain
    from satdump_tpu_torch.cli import main as tmain
    from satdump_tpu_torch.image.io import load_img
    raw, _ = sim.seviri_nat(rng, 8)
    nat = tmp_path / "MSG4-SEVI-MSG15-0100-NA-20240101121243.nat"
    nat.write_bytes(raw)
    files, _ = sim.ahi_hsd_segments(rng, seg_lines=6, nsegs=2)
    paths = [nat]
    for i, f in enumerate(files, 1):
        paths.append(tmp_path / f"HS_H09_B13_S{i:02d}02.DAT.bz2")
        paths[-1].write_bytes(f)
    _cli_ingest(jmain, paths, tmp_path / "jax")
    _cli_ingest(tmain, paths, tmp_path / "torch", ("--torch_device", "cpu"))
    ds = json.loads((tmp_path / "torch" / "dataset.json").read_text())
    assert ds == json.loads((tmp_path / "jax" / "dataset.json").read_text())
    assert ds["products"] == ["seviri", "ahi"]
    pngs = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*.png"))
    assert pngs == sorted(p.relative_to(tmp_path / "torch")
                          for p in (tmp_path / "torch").rglob("*.png"))
    names = {p.name for p in pngs}
    assert {"seviri_321_false_color.png", "seviri_thermal_ir.png",
            "ahi_ir_clean.png"} <= names
    for rel in pngs:
        np.testing.assert_array_equal(load_img(tmp_path / "torch" / rel),
                                      load_img(tmp_path / "jax" / rel))


def test_cli_ingest_on_cuda_without_a_card_raises(tmp_path, rng):
    import torch

    from satdump_tpu_torch.cli import main as tmain
    from satdump_tpu_torch.core.exceptions import SatdumpError
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    nat = tmp_path / "x.nat"
    nat.write_bytes(make_seviri_nat()[0])
    with pytest.raises(SatdumpError, match="cuda"):
        tmain(["ingest", str(nat), "-o", str(tmp_path / "o"), "--process"])
    assert not (tmp_path / "o").exists()
