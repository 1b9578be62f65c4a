"""The port's products level against satdump_tpu's on the CPU: one .cadu
carrying AVHRR/3, MHS, IASI-IMG, AMSU-A, ASCAT and GOME packets through
both packages' `metop_instruments`, METEOR MSU-MR LRPT passes through both
`meteor_msumr_lrpt`, then both products processors.

Tolerance: none. Every product's channel pixels, product.json,
product.cbor and dataset.json are equal to the reference's, and every
composite is pixel-identical (the port's PNGs read back by its own codec
and by Pillow; Pillow reads the reference's).
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from satdump_tpu.ccsds import CCSDSHeader, CCSDSPacket
from satdump_tpu.models.meteor import MeteorMSUMRLRPTModule as JMeteor
from satdump_tpu.models.metop import MetOpInstrumentsDecoderModule as JMetop
from satdump_tpu.products.processor import process_image_product as jpip
from satdump_tpu.products.processor import process_path as jprocess
from satdump_tpu.products.product import load_product as jload
from satdump_tpu_torch import sim
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.models.meteor import MeteorMSUMRLRPTModule as TMeteor
from satdump_tpu_torch.models.metop import MetOpInstrumentsDecoderModule as TMetop
from satdump_tpu_torch.products.processor import process_image_product as tpip
from satdump_tpu_torch.products.processor import process_path as tprocess
from satdump_tpu_torch.products.product import load_product as tload
from tests.test_meteor import _make_segment_payload
from tests.test_metop import (_ascat_packet, _avhrr_packet, _gome_packet,
                              _iasi_packet, _mhs_packet)

# metop_instruments' autogen composites for the pass below
METOP_COMPOSITES = sorted(
    ["AVHRR/avhrr_3_221.png", "AVHRR/avhrr_3_321.png",
     "AVHRR/avhrr_3_ch4_thermal.png", "MHS/mhs_221.png",
     "IASI-IMG/iasi_img_thermal_ir.png", "AMSU/amsu_a_false_color.png",
     "GOME/gome_band_false_color.png"]
    + [f"ASCAT/{b}/ascat_channel_1.png" for b in (1, 3, 6)])


def _amsu_packet(rng, apid: int) -> CCSDSPacket:
    """MetOp AMSU-A1 (APID 39, 2096 B) or A2 (APID 40, 1136 B) packet with
    known words at the line parsers' offsets (tests/test_metop.py)."""
    size = 2096 if apid == 39 else 1136
    words = rng.integers(2, 60000, (size - 16) // 2).astype(np.uint16)
    payload = bytearray(size)
    payload[0:8] = bytes([20000 >> 8, 20000 & 0xFF, 0, 0, 0x10, 0, 0, 0])
    payload[14: 14 + 2 * len(words)] = words.astype(">u2").tobytes()
    h = CCSDSHeader(apid=apid, packet_length=size - 1)
    h.raw = h.encode()
    return CCSDSPacket(header=h, payload=payload)


def _iasi_calib_packet(bbt_mk: int) -> CCSDSPacket:
    payload = bytearray(800)
    payload[14 + 8: 14 + 12] = bbt_mk.to_bytes(4, "big")
    return CCSDSPacket(header=CCSDSHeader(apid=180), payload=payload)


def metop_all_instruments_cadus(rng) -> np.ndarray:
    by_vcid = {
        9: [_avhrr_packet(rng.integers(0, 1024, (2048, 5), dtype=np.uint16),
                          ch3a=i % 2 == 0, seq=i, ms=166 * i)
            for i in range(6)],
        12: [_mhs_packet(rng.integers(0, 65535, (90, 5), dtype=np.uint16),
                         i, ms=2667 * i) for i in range(4)],
        10: [_iasi_calib_packet(290150)]
        + [_iasi_packet(np.full((64, 64), 100 if c in (35, 36) else
                                900 if c in (32, 33) else 0, np.uint16)
                        + (rng.integers(120, 880, (64, 64)).astype(np.uint16)
                           if c not in (32, 33, 35, 36) else 0), c,
                        ms=8000 + c)
           for c in range(1, 37)],
        3: [_amsu_packet(rng, 39) for _ in range(3)]
        + [_amsu_packet(rng, 40) for _ in range(3)],
        15: [_ascat_packet(rng.integers(0, 65536, 256, dtype=np.uint32)
                           .astype(np.uint16), 208 + beam, ms=100 * i)
             for i in range(3) for beam in (0, 2, 5)],
        24: [_gome_packet(rng.integers(0, 65536, (2, 4, 1024),
                                       dtype=np.uint32).astype(np.uint16), c)
             for c in range(16)],
    }
    frames = [sim.vcid_frames(p, v, sim.METOP_B_SCID)
              for v, p in by_vcid.items()]
    return sim.rs_encode_frames(np.concatenate(frames))


def _run_both(tmp: Path, cadus: np.ndarray, jcls, tcls, params: dict):
    cadus.tofile(tmp / "in.cadu")
    out = {}
    for name, cls, extra in (("jax", jcls, {}),
                             ("torch", tcls, {"torch_device": "cpu"})):
        (tmp / name).mkdir()
        mod = cls(str(tmp / "in.cadu"), str(tmp / name / "pass"),
                  dict(params, **extra))
        mod.process()
        out[name] = mod
    return out


@pytest.fixture(scope="module")
def metop_pass(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("metop_products")
    mods = _run_both(tmp, metop_all_instruments_cadus(
        np.random.default_rng(21)), JMetop, TMetop, {})
    written = {"jax": jprocess(str(tmp / "jax" / "dataset.json")),
               "torch": tprocess(str(tmp / "torch" / "dataset.json"),
                                 device="cpu")}
    return tmp, mods, written


def _assert_products_equal(tmp: Path):
    jds = (tmp / "jax" / "dataset.json").read_text()
    assert (tmp / "torch" / "dataset.json").read_text() == jds
    products = json.loads(jds)["products"]
    for rel in products:
        jd, td = tmp / "jax" / rel, tmp / "torch" / rel
        assert json.loads((td / "product.json").read_text()) == \
            json.loads((jd / "product.json").read_text()), rel
        assert (td / "product.cbor").read_bytes() == \
            (jd / "product.cbor").read_bytes(), rel
        jp, tp = jload(str(jd)), tload(str(td))
        assert [h.channel_name for h in tp.images] == \
            [h.channel_name for h in jp.images]
        for a, b in zip(jp.images, tp.images):
            assert b.image.dtype == a.image.dtype, (rel, a.channel_name)
            assert np.array_equal(b.image, a.image), (rel, a.channel_name)
    return products


def _assert_composites_equal(tmp: Path, written: dict, expect):
    names = {k: sorted(str(Path(f).relative_to(tmp / k)) for f in v)
             for k, v in written.items()}
    assert names["torch"] == names["jax"] == sorted(expect)
    for rel in expect:
        ref = np.asarray(Image.open(tmp / "jax" / rel))
        got = load_img(tmp / "torch" / rel)
        assert got.shape == ref.shape and np.array_equal(got, ref), rel
        assert np.array_equal(np.asarray(Image.open(tmp / "torch" / rel)),
                              ref), rel


def test_metop_instruments_stats_match_jax(metop_pass):
    _, mods, _ = metop_pass
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["avhrr_lines"] == 6
    assert mods["torch"].stats["iasi_img_lines"] == 1
    assert mods["torch"].stats["amsu_lines"] == [3, 3]


def test_metop_products_match_jax(metop_pass):
    tmp, _, _ = metop_pass
    products = _assert_products_equal(tmp)
    assert sorted(products) == sorted(
        ["AVHRR", "MHS", "IASI-IMG", "AMSU", "GOME", "ASCAT/1", "ASCAT/3",
         "ASCAT/6"])


def test_metop_composites_match_jax(metop_pass):
    tmp, _, written = metop_pass
    _assert_composites_equal(tmp, written, METOP_COMPOSITES)


@pytest.mark.parametrize("instrument,presets,calib", [
    ("MHS", ["bt_165ghz", "421"], "noaa_mhs"),
    ("AMSU", ["temp_550hpa", "temp_350hpa", "temp_200hpa", "temp_100hpa"],
     "noaa_amsu"),
])
def test_calibrated_presets_match_jax(metop_pass, tmp_path, instrument,
                                      presets, calib):
    """cal(...) presets, on the products with a per-line quadratic
    radiance calibration attached."""
    tmp, _, _ = metop_pass
    rng = np.random.default_rng(5)
    lines, chans = 4, 15
    plpc = [[{"a0": float(rng.uniform(0, 1e-3)),
              "a1": float(rng.uniform(1e-8, 4e-8)),
              "a2": float(rng.uniform(0, 1e-14))} for _ in range(chans)]
            for _ in range(lines)]
    out = {}
    for name, load, pip, kw in (("jax", jload, jpip, {}),
                                ("torch", tload, tpip, {"device": "cpu"})):
        p = load(str(tmp / name / instrument))
        p.set_calibration(calib, {"vars": {"perLine_perChannel": plpc}})
        out[name] = pip(p, str(tmp_path / name), presets=presets, **kw)
    assert [Path(f).name for f in out["torch"]] == \
        [Path(f).name for f in out["jax"]]
    assert len(out["jax"]) == len(presets)
    for a, b in zip(out["jax"], out["torch"]):
        assert np.array_equal(load_img(b), np.asarray(Image.open(a))), b


def _meteor_4_line_cadus() -> np.ndarray:
    """The 4-line, one-channel pass of tests/test_meteor.py:154: a
    gradient, 14 segments a line on APID 64 at QF 90, the sequence count
    skipping the other 29 packets of each 43-packet loop."""
    img_h, img_w = 4 * 8, 14 * 112
    truth = (np.linspace(0, 255, img_h * img_w).reshape(img_h, img_w)
             ).astype(np.uint8)
    packets, seq = [], 0
    for line in range(4):
        for s in range(14):
            strip = truth[line * 8:(line + 1) * 8, s * 112:(s + 1) * 112]
            mcus = strip.reshape(8, 14, 8).transpose(1, 0, 2)
            payload = _make_segment_payload(np.ascontiguousarray(mcus),
                                            (s * 14) % 256, 90.0)
            packets.append(CCSDSPacket(
                header=CCSDSHeader(apid=64, packet_sequence_count=seq),
                payload=bytearray(payload)))
            seq += 1
        seq += 29
    return sim.rs_encode_frames(sim.vcid_frames(packets, 5, 0))


METEOR_PARAMS = {"m2x_mode": True, "satellite": "METEOR-M2-4"}


def test_meteor_4_line_pass_matches_jax(tmp_path):
    mods = _run_both(tmp_path, _meteor_4_line_cadus(), JMeteor, TMeteor,
                     METEOR_PARAMS)
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["channels"] == 1
    assert mods["torch"].stats["lines"] == 32
    assert _assert_products_equal(tmp_path) == ["MSU-MR"]


def test_meteor_3_channel_pass_and_composite_match_jax(tmp_path):
    cadus, truth = sim.msumr_lrpt_cadus(np.random.default_rng(8), 3)
    mods = _run_both(tmp_path, cadus, JMeteor, TMeteor, METEOR_PARAMS)
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["channels"] == 3
    _assert_products_equal(tmp_path)
    p = tload(str(tmp_path / "torch" / "MSU-MR"))
    for ch, img in truth.items():       # lossy JPEG at QF 80
        got = (p.get_channel(str(ch)).image >> 8).astype(int)
        assert np.abs(got - img).mean() < 8.0
    written = {"jax": jprocess(str(tmp_path / "jax" / "dataset.json")),
               "torch": tprocess(str(tmp_path / "torch" / "dataset.json"),
                                 device="cpu")}
    _assert_composites_equal(tmp_path, written,
                             ["MSU-MR/msu_mr_321_false_color.png"])


def test_processor_skips_cached_presets_and_raises_device_faults(
        metop_pass, tmp_path, monkeypatch):
    """A second run renders nothing (the preset cache); a failing preset is
    logged and skipped, but a fault of the device is raised."""
    import satdump_tpu_torch.products.processor as proc
    tmp, _, _ = metop_pass
    p = tload(str(tmp / "torch" / "MHS"))
    assert len(tpip(p, str(tmp_path / "a"), device="cpu")) == 1
    assert tpip(p, str(tmp_path / "a"), device="cpu") == []

    def bad(*a, **k):
        raise ValueError("bad expression")
    monkeypatch.setattr(proc, "generate_composite", bad)
    assert tpip(p, str(tmp_path / "b"), device="cpu") == []

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(proc, "generate_composite", fault)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpip(p, str(tmp_path / "c"), device="cpu")


@pytest.mark.parametrize("nbits", [10, 12])
def test_repack_matches_jax(nbits):
    """The port's byte-group repack and its inverse equal the reference's
    bit-matrix ones on random bytes whose length is no whole group."""
    from satdump_tpu.utils import repack as jrepack
    from satdump_tpu_torch.utils import repack as trepack
    rng = np.random.default_rng(nbits)
    data = rng.integers(0, 256, (3, 4, 1237), dtype=np.uint8)
    got = getattr(trepack, f"repack_{nbits}bit")(data)
    want = getattr(jrepack, f"repack_{nbits}bit")(data)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    words = rng.integers(0, 1 << nbits, (5, 1001)).astype(np.uint16)
    assert np.array_equal(trepack.pack_nbits_to_bytes(words, nbits),
                          jrepack.pack_nbits_to_bytes(words, nbits))
    with pytest.raises(ValueError, match="group"):
        trepack.pack_nbits_to_bytes(words, 11)
