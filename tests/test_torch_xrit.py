"""The port's xRIT layer against the JAX package's, on the CPU, on the same
inputs made from a seed: the Rice decoder (the port's own build of
`native/rice.c`), the header records and transport demux, the TX fixtures
(`build_xrit_file`, `packetize_xrit_file`), `goes_lrit_data_decoder`, the
sim builder of GOES-R HRIT CADUs, and `goes_hrit` from its .cadu through the
port's CLI.

Everything here is host code in both packages, so there is no tolerance:
decoded samples, file bytes, images, product.json, product.cbor and
dataset.json are equal. The JAX package writes PNGs with Pillow and the port
with its own codec, so PNGs compare by their pixels.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from satdump_tpu import xrit as jx
from satdump_tpu.ccsds.mux import make_cadus_for_vcid as j_make_cadus
from satdump_tpu.xrit import goes as jgoes
from satdump_tpu.xrit import rice as jrice
from satdump_tpu_torch import cli, native, sim
from satdump_tpu_torch import xrit as tx
from satdump_tpu_torch.ccsds.mux import make_cadus_for_vcid as t_make_cadus
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.xrit import goes as tgoes
from satdump_tpu_torch.xrit import rice as trice
from tests.test_torch_hrpt import _assert_products_equal, _run_both

ROOT = Path(__file__).resolve().parents[1]


# -- Rice ---------------------------------------------------------------------

def _line(kind: str, rng) -> np.ndarray:
    if kind == "smooth":
        return np.clip(128 + np.cumsum(rng.normal(0, 3, 5424)), 0,
                       255).astype(np.uint8)
    if kind == "space":
        line = np.zeros(2000, np.uint8)
        line[500:1500] = np.clip(180 + rng.normal(0, 5, 1000), 0, 255)
        return line
    if kind == "random":
        return rng.integers(0, 256, 777).astype(np.uint8)
    return np.full(512, 77, np.uint8)


@pytest.mark.parametrize("kind", ["smooth", "space", "random", "const"])
def test_rice_8bit_equals_jax(kind, rng):
    line = _line(kind, rng)
    enc = jrice.rice_encode(line)
    assert trice.rice_encode(line) == enc
    got = trice.rice_decode(enc, len(line))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jrice.rice_decode(enc, len(line)))
    np.testing.assert_array_equal(got, line)


def test_rice_16bit_equals_jax(rng):
    line = np.clip(512 + np.cumsum(rng.normal(0, 8, 600)), 0,
                   1023).astype(np.uint16)
    enc = jrice.rice_encode(line, bits_per_pixel=10)
    got = trice.rice_decode(enc, len(line), bits_per_pixel=10)
    np.testing.assert_array_equal(
        got, jrice.rice_decode(enc, len(line), bits_per_pixel=10))
    np.testing.assert_array_equal(got, line)


def test_rice_stream_15bit_equals_jax(rng):
    """The VIIRS profile: n 15, J 8, a new reference every 128 blocks."""
    x = np.clip(3000 + np.cumsum(rng.normal(0, 20, 3 * 1024 + 40)), 0,
                32767).astype(np.uint16)
    enc = jrice.rice_encode(x, 15, 8, rsi=128)
    got = trice.rice_decode_stream(enc, len(x))
    np.testing.assert_array_equal(got, jrice.rice_decode_stream(enc, len(x)))
    np.testing.assert_array_equal(got, x)


def test_rice_stream_32bit_equals_jax(rng):
    """The OMPS profile: n 32, J 32, rsi 8, uint32 samples."""
    x = rng.integers(0, 60000, 3000).astype(np.uint32)
    x[:100] = rng.integers(0, 1 << 31, 100)
    enc = jrice.rice_encode(x, 32, 32, rsi=8)
    got = trice.rice_decode_stream32(enc, len(x))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jrice.rice_decode_stream32(enc,
                                                                   len(x)))
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("fn,args", [
    ("rice_decode", (b"\xff", 100)),
    ("rice_decode", (b"\xff\xff\x00", 100, 10)),
    ("rice_decode_stream", (b"\xf0\x00", 500)),
    ("rice_decode_stream32", (b"\xff", 100))])
def test_rice_corrupt_gives_none_in_both(fn, args):
    assert getattr(jrice, fn)(*args) is None
    assert getattr(trice, fn)(*args) is None


def test_native_build_goes_to_the_ports_build_dir():
    lib = native.get_lib("rice")
    so = Path(lib._name)
    assert so.parent == ROOT / "satdump_tpu_torch" / "_build"
    assert so.name.startswith("librice-") and so.suffix == ".so"
    assert so == native._target("rice")


def test_native_build_without_a_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CC", "no-such-compiler-xyz")
    with pytest.raises(native.NativeBuildError, match="no C compiler"):
        native.get_lib("rice")
    assert not (tmp_path / "_build").exists()


# -- transport ----------------------------------------------------------------

def _image_file(mod, name, img, file_type_code=0):
    records = [mod.ImageStructureRecord(bit_per_pixel=8,
                                        columns_count=img.shape[1],
                                        lines_count=img.shape[0],
                                        compression_flag=0)]
    return mod.build_xrit_file(name, img.tobytes(), records, file_type_code)


def test_tx_fixtures_equal_jax(rng):
    img = rng.integers(0, 256, (40, 100)).astype(np.uint8)
    raw = _image_file(tx, "a.lrit", img)
    assert raw == _image_file(jx, "a.lrit", img)
    tp = tx.packetize_xrit_file(raw, apid=77, seq_start=9)
    jp = jx.packetize_xrit_file(raw, apid=77, seq_start=9)
    assert len(tp) == len(jp) > 2
    for a, b in zip(tp, jp):
        assert bytes(a.payload) == bytes(b.payload)
        assert (a.header.apid, a.header.sequence_flag,
                a.header.packet_sequence_count) == \
            (b.header.apid, b.header.sequence_flag,
             b.header.packet_sequence_count)
    np.testing.assert_array_equal(t_make_cadus(tp, 5), j_make_cadus(jp, 5))
    for data in (b"", b"123456789", bytes(range(256)) * 3):
        assert tx.compute_crc(data) == jx.compute_crc(data)


def _demux_all(mod, cadus, flush=True):
    d = mod.XRITDemux()
    files = [f for c in cadus for f in d.work(c)]
    return files + (d.flush() if flush else [])


def _same_files(a, b):
    assert [f.filename for f in a] == [f.filename for f in b]
    for x, y in zip(a, b):
        assert bytes(x.lrit_data) == bytes(y.lrit_data)
        assert x.all_headers == y.all_headers
        assert (x.vcid, x.total_header_length) == \
            (y.vcid, y.total_header_length)


@pytest.mark.parametrize("case", ["clean", "bad_crc_text", "bad_crc_image",
                                  "cut_tail", "filler"])
def test_demux_equals_jax(case, rng):
    pkts = []
    for i in range(3):
        img = rng.integers(0, 256, (40, 100)).astype(np.uint8)
        pkts += tx.packetize_xrit_file(_image_file(tx, f"img_{i}.lrit", img),
                                       apid=100 + i, seq_start=i * 50)
    text = tx.build_xrit_file("t.txt", rng.integers(0, 256, 4000).astype(
        np.uint8).tobytes(), [], file_type_code=2)
    pkts += tx.packetize_xrit_file(text, apid=50)
    if case == "bad_crc_text":
        pkts[-2].payload[-1] ^= 0xFF
    if case == "bad_crc_image":
        pkts[2].payload[-1] ^= 0xFF
    if case == "cut_tail":
        pkts = pkts[:-1]
    cadus = t_make_cadus(pkts, vcid=5)
    if case == "filler":
        filler = np.zeros((2, cadus.shape[1]), np.uint8)
        filler[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
        filler[:, 4], filler[:, 5] = 1 << 6, 63
        cadus = np.concatenate([filler, cadus[:3], filler, cadus[3:]])
    got, ref = _demux_all(tx, cadus), _demux_all(jx, cadus)
    assert len(got) >= 3
    _same_files(got, ref)


# -- goes_lrit_data_decoder ---------------------------------------------------

def _goes_packets(mod, rng, compressed: bool, nseg=4, width=200, lines=25):
    full = sim.abi_segments(rng, nseg, width, lines)
    if compressed:
        return full, sim.goes_rice_abi_packets(full, nseg)
    pkts = []
    for s in range(nseg):
        records = [
            mod.ImageStructureRecord(bit_per_pixel=8, columns_count=width,
                                     lines_count=lines, compression_flag=0),
            mod.SegmentIdentificationHeader(
                image_identifier=7, segment_sequence_number=s,
                max_segment=nseg, max_column=width, max_row=nseg * lines),
            mod.NOAALRITHeader(product_id=16, product_subid=13),
            mod.TimeStampRecord(days=25000, milliseconds_of_day=43200)]
        raw = mod.build_xrit_file(f"OR_ABI-L2-CMIPF-M6C13_G16_s2022{s}.lrit",
                                  full[s * lines: (s + 1) * lines].tobytes(),
                                  records)
        pkts += mod.packetize_xrit_file(raw, apid=300 + s, seq_start=s * 1000)
    return full, pkts


def _assert_goes_outputs_equal(tmp: Path) -> None:
    """Every file under tmp/jax and tmp/torch: the same names; PNGs equal
    in pixels, other files in bytes; products equal."""
    names = {d: sorted(str(p.relative_to(tmp / d))
                       for p in (tmp / d).rglob("*") if p.is_file())
             for d in ("jax", "torch")}
    assert names["torch"] == names["jax"]
    for rel in names["jax"]:
        a, b = tmp / "jax" / rel, tmp / "torch" / rel
        if rel.endswith(".png"):
            np.testing.assert_array_equal(load_img(b),
                                          np.asarray(Image.open(a)))
        elif not rel.endswith((".json", ".cbor")):
            assert a.read_bytes() == b.read_bytes(), rel
    _assert_products_equal(tmp)


@pytest.mark.parametrize("compressed", [False, True])
def test_goes_lrit_decoder_equals_jax(tmp_path, compressed, rng):
    full, pkts = _goes_packets(tx, rng, compressed)
    emwin = tx.build_xrit_file("Z_EMWIN.TXT", b"WEATHER\n" * 40,
                               [tx.NOAALRITHeader(product_id=9)], 2)
    admin = tx.build_xrit_file("ADMIN.TXT", b"NOTICE", [], 1)
    pkts += tx.packetize_xrit_file(emwin, apid=400)
    pkts += tx.packetize_xrit_file(admin, apid=401)
    cadus = np.pad(t_make_cadus(pkts, vcid=13), ((0, 0), (0, 128)))
    src = tmp_path / "t.cadu"
    cadus.tofile(src)
    mods = _run_both(tmp_path, src, jgoes.GOESLRITDataDecoderModule,
                     tgoes.GOESLRITDataDecoderModule, {"write_lrit": True})
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["images"] == 1
    _assert_goes_outputs_equal(tmp_path)
    img = load_img(next((tmp_path / "torch" / "IMAGES").glob("GOES-16_13_*")))
    np.testing.assert_array_equal(img, full)


def test_goes_lrit_decoder_missing_lines_equal_jax(tmp_path, rng):
    """Rice lines lost in transit: both fill them the same way."""
    full, pkts = _goes_packets(tx, rng, True, nseg=2, width=120, lines=20)
    pkts = [p for i, p in enumerate(pkts) if i not in (5, 6, 30)]
    cadus = np.pad(t_make_cadus(pkts, vcid=13), ((0, 0), (0, 128)))
    src = tmp_path / "t.cadu"
    cadus.tofile(src)
    for fill in (False, True):
        d = tmp_path / f"fill{int(fill)}"
        _run_both(d, src, jgoes.GOESLRITDataDecoderModule,
                  tgoes.GOESLRITDataDecoderModule, {"fill_missing": fill})
        _assert_goes_outputs_equal(d)


def test_sim_goes_hrit_cadus_decode_in_jax(tmp_path, rng):
    text = b"EMWIN TEST PRODUCT\n" * 30
    cadus, full = sim.goes_hrit_xrit_cadus(rng, 3, 300, 30, text, idle=3)
    assert cadus.shape[1] == 1024
    from satdump_tpu.ops.fec.reed_solomon import ReedSolomon
    _, errs = ReedSolomon(k=223).decode_interleaved(cadus[:, 4:], True, 4)
    assert (np.asarray(errs) == 0).all()
    src = tmp_path / "g.cadu"
    cadus.tofile(src)
    _run_both(tmp_path, src, jgoes.GOESLRITDataDecoderModule,
              tgoes.GOESLRITDataDecoderModule, {})
    _assert_goes_outputs_equal(tmp_path)
    img = np.asarray(Image.open(next(
        (tmp_path / "jax" / "IMAGES").glob("GOES-16_13_*"))))
    np.testing.assert_array_equal(img, full)
    assert (tmp_path / "jax" / "EMWIN" / "A_EMWIN_TEST.txt").read_bytes() \
        == text


def test_cli_goes_hrit_from_cadu(tmp_path, rng):
    cadus, full = sim.goes_hrit_xrit_cadus(rng, 2, 160, 20, b"X" * 100,
                                           idle=2)
    src = tmp_path / "in.cadu"
    cadus.tofile(src)
    out = tmp_path / "out"
    assert cli.main(["pipeline", "goes_hrit", "cadu", str(src), str(out),
                     "--torch_device", "cpu"]) == 0
    ds = json.loads((out / "dataset.json").read_text())
    assert ds["products"] == ["ABI_13_7"]
    img = load_img(out / "IMAGES" / "GOES-16_13_7.png")
    np.testing.assert_array_equal(img, full)
    assert os.listdir(out / "EMWIN") == ["A_EMWIN_TEST.txt"]
