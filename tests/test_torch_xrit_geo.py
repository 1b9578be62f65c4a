"""The port's geostationary xRIT image decoders against the JAX package's,
on the CPU, on the same inputs made from a seed: the port's baseline JPEG
decoder (`image/jpeg.py::decode_jpeg_gray`, libjpeg's islow IDCT) against
Pillow, the wavelet codec (the port's hardened build of `decompwt.c`), and
`elektro_lrit_data_decoder`, `msg_lrit_data_decoder` and
`himawaricast_data_decoder` on one .cadu each.

Tolerances: the 8-bit JPEG decoder equals Pillow bit for bit; the WT codec
and the modules' products are byte-identical (PNGs compared by their
pixels: the JAX package writes them with Pillow, the port with its own
codec). Corrupt streams are fed to the port only.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from satdump_tpu.xrit import decompwt as jwt
from satdump_tpu.xrit import geo as jgeo
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import FormatError
from satdump_tpu_torch.image import jpeg
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.xrit import decompwt as twt
from satdump_tpu_torch.xrit import geo as tgeo
from tests.test_torch_hrpt import _assert_products_equal
from tests.test_torch_j2k_grb import _trees_equal


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    im.load()
    return np.asarray(im)


JPEG_CASES = [
    ((32, 128), "smooth", dict(quality=95)),
    ((37, 53), "smooth", dict(quality=50, optimize=True)),
    ((64, 64), "noise", dict(quality=100)),
    ((9, 200), "noise", dict(quality=5)),
    ((1, 1), "flat", dict(quality=75)),
    ((45, 70), "smooth", dict(quality=85, restart_marker_blocks=3)),
    ((40, 64), "noise", dict(quality=30, optimize=True,
                             restart_marker_rows=1)),
    ((100, 17), "edges", dict(quality=90)),
]


def _jpeg_image(shape, kind, rng):
    if kind == "noise":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, 200, np.uint8)
    if kind == "edges":
        img = np.zeros(shape, np.uint8)
        img[::7] = 255
        img[:, ::5] = 30
        return img
    return sim.smooth_scene(rng, *shape, 8)


@pytest.mark.parametrize("shape,kind,kw", JPEG_CASES)
def test_baseline_jpeg_equals_pillow(shape, kind, kw, rng):
    data = _pil_jpeg(_jpeg_image(shape, kind, rng), **kw)
    got = jpeg.decode_jpeg_gray(data, device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_decode(data))


def test_sof1_precision8_equals_pillow(rng):
    """The NumPy encoder's extended-sequential 8-bit streams (the sim's)."""
    from satdump_tpu_torch.image.jpeg12 import compress_jpeg12
    img = sim.smooth_scene(rng, 30, 70, 8)
    for q in (1, 4, 16):
        data = compress_jpeg12(img, 8, quality_div=q)
        np.testing.assert_array_equal(jpeg.decode_jpeg_gray(data, "cpu"),
                                      _pil_decode(data))


def test_idct_islow_at_the_range_limits(rng):
    """Large coefficients reach libjpeg's range-limit wrap: both equal."""
    img = np.where(rng.random((48, 48)) < 0.5, 0, 255).astype(np.uint8)
    data = _pil_jpeg(img, quality=100)
    np.testing.assert_array_equal(jpeg.decode_jpeg_gray(data, "cpu"),
                                  _pil_decode(data))


def test_refuses_progressive_and_colour(rng):
    img = sim.smooth_scene(rng, 24, 24, 8)
    with pytest.raises(FormatError, match="progressive"):
        jpeg.decode_jpeg_gray(_pil_jpeg(img, progressive=True), "cpu")
    rgb = np.stack([img, img[::-1], img[:, ::-1]], -1)
    with pytest.raises(FormatError, match="colour"):
        jpeg.decode_jpeg_gray(_pil_jpeg(rgb), "cpu")


def _corruptions(data: bytes, rng, n: int = 40):
    out = [data[:k] for k in range(0, len(data), max(len(data) // 30, 1))]
    for _ in range(n):
        b = bytearray(data)
        for pos in rng.integers(0, len(b), int(rng.integers(1, 5))):
            b[pos] = int(rng.integers(0, 256))
        out.append(bytes(b))
    return out


def test_corrupt_jpeg_returns_an_error(rng):
    """Truncated and corrupted JPEG streams (port only): FormatError or an
    image, never a crash; the hardened jpeg12.c returns None."""
    from satdump_tpu_torch.image.jpeg12 import (compress_jpeg12,
                                                decompress_jpeg12)
    img = sim.smooth_scene(rng, 40, 48, 8)
    errors = 0
    for data in (_pil_jpeg(img, quality=80, restart_marker_blocks=2),
                 compress_jpeg12(img.astype(np.uint16) << 4, 12)):
        for c in _corruptions(data, rng):
            try:
                jpeg.decode_jpeg_gray(c, "cpu")
            except FormatError:
                errors += 1
            decompress_jpeg12(c)
    assert errors > 0


def test_jpeg12_refuses_bad_table_selectors(rng):
    """jpeg12.c's unchecked reads (port only): a quantization or Huffman
    table selector above 3 and segments shorter than their tables."""
    from satdump_tpu_torch.image.jpeg12 import (compress_jpeg12,
                                                decompress_jpeg12)
    data = compress_jpeg12(sim.smooth_scene(rng, 16, 16, 12), 12)
    assert decompress_jpeg12(data) is not None
    sof = data.index(b"\xff\xc1")
    sos = data.index(b"\xff\xda")
    dqt = data.index(b"\xff\xdb")
    for pos, val in ((sof + 12, 200), (sos + 6, 0xF7), (sos + 6, 0x7F),
                     (dqt + 3, 30), (dqt + 3, 0x80)):
        bad = bytearray(data)
        bad[pos] = val
        assert decompress_jpeg12(bytes(bad)) is None


# -- the wavelet codec ------------------------------------------------------

@pytest.mark.parametrize("pred,block_mode", [(0, 0), (2, 1), (3, 3)])
def test_wt_codec_equals_jax(rng, pred, block_mode):
    img = sim.smooth_scene(rng, 48, 70, 10)
    data = twt.wt_compress(img, 10, pred=pred, block_mode=block_mode,
                           restart=4)
    assert data == jwt.wt_compress(img, 10, pred=pred,
                                   block_mode=block_mode, restart=4)
    out, qual = twt.wt_decompress(data, 70, 48, 10)
    jout, jqual = jwt.wt_decompress(data, 70, 48, 10)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(qual, jqual)
    np.testing.assert_array_equal(out, img)


def test_corrupt_wt_returns_an_error(rng):
    """Corrupted WT fields (port only; decompwt.c's division by
    a zero range): each decodes with damaged lines or returns None."""
    img = sim.smooth_scene(rng, 64, 64, 10)
    data = twt.wt_compress(img, 10, restart=2)
    damaged = 0
    for c in _corruptions(data, rng, 80):
        r = twt.wt_decompress(c, 64, 64, 10)
        damaged += r is None or bool((r[1] < 64).any())
    assert damaged > 0
    # a field whose DC magnitude class reaches 30 and leaves the arithmetic
    # decoder a range of 0: the JAX package's decompwt.c dies of SIGFPE on
    # it (found by a random search over fields behind a valid header)
    fpe = bytes.fromhex(
        "ff01a004000406400080ff02ef526946fc2ff4e2f90c3027a8083a030518ba21"
        "01f6f4857ef3c520704dc6c111632789b8dded8b1398d6981a159309b725b3d4"
        "084ec51fced2d4d47a0d96d8")
    r = twt.wt_decompress(fpe, 64, 64, 10)
    assert r is None or (r[1] < 64).any()


# -- the modules --------------------------------------------------------------

def _run_both(tmp: Path, cadus: np.ndarray, jcls, tcls, params=None):
    p = tmp / "x.cadu"
    cadus.tofile(p)
    out = {}
    for name, cls in (("jax", jcls), ("torch", tcls)):
        mod = cls(str(p), str(tmp / name / "x"), dict(
            params or {}, **({"torch_device": "cpu"} if name == "torch"
                             else {})))
        mod.process()
        out[name] = mod
    assert out["torch"].stats == out["jax"].stats
    return out


def test_elektro_jpeg_and_wt_equal_jax(tmp_path, rng):
    """ELEKTRO-L: 8-bit JPEG (ch5) and 10-bit WT (ch9) segments; the JAX
    module decodes the JPEG with Pillow, the port with its own decoder."""
    files, truth = sim.elektro_xrit_files(rng, 3, 96, 16)
    mods = _run_both(tmp_path, sim.xrit_geo_cadus(files),
                     jgeo.ElektroLRITDataDecoderModule,
                     tgeo.ElektroLRITDataDecoderModule)
    assert mods["torch"].stats == {"files": 6, "images": 2}
    _trees_equal(tmp_path / "jax", tmp_path / "torch")
    assert _assert_products_equal(tmp_path) == ["MSU-GS_202601010000"]
    d = tmp_path / "torch" / "IMAGES" / "MSU-GS"
    np.testing.assert_array_equal(
        load_img(d / "MSU-GS_GOMS3_ch9_202601010000.png"), truth["wt"])
    want = np.concatenate([jpeg.decode_jpeg_gray(j, "cpu")
                           for j in truth["jpeg"]])
    np.testing.assert_array_equal(
        load_img(d / "MSU-GS_GOMS3_ch5_202601010000.png"), want)


def test_msg_wt_and_bad_segment_equal_jax(tmp_path, rng):
    """msg_lrit_data_decoder: WT segments assemble, a segment whose WT
    field does not parse is kept raw under WAVELET_RAW, a non-image file
    under FILES."""
    from satdump_tpu_torch.xrit import ImageStructureRecord, build_xrit_file
    files, _ = sim.elektro_xrit_files(rng, 2, 64, 8)
    bad = build_xrit_file(
        "H-000-MSG4__-MSG4________-IR_108___-000001___-202601011200-__",
        b"\x00" * 40, [ImageStructureRecord(bit_per_pixel=10,
                                            columns_count=64, lines_count=8,
                                            compression_flag=1),
                       sim.msg_segment_record(9, 0, 0, 0)])
    admin = build_xrit_file("H-000-MSG4__-ADMIN", b"admin text",
                            [], file_type_code=2)
    mods = _run_both(tmp_path, sim.xrit_geo_cadus(files[2:] + [bad, admin]),
                     jgeo.MSGLRITDataDecoderModule,
                     tgeo.MSGLRITDataDecoderModule)
    assert mods["torch"].stats["images"] == 1
    files_out = _trees_equal(tmp_path / "jax", tmp_path / "torch")
    assert any(f.startswith("WAVELET_RAW") for f in files_out)
    assert any(f.startswith("FILES") for f in files_out)


def test_himawaricast_equals_jax(tmp_path, rng):
    files, img = sim.himawari_xrit_files(rng, 55, 11)
    mods = _run_both(tmp_path, sim.xrit_geo_cadus(files),
                     jgeo.HimawariCastDataDecoderModule,
                     tgeo.HimawariCastDataDecoderModule)
    assert mods["torch"].stats == {"files": 10, "images": 1}
    _trees_equal(tmp_path / "jax", tmp_path / "torch")
    _assert_products_equal(tmp_path)
    got = load_img(tmp_path / "torch" / "IMAGES" / "AHI" /
                   "AHI_3_202601010000.png")
    np.testing.assert_array_equal(got, img << 6)     # 10-bit, shifted 6


def test_himawaricast_from_bbframes_decodes_nothing_in_either_package(
        tmp_path, rng):
    """Himawari.json feeds dvbs2_demod's BBFrames to the decoder, which
    reads its input as 1024-byte CADUs: on BBFrames that carry the same
    CADUs neither package decodes a file (ROADMAP S6, shared)."""
    files, _ = sim.himawari_xrit_files(rng, 55, 11)
    frames = sim.grb_bbframes(sim.xrit_geo_cadus(files))
    mods = _run_both(tmp_path, frames, jgeo.HimawariCastDataDecoderModule,
                     tgeo.HimawariCastDataDecoderModule)
    assert mods["torch"].stats == {"files": 0, "images": 0}


def test_colour_jpeg_segment_is_skipped(tmp_path, rng):
    """A colour JPEG segment: the JAX module raises (Pillow's (H, W, 3)
    does not fit its canvas), the port logs and skips it."""
    from satdump_tpu_torch.xrit import ImageStructureRecord, build_xrit_file
    img = sim.smooth_scene(rng, 16, 64, 8)
    f = build_xrit_file(
        "H-000-GOMS3_-GOMS3________-04_9_076E-000000___-202601010000-__",
        _pil_jpeg(np.stack([img, img[::-1], img], -1)),
        [ImageStructureRecord(bit_per_pixel=8, columns_count=64,
                              lines_count=16, compression_flag=2),
         sim.msg_segment_record(4, 0, 0, 0)])
    sim.xrit_geo_cadus([f]).tofile(tmp_path / "c.cadu")
    with pytest.raises(ValueError):
        jgeo.ElektroLRITDataDecoderModule(str(tmp_path / "c.cadu"),
                                          str(tmp_path / "jax" / "x"),
                                          {}).process()
    mod = tgeo.ElektroLRITDataDecoderModule(str(tmp_path / "c.cadu"),
                                            str(tmp_path / "torch" / "x"),
                                            {"torch_device": "cpu"})
    mod.process()
    assert mod.stats == {"files": 1, "images": 0}
