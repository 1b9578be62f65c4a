"""The port's JPEG 2000 encoder (`native/j2k.c::j2k_encode` through
`image/j2k.py::compress_j2k`) against the JAX package's `compress_j2k`,
which encodes with Pillow (OpenJPEG 2.5.4 here).

What is held, and why:
* lossless (5/3) streams decode to the input exactly in the port's decoder,
  in Pillow and in the JAX `decompress_j2k`;
* the SIZ, COD and QCD segments equal those of the JAX package's stream of
  the same image (the bytes need not: Pillow adds a COM segment);
* 9/7: Pillow's decode of the port's stream within 1 level of the port's
  decode, and its error against the input no larger than Pillow's own 9/7
  round trip's on that image plus 1 level (the two encoders quantize the
  same step sizes; OpenJPEG's forward transform rounds otherwise);
* the shapes, dtypes and container where JAX raises FormatError raise it.
"""

import io

import numpy as np
import pytest
from PIL import Image

from satdump_tpu.core.exceptions import FormatError as JFormatError
from satdump_tpu.image import j2k as jj2k
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import FormatError
from satdump_tpu_torch.image import j2k as tj2k

SHAPES = [(32, 2200), (32, 500), (7, 5), (1, 64), (65, 33)]


def _image(shape, dtype, depth, seed):
    rng = np.random.default_rng(seed)
    if min(shape) < 8:
        return rng.integers(0, 1 << depth, shape).astype(dtype)
    return sim.smooth_scene(rng, *shape, depth).astype(dtype)


def _pil_decode(data: bytes) -> np.ndarray:
    a = np.asarray(Image.open(io.BytesIO(data)))
    if a.dtype == np.int32:
        a = np.clip(a, 0, 65535).astype(np.uint16)
    return a


def _segments(data: bytes) -> dict:
    """{marker hex: segment body} of the main header."""
    i = data.find(b"\xff\x4f") + 2
    out = {}
    while data[i:i + 2] != b"\xff\x90":
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out[data[i:i + 2].hex()] = data[i + 4:i + 2 + n]
        i += 2 + n
    return out


@pytest.mark.parametrize("dtype,depth", [(np.uint8, 8), (np.uint16, 16),
                                         (np.uint16, 12)],
                         ids=["8bit", "16bit", "12in16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossless_round_trip_in_three_decoders(shape, dtype, depth):
    img = _image(shape, dtype, depth, 40 + shape[0] + depth)
    data = tj2k.compress_j2k(img)
    assert data[:8].hex() == "0000000c6a502020"       # the JP2 signature box
    for got in (tj2k.decompress_j2k(data), _pil_decode(data),
                jj2k.decompress_j2k(data)):
        assert got.dtype == img.dtype and got.shape == img.shape
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("shape", [(32, 500), (7, 5), (65, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossless_full_range_noise(shape):
    """Uniform noise over the whole 16-bit range: the high bands' most
    magnitude bit planes (Mb = precision + gain + guard bits - 1)."""
    img = np.random.default_rng(41).integers(0, 65536, shape).astype(
        np.uint16)
    img[0, :2] = (0, 65535)
    data = tj2k.compress_j2k(img)
    np.testing.assert_array_equal(tj2k.decompress_j2k(data), img)
    np.testing.assert_array_equal(_pil_decode(data), img)


@pytest.mark.parametrize("value", [0, 128, 255])
def test_constant_images_and_empty_packets(value):
    """A flat image leaves every high band zero: their packets are empty
    (one 0 bit) and the code-blocks never included."""
    img = np.full((40, 70), value, np.uint8)
    for lossless in (True, False):
        data = tj2k.compress_j2k(img, lossless=lossless)
        np.testing.assert_array_equal(tj2k.decompress_j2k(data), img)
        np.testing.assert_array_equal(_pil_decode(data), img)


@pytest.mark.parametrize("lossless", [True, False], ids=["53", "97"])
@pytest.mark.parametrize("dtype,depth", [(np.uint8, 8), (np.uint16, 16)],
                         ids=["8bit", "16bit"])
@pytest.mark.parametrize("shape", SHAPES + [(16, 16), (2, 2), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_main_header_segments_equal_pillows(shape, dtype, depth, lossless):
    """SIZ, COD (levels included: min(5, floor(log2(min(h, w))))) and QCD
    equal the JAX package's (Pillow's) for the same image; no COM."""
    img = _image(shape, dtype, depth, 42)
    a = tj2k.compress_j2k(img, lossless=lossless)
    b = jj2k.compress_j2k(img, lossless=lossless)
    ours, theirs = _segments(a), _segments(b)
    for m in ("ff51", "ff52", "ff5c"):
        assert ours[m] == theirs[m], (m, ours[m].hex(), theirs[m].hex())
    assert "ff64" not in ours
    # the JP2 boxes ahead of the codestream (up to jp2c's length) too
    assert a[:a.find(b"jp2c") - 4] == b[:b.find(b"jp2c") - 4]


@pytest.mark.parametrize("dtype,depth", [(np.uint8, 8), (np.uint16, 16),
                                         (np.uint16, 12)],
                         ids=["8bit", "16bit", "12in16"])
@pytest.mark.parametrize("shape", [(32, 2200), (32, 500), (65, 33),
                                   (100, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_irreversible_within_pillows_error(shape, dtype, depth):
    img = _image(shape, dtype, depth, 43 + depth)
    data = tj2k.compress_j2k(img, lossless=False)
    ours = tj2k.decompress_j2k(data).astype(np.int64)
    pil = _pil_decode(data).astype(np.int64)
    assert np.abs(ours - pil).max() <= 1
    own = _pil_decode(jj2k.compress_j2k(img, lossless=False)).astype(
        np.int64)
    own_err = np.abs(own - img).max()
    assert np.abs(pil - img).max() <= own_err + 1
    assert np.abs(ours - img).max() <= own_err + 1


def test_uhrit_preamble_retry():
    """xrit/gk2a.py retries a payload at byte 85 (UHRIT's preamble): a JP2
    file behind 85 bytes decodes there."""
    img = _image((32, 256), np.uint16, 12, 44)
    payload = bytes(85) + tj2k.compress_j2k(img)
    with pytest.raises(FormatError):
        tj2k.decompress_j2k(payload)
    np.testing.assert_array_equal(tj2k.decompress_j2k(payload[85:]), img)


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4), np.int16), np.zeros((4, 4), np.float32),
    np.zeros((4, 4), np.uint32), np.zeros((2, 4, 4), np.uint8),
    np.zeros(16, np.uint8), np.zeros((4, 4, 3), np.uint16),
    np.zeros((4, 4), ">u2")],
    ids=["int16", "float32", "uint32", "stack", "1d", "rgb", "big_endian"])
def test_refuses_what_jax_refuses(bad):
    with pytest.raises(JFormatError):
        jj2k.compress_j2k(bad)
    with pytest.raises(FormatError):
        tj2k.compress_j2k(bad)


def test_strided_views():
    """A Fortran-ordered or strided uint16 view encodes its values."""
    img = _image((33, 47), np.uint16, 16, 45)
    for v in (np.asfortranarray(img), np.concatenate([img, img], 1)[:, ::2]):
        data = tj2k.compress_j2k(v)
        np.testing.assert_array_equal(tj2k.decompress_j2k(data), v)
