"""The port's image level against satdump_tpu's on the CPU: the PNG codec
(against Pillow, which the port does not use), the post ops of
image/processing.py, the histogram edges and the percentile, and the
expression evaluator (every operator and function), all on the same
seeded inputs.

Tolerances, and why:
* PNG: none, on decoded pixels (file bytes differ: Pillow filters rows
  adaptively, the port writes filter 0);
* post ops, edges, percentile and the exact expression operators: none,
  bit for bit;
* the expression functions whose float32 result XLA computes with its own
  code (sqrt, exp, log, log10, sin, cos, tan, atan2, pow with a fractional
  exponent) or with a fused multiply-add (a product plus a term): each
  value in [0, 1] within 4 ulp of 1.0 (4.8e-7) of the JAX package's, and
  the 8-bit composite at most 1 LSB apart on at most 0.01 % of its pixels.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from satdump_tpu.image import expression as jexpr
from satdump_tpu.image import processing as jproc
from satdump_tpu.products.image_product import ImageProduct as JProduct
from satdump_tpu_torch.core.exceptions import FormatError, SatdumpError
from satdump_tpu_torch.image import expression as texpr
from satdump_tpu_torch.image import processing as tproc
from satdump_tpu_torch.image.png import decode_png, encode_png, load_png
from satdump_tpu_torch.products.image_product import ImageProduct as TProduct

CPU = "cpu"


def _img(rng, shape, dtype):
    top = 256 if dtype == np.uint8 else 65536
    return rng.integers(0, top, shape).astype(dtype)


def assert_pixels_close(got, ref, cause: str):
    """At most 1 LSB apart on at most 0.01 % of the pixels, for `cause`."""
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max(initial=0) <= 1, (cause, d.max())
    assert (d > 0).mean() <= 1e-4, (cause, (d > 0).mean())


# -- PNG codec ---------------------------------------------------------------

PNG_CASES = [((13, 17), np.uint8), ((13, 17), np.uint16),
             ((9, 11, 2), np.uint8), ((9, 11, 3), np.uint8),
             ((9, 11, 3), np.uint16), ((9, 11, 4), np.uint8),
             ((9, 11, 4), np.uint16), ((1, 1), np.uint8)]


@pytest.mark.parametrize("shape,dtype", PNG_CASES)
def test_png_round_trip_and_pillow_reads_it(shape, dtype, rng):
    a = _img(rng, shape, dtype)
    data = encode_png(a)
    b = decode_png(data)
    assert b.dtype == a.dtype and np.array_equal(b, a)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    if dtype == np.uint16 and a.ndim == 3:
        # Pillow reads 16-bit RGB/RGBA as their high bytes
        assert np.array_equal(pil, (a >> 8).astype(np.uint8))
    else:
        assert np.array_equal(pil, a)


@pytest.mark.parametrize("shape,dtype", [((40, 50), np.uint8),
                                         ((40, 50), np.uint16),
                                         ((30, 41, 3), np.uint8),
                                         ((30, 41, 4), np.uint8),
                                         ((30, 41, 2), np.uint8)])
def test_png_reads_pillow_files(shape, dtype, rng, tmp_path):
    """Pillow's adaptive filters: smooth content so that several filter
    types appear."""
    y, x = np.indices(shape[:2])
    base = (y * 7 + x * 3) % (256 if dtype == np.uint8 else 65536)
    a = base if len(shape) == 2 else np.stack(
        [(base + 40 * c) % 256 for c in range(shape[2])], -1)
    a = (a + rng.integers(0, 3, a.shape)).astype(dtype)
    Image.fromarray(a).save(tmp_path / "p.png")
    assert np.array_equal(load_png(tmp_path / "p.png"), a)


def _filtered_png(a: np.ndarray, ftypes, n_idat: int) -> bytes:
    """A PNG whose rows use the given filter types, its zlib stream split
    over n_idat IDAT chunks (a test encoder for the reader)."""
    h = a.shape[0]
    c = 1 if a.ndim == 2 else a.shape[2]
    bpp = c * a.itemsize
    rows = a.astype(">u2" if a.itemsize == 2 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1).astype(np.int64)
    prev = np.zeros(rows.shape[1], np.int64)
    out = []
    for y in range(h):
        r, t = rows[y], ftypes[y % len(ftypes)]
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if t == 0:
            pred = 0
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([t]) + ((r - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = r
    z = zlib.compress(b"".join(out))
    cuts = np.linspace(0, len(z), n_idat + 1).astype(int)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body)))
    ihdr = struct.pack(">IIBBBBB", a.shape[1], h, 8 * a.itemsize, ctype, 0,
                       0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + b"".join(chunk(b"IDAT", z[lo:hi])
                       for lo, hi in zip(cuts[:-1], cuts[1:]))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftypes", [[1], [2], [3], [4], [0, 1, 2, 3, 4],
                                    [4, 3, 2, 1, 0, 2]])
@pytest.mark.parametrize("shape,dtype", [((12, 19, 3), np.uint8),
                                         ((11, 14), np.uint16)])
def test_png_reader_undoes_every_filter(ftypes, shape, dtype, rng):
    a = _img(rng, shape, dtype)
    data = _filtered_png(a, ftypes, n_idat=3)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), a)
    assert np.array_equal(decode_png(data), a)


def test_png_reader_refuses_interlaced_and_corrupt(rng):
    data = bytearray(_filtered_png(_img(rng, (4, 4), np.uint8), [0], 1))
    # set the interlace byte of IHDR (offset 8 + 8 + 12) and fix its CRC
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(FormatError, match="interlaced"):
        decode_png(bytes(data))
    good = _filtered_png(_img(rng, (4, 4), np.uint8), [0], 1)
    with pytest.raises(FormatError, match="CRC"):
        decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(FormatError):
        encode_png(np.zeros((2, 2), np.float32))


# -- post ops ----------------------------------------------------------------

IMAGES = [((37, 53), np.uint8), ((37, 53), np.uint16),
          ((29, 31, 3), np.uint8), ((29, 31, 3), np.uint16)]
POST_OPS = {
    "equalize": (lambda m, x: m.equalize(x)),
    "equalize_per_channel": (lambda m, x: m.equalize(x, per_channel=True)),
    "white_balance": (lambda m, x: m.white_balance(x)),
    "white_balance_2pc": (lambda m, x: m.white_balance(x, 0.02)),
    "linear_invert": (lambda m, x: m.linear_invert(x)),
    "normalize": (lambda m, x: m.normalize(x)),
    "median_blur": (lambda m, x: m.median_blur(x, 3)),
    "median_blur_5": (lambda m, x: m.median_blur(x, 5)),
    "despeckle": (lambda m, x: m.despeckle(x)),
    "brightness_contrast": (lambda m, x: m.brightness_contrast(x, 0.3, 0.2)),
    "brightness_contrast_neg": (
        lambda m, x: m.brightness_contrast(x, -0.4, -0.5)),
}


def _on_cpu(fn):
    """The port's module with every op on the CPU."""
    class M:
        def __getattr__(self, name):
            f = getattr(tproc, name)
            return lambda *a, **k: f(*a, device=CPU, **k)
    return fn(M())


@pytest.mark.parametrize("op", sorted(POST_OPS))
@pytest.mark.parametrize("shape,dtype", IMAGES,
                         ids=["gray8", "gray16", "rgb8", "rgb16"])
def test_post_op_matches_jax(op, shape, dtype, rng):
    img = _img(rng, shape, dtype)
    # a skewed histogram, so that equalize and white balance move pixels
    img = (img.astype(np.float64) ** 2 / img.max()).astype(dtype)
    ref = POST_OPS[op](jproc, img)
    got = _on_cpu(lambda m: POST_OPS[op](m, img))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("lut_dtype", [np.uint8, np.uint16, np.float64])
@pytest.mark.parametrize("rgb", [False, True])
def test_apply_lut_matches_jax(lut_dtype, rgb, rng):
    img = _img(rng, (23, 19), np.uint8)
    shape = (256, 3) if rgb else (200,)
    lut = (rng.random(shape) * (255 if lut_dtype == np.uint8 else 60000)
           ).astype(lut_dtype)
    ref = jproc.apply_lut(img, lut)
    got = tproc.apply_lut(img, lut, device=CPU)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_histogram_edges_bit_for_bit():
    edges = tproc.histogram_edges(CPU).numpy()
    ref = np.asarray(jnp.linspace(0.0, 1.0, 1025, dtype=jnp.float32))
    assert edges.dtype == np.float32
    assert edges.view(np.uint32).tolist() == ref.view(np.uint32).tolist()
    _, hist_edges = jnp.histogram(jnp.zeros(4, jnp.float32), bins=1024,
                                  range=(0.0, 1.0))
    assert np.array_equal(np.asarray(hist_edges).view(np.uint32),
                          edges.view(np.uint32))


@pytest.mark.parametrize("n", [7, 100, 1031, 65536, 100003])
@pytest.mark.parametrize("p", [0.05 * 100, 100 - 0.05 * 100, 2.0, 50.0,
                               99.9, 0.0, 100.0])
def test_percentile_matches_jnp(n, p, rng):
    gray = (rng.random((1, n)) ** 3).astype(np.float32)
    ref = np.asarray(jnp.percentile(gray, p, axis=(0, 1), keepdims=True))
    got = tproc._percentile(torch.from_numpy(gray), p).numpy()
    assert got.reshape(-1).view(np.uint32).tolist() == \
        ref.reshape(-1).view(np.uint32).tolist()
    rgb = rng.random((n, 1, 3)).astype(np.float32)
    ref = np.asarray(jnp.percentile(rgb, p, axis=(0, 1), keepdims=True))
    got = tproc._percentile(torch.from_numpy(rgb), p).numpy()
    assert got.reshape(-1).view(np.uint32).tolist() == \
        ref.reshape(-1).view(np.uint32).tolist()


def test_post_ops_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    with pytest.raises(SatdumpError, match="cuda"):
        tproc.equalize(np.zeros((4, 4), np.uint8))
    with pytest.raises(SatdumpError, match="cuda"):
        texpr.compile_expression("ch1")({"ch1": np.zeros((2, 2))})


# -- expressions -------------------------------------------------------------

EXACT_EXPRS = [
    "ch1 + ch2", "ch1 - ch2", "ch1 * ch2", "ch1 / (ch2 + 0.5)",
    "ch1 / 3.0", "3.0 / (ch1 + 1.0)", "(ch1 + 0.25) / (2.0 + 1.5)",
    "ch1 % 0.3", "(ch1 - 0.5) % 0.7", "-ch1 + 1", "+ch2", "1.0 - ch1",
    "ch1 < ch2", "ch1 <= 0.5", "ch1 > ch2", "ch1 >= 0.5", "ch1 == ch1",
    "ch1 != ch2", "ch1 if ch1 > 0.5 else ch2", "0.2 if ch1 > 0.5 else 0.9",
    "min(ch1, ch2, 0.7)", "max(ch1, 0.2)", "max(ch1)", "abs(ch1 - ch2)",
    "clamp(ch1 * 2, 0.2, 0.8)", "floor(ch1 * 10) / 10",
    "ceil(ch1 * 10) / 10", "where(ch1 > 0.5, ch1, ch2)",
    "where(ch1 - 0.5, 1.0, 0.0)", "ch1 ** 2", "pow(ch1, 2.0)",
    "pow(ch1, 3)", "ch2, ch2, ch1", "ch1, 0.5, 1 - ch2", "0.5", "0.25 * 2",
    "2 ** 2 * ch1 / 4", "sqrt(4.0) * ch1 / 2",
    "(ch2 - ch1) / max(ch2 + ch1, 0.001)",
]
# expression -> the reason its float32 result may differ in the last bit
LAST_BIT_EXPRS = {
    "sqrt(ch1)": "XLA's sqrt",
    "exp(ch1) - 1": "XLA's exp",
    "log(ch1 + 1)": "XLA's log",
    "log10(ch1 * 9 + 1)": "XLA's log",
    "sin(ch1 * 3)": "XLA's sin",
    "cos(ch1 * 3)": "XLA's cos",
    "tan(ch1)": "XLA's tan",
    "atan2(ch1 - 0.5, ch2 - 0.5) + 0.5": "XLA's atan2",
    "pow(ch1, 1.5)": "XLA's pow",
    "ch1 ** 0.5": "XLA's pow",
    "ch1 * ch2 + 0.1": "XLA's fused multiply-add",
    "ch1 * 0.5 + ch2 * 0.5": "XLA's fused multiply-add",
}


def _channels(rng, shape=(61, 67)):
    return {"ch1": rng.random(shape).astype(np.float32),
            "ch2": rng.random(shape).astype(np.float32)}


def _products(rng, shapes, bit_depth=16):
    """The same uint16 channels as an ImageProduct of each package."""
    out = []
    imgs = {n: rng.integers(0, 1 << bit_depth, s).astype(np.uint16)
            for n, s in shapes.items()}
    for cls in (JProduct, TProduct):
        p = cls()
        p.instrument_name = "test"
        for n, img in imgs.items():
            p.add_channel(img, n, bit_depth=bit_depth)
        out.append(p)
    return out


@pytest.mark.parametrize("expr", EXACT_EXPRS)
def test_expression_exact_ops_match_jax(expr, rng):
    env = _channels(rng)
    ref = jexpr.compile_expression(expr)(env)
    got = texpr.compile_expression(expr, device=CPU)(env)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    jp, tp = _products(rng, {"1": (31, 29), "2": (31, 29)})
    if "ch" not in expr:       # no channel: neither package has a shape
        with pytest.raises(StopIteration):
            jexpr.generate_composite(jp, expr)
        with pytest.raises(StopIteration):
            texpr.generate_composite(tp, expr, device=CPU)
        return
    for bits in (8, 16):
        assert np.array_equal(
            texpr.generate_composite(tp, expr, bits, device=CPU),
            jexpr.generate_composite(jp, expr, bits))


@pytest.mark.parametrize("expr", sorted(LAST_BIT_EXPRS))
def test_expression_functions_match_jax_to_the_last_bit(expr, rng):
    env = _channels(rng)
    ref = jexpr.compile_expression(expr)(env)
    got = texpr.compile_expression(expr, device=CPU)(env)
    assert np.abs(got - ref).max() <= 4 * np.finfo(np.float32).eps, \
        LAST_BIT_EXPRS[expr]
    jp, tp = _products(rng, {"1": (211, 223), "2": (211, 223)})
    assert_pixels_close(texpr.generate_composite(tp, expr, device=CPU),
                        jexpr.generate_composite(jp, expr),
                        LAST_BIT_EXPRS[expr])


def test_no_division_by_a_python_number(rng, monkeypatch):
    """Post ops and composites divide by tensors only: PyTorch's CUDA
    kernel multiplies by the reciprocal of a Python-number divisor, so such
    a division could differ between the card and the CPU."""
    def guarded(op):
        def f(a, b):
            if isinstance(b, (int, float)):
                raise AssertionError(f"tensor {op} Python number {b}")
            return getattr(torch.Tensor, "_" + op)(a, b)
        return f
    monkeypatch.setattr(torch.Tensor, "_truediv", torch.Tensor.__truediv__,
                        raising=False)
    monkeypatch.setattr(torch.Tensor, "_rtruediv", torch.Tensor.__rtruediv__,
                        raising=False)
    monkeypatch.setattr(torch.Tensor, "__truediv__", guarded("truediv"))
    monkeypatch.setattr(torch.Tensor, "__rtruediv__", guarded("rtruediv"))
    for shape, dtype in IMAGES:
        img = _img(rng, shape, dtype)
        for op in POST_OPS.values():
            _on_cpu(lambda m: op(m, img))
    _, tp = _products(rng, {"1": (31, 29), "2": (31, 29)})
    for expr in ("ch1 / 3.0", "3.0 / (ch1 + 1.0)", "ch2 / (ch1 + 0.5)"):
        texpr.generate_composite(tp, expr, device=CPU)


@pytest.mark.parametrize("bad", ["ch9", "foo(ch1)", "'a'", "ch1 < 2 < 3",
                                 "0.3 < 0.5", "ch1[0]"])
def test_expression_errors(bad, rng):
    env = _channels(rng)
    with pytest.raises(Exception):
        jexpr.compile_expression(bad)(env)
    with pytest.raises(Exception):
        texpr.compile_expression(bad, device=CPU)(env)


def test_expression_unequal_channels_through_bilinear(rng):
    """Channels of unequal size are resampled onto the largest used one,
    by scale ratio with no transforms and through an affine transform."""
    from satdump_tpu.products.image_product import ChannelTransform as JCT
    from satdump_tpu_torch.products.image_product import ChannelTransform as TCT
    jp, tp = _products(rng, {"1": (40, 60), "2": (20, 30), "3": (13, 17)},
                       bit_depth=12)
    for expr in ("ch1, ch2, ch3", "(ch2 - ch3) * 0.5 + 0.5", "ch3"):
        assert np.array_equal(texpr.generate_composite(tp, expr, device=CPU),
                              jexpr.generate_composite(jp, expr))
    jp.images[1].ch_transform = JCT.affine(0.5, 0.5, 1.0, -2.0)
    tp.images[1].ch_transform = TCT.affine(0.5, 0.5, 1.0, -2.0)
    assert np.array_equal(
        texpr.generate_composite(tp, "ch1, ch2, ch1", 16, device=CPU),
        jexpr.generate_composite(jp, "ch1, ch2, ch1", 16))
