"""The port's JPEG 2000 decoder (`native/j2k.c` through
`image/j2k.py::decompress_j2k`) against the JAX package's, which decodes
with Pillow (OpenJPEG), and the port's `goes_grb_data_decoder` against the
JAX module on the same .cadu.

Tolerances: reversible (5/3) streams bit for bit; irreversible (9/7) ones
within 1 level, with at least 99 % of the pixels exact (every pixel was
exact on the machine these tests were written on, whose Pillow 12.1 links
OpenJPEG 2.5.4). The GRB products are byte-identical (PNGs compared by
their pixels: the JAX package writes them with Pillow, the port with its own
codec).

The committed codestreams under satdump_tpu_torch/testdata/j2k/ (the card's
machine has no encoder) are made by this file:
`python -m tests.test_torch_j2k_grb --write-fixtures` rewrites them and
their MANIFEST.json (each file's SHA-256, and the SHA-256, dtype and shape
of Pillow's decode of it).
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from satdump_tpu.image.j2k import decompress_j2k as j_decompress
from satdump_tpu.models import goes_grb as jgrb
from satdump_tpu_torch import sim
from satdump_tpu_torch.core.exceptions import FormatError
from satdump_tpu_torch.image import j2k as tj2k
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.models import goes_grb as tgrb

FIXTURES = sim.J2K_TESTDATA
MANIFEST = FIXTURES / "MANIFEST.json"


def _encode(img: np.ndarray, **kw) -> bytes:
    """Pillow's JPEG 2000 encoder (the oracle's own codec)."""
    if img.dtype == np.uint16:
        im = Image.frombytes("I;16", (img.shape[1], img.shape[0]),
                             np.ascontiguousarray(img).tobytes())
    else:
        im = Image.fromarray(img)
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _scene(seed: int, h: int, w: int, depth: int) -> np.ndarray:
    return sim.smooth_scene(np.random.default_rng(seed), h, w, depth)


# (name, shape, bit depth, Pillow's save options): every progression order,
# tiles, layers, resolutions 1-6, code-block and precinct sizes, 8 and 16
# bits, 5/3 and 9/7, JP2 and raw codestreams, an image offset
CASES = [
    ("lrcp_rev8", (48, 64), 8, {}),
    ("rlcp_rev8_raw", (40, 56), 8, dict(progression="RLCP", no_jp2=True)),
    ("rpcl_rev16_prec", (64, 72), 16, dict(progression="RPCL",
                                           precinct_size=(32, 32),
                                           codeblock_size=(16, 16))),
    ("pcrl_rev12_tiles", (70, 90), 12, dict(progression="PCRL",
                                            tile_size=(32, 40))),
    ("cprl_rev8_layers", (33, 47), 8, dict(progression="CPRL",
                                           quality_mode="rates",
                                           quality_layers=[30, 10, 2])),
    ("res1_rev8", (20, 30), 8, dict(num_resolutions=1)),
    ("res2_rev16_cb8", (41, 23), 16, dict(num_resolutions=2,
                                          codeblock_size=(8, 8))),
    ("res4_rev8_offset", (50, 61), 8, dict(num_resolutions=4,
                                           offset=(3, 5),
                                           tile_size=(80, 80))),
    ("res6_rev8_cb32x16", (96, 80), 8, dict(num_resolutions=6,
                                            codeblock_size=(32, 16))),
    ("tiles_offset_rev16", (60, 60), 16, dict(tile_size=(24, 20),
                                              tile_offset=(0, 0),
                                              offset=(5, 2))),
    ("lrcp_irr8", (48, 64), 8, dict(irreversible=True)),
    ("rlcp_irr16_layers", (55, 66), 16, dict(irreversible=True,
                                             progression="RLCP",
                                             quality_mode="rates",
                                             quality_layers=[20, 5])),
    ("rpcl_irr8_tiles", (64, 64), 8, dict(irreversible=True,
                                          progression="RPCL",
                                          tile_size=(32, 32))),
    ("pcrl_irr12_prec", (72, 60), 12, dict(irreversible=True,
                                           progression="PCRL",
                                           precinct_size=(64, 32),
                                           codeblock_size=(16, 16))),
    ("cprl_irr8_res3", (37, 29), 8, dict(irreversible=True,
                                         progression="CPRL",
                                         num_resolutions=3)),
    ("res5_irr16_db", (80, 48), 16, dict(irreversible=True,
                                         num_resolutions=5,
                                         quality_mode="dB",
                                         quality_layers=[40, 60])),
]


def _case_stream(name, shape, depth, kw):
    seed = sum(map(ord, name))
    img = _scene(seed, *shape, depth)
    return img, _encode(img, **kw)


@pytest.mark.parametrize("name,shape,depth,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_equals_jax(name, shape, depth, kw):
    img, data = _case_stream(name, shape, depth, kw)
    want = j_decompress(data)
    got = tj2k.decompress_j2k(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if kw.get("irreversible"):
        assert d.max() <= 1
        assert (d == 0).mean() >= 0.99
    else:
        np.testing.assert_array_equal(got, want)
        # lossless, where Pillow's encoder is: it tiles 16-bit input wrongly
        if "quality_layers" not in kw and not (depth > 8 and "tile_size"
                                               in kw):
            np.testing.assert_array_equal(got, img)
    timed, times = tj2k.decompress_j2k_timed(data)
    np.testing.assert_array_equal(timed, got)
    assert set(times) == {"tier1", "tier2", "idwt"}
    assert all(t >= 0 for t in times.values())


# -- the committed fixtures ---------------------------------------------------

def _grb_blocks():
    """Three 32-row ABI channel-13 blocks at MESO's 2 km width (500
    columns), 12-bit samples in 16-bit reversible J2K as GRB sends them."""
    return [(f"grb_abi_c13_{k}.jp2", _scene(500 + k, 32, 500, 12), {})
            for k in range(3)]


def _gk2a_blocks():
    """GK-2A SW038 segments for sim.gk2a_xrit_files: 32 x 256, 8-bit."""
    return [(f"gk2a_sw038_{k}.j2k", _scene(600 + k, 32, 256, 8),
             dict(no_jp2=True)) for k in range(2)]


def _fixture_specs():
    picked = ("lrcp_rev8", "rlcp_rev8_raw", "rpcl_rev16_prec",
              "pcrl_rev12_tiles", "cprl_rev8_layers", "res1_rev8",
              "res4_rev8_offset", "lrcp_irr8", "rlcp_irr16_layers",
              "pcrl_irr12_prec", "res5_irr16_db")
    out = []
    for name, shape, depth, kw in CASES:
        if name in picked:
            ext = ".j2k" if kw.get("no_jp2") else ".jp2"
            out.append((name + ext, _scene(sum(map(ord, name)), *shape,
                                           depth), kw))
    return out + _grb_blocks() + _gk2a_blocks()


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def write_fixtures() -> None:
    FIXTURES.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for fname, img, kw in _fixture_specs():
        data = _encode(img, **kw)
        (FIXTURES / fname).write_bytes(data)
        ref = j_decompress(data)
        manifest[fname] = {
            "sha256": hashlib.sha256(data).hexdigest(),
            "decoded_sha256": _digest(ref), "dtype": str(ref.dtype),
            "shape": list(ref.shape),
            "options": {k: v for k, v in kw.items()},
            "irreversible": bool(kw.get("irreversible"))}
    MANIFEST.write_text(json.dumps(manifest, indent=1, sort_keys=True)
                        + "\n")


def test_fixtures_match_manifest():
    """Every committed codestream is the one the manifest names, and the
    port's decode of it hashes as Pillow's did."""
    manifest = json.loads(MANIFEST.read_text())
    assert len(manifest) >= 16
    total = 0
    for fname, m in manifest.items():
        data = (FIXTURES / fname).read_bytes()
        total += len(data)
        assert hashlib.sha256(data).hexdigest() == m["sha256"], fname
        got = tj2k.decompress_j2k(data)
        assert [str(got.dtype), list(got.shape)] == [m["dtype"], m["shape"]]
        assert _digest(got) == m["decoded_sha256"], fname
        assert _digest(j_decompress(data)) == m["decoded_sha256"], fname
    assert total <= 256 * 1024


# -- what the decoder refuses -------------------------------------------------

def _with_main_marker(data: bytes, seg: bytes) -> bytes:
    """A raw codestream with marker segment `seg` put before the first
    SOT."""
    i = data.index(b"\xff\x90")
    return data[:i] + seg + data[i:]


def test_refuses_multiple_components():
    rgb = np.stack([_scene(k, 24, 24, 8) for k in range(3)], -1)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG2000", no_jp2=True)
    with pytest.raises(FormatError, match="multiple components"):
        tj2k.decompress_j2k(buf.getvalue())


def test_refuses_roi_and_poc():
    _, data = _case_stream(*CASES[1])
    rgn = b"\xff\x5e" + struct.pack(">HBBB", 5, 0, 0, 3)
    with pytest.raises(FormatError, match="region of interest"):
        tj2k.decompress_j2k(_with_main_marker(data, rgn))
    poc = b"\xff\x5f" + struct.pack(">HBBHBBB", 9, 0, 0, 1, 6, 1, 0)
    with pytest.raises(FormatError, match="POC"):
        tj2k.decompress_j2k(_with_main_marker(data, poc))


@pytest.mark.parametrize("width,height", [
    (1 << 31, 1), ((1 << 32) - 1, 1), (1 << 16, 1 << 16),
    ((1 << 14) + 1, 1 << 12)])
def test_refuses_a_size_above_a_product(width, height):
    """A SIZ that claims more than 2^26 pixels (port only) is refused before
    anything is allocated for it, a width past an int's range included."""
    data = bytearray((FIXTURES / "rlcp_rev8_raw.j2k").read_bytes())
    assert data[:4] == b"\xff\x4f\xff\x51"
    data[8:16] = struct.pack(">II", width, height)      # Xsiz, Ysiz
    with pytest.raises(FormatError, match="pixels taken"):
        tj2k.decompress_j2k(bytes(data))


def test_corrupt_streams_return_an_error(rng):
    """Truncated and bit-flipped codestreams (port only: the oracle is not
    fed corrupt input) raise FormatError or decode; the process survives."""
    for fname in ("lrcp_rev8.jp2", "rpcl_rev16_prec.jp2",
                  "rlcp_irr16_layers.jp2", "grb_abi_c13_0.jp2"):
        data = (FIXTURES / fname).read_bytes()
        outcomes = {"error": 0, "image": 0}
        cases = [data[:n] for n in range(0, len(data), max(len(data) // 40,
                                                           1))]
        for _ in range(60):
            b = bytearray(data)
            for pos in rng.integers(0, len(b), int(rng.integers(1, 6))):
                b[pos] ^= 1 << int(rng.integers(0, 8))
            cases.append(bytes(b))
        cases += [data[:200] + bytes(rng.integers(0, 256, 300)
                                     .astype(np.uint8))]
        for c in cases:
            try:
                tj2k.decompress_j2k(c)
                outcomes["image"] += 1
            except FormatError:
                outcomes["error"] += 1
        assert outcomes["error"] > 0, fname


# -- goes_grb_data_decoder ----------------------------------------------------

def _run_both(tmp: Path, cadus: np.ndarray):
    p = tmp / "grb.cadu"
    cadus.tofile(p)
    out = {}
    for name, cls in (("jax", jgrb.GRBDataDecoderModule),
                      ("torch", tgrb.GRBDataDecoderModule)):
        mod = cls(str(p), str(tmp / name / "x"), {})
        mod.process()
        out[name] = mod
    assert out["torch"].stats == out["jax"].stats
    return out


def _trees_equal(a: Path, b: Path) -> list:
    """Every file under a is under b too, equal (PNGs by their pixels)."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        if rel.suffix == ".png":
            x, y = load_img(a / rel), load_img(b / rel)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return [str(r) for r in fa]


@pytest.mark.parametrize("comp", ["raw", "j2k"])
def test_grb_abi_equals_jax(tmp_path, rng, comp):
    """ABI MESO-1 channel 13 from blocks of 32 rows at 500 columns, raw or
    J2K (the committed fixtures, repeated), plus a GLM flash frame."""
    depth = tgrb.ABI_CHANNEL_PARAMS[13][1]
    names = [f"grb_abi_c13_{k}.jp2" for k in (0, 1, 2, 0)]
    blocks = []
    for n in names:
        cs = sim.j2k_fixture(n)
        rows = tj2k.decompress_j2k(cs)
        blocks.append((cs if comp == "j2k" else None, rows))
    cadus, truth = sim.grb_abi_cadus(rng, blocks)
    mods = _run_both(tmp_path, cadus)
    assert mods["torch"].stats["abi_blocks"] == len(blocks)
    assert mods["torch"].stats["glm"] == 1
    files = _trees_equal(tmp_path / "jax", tmp_path / "torch")
    png = [f for f in files if "ABI_MESO1_13_" in f]
    assert len(png) == 1
    img = load_img(tmp_path / "torch" / png[0])
    n = len(truth["image"])
    np.testing.assert_array_equal(img[:n], truth["image"] << (16 - depth))
    assert not img[n:].any()
    glm = json.loads(next((tmp_path / "torch" / "GLM" / "Flash")
                          .glob("*.json")).read_text())
    assert glm["number_of_flashes"] == 3 and len(glm["records"]) == 3


def _suvi_meta_packets(channels):
    """A SUVI J2K block, SUVI and ABI metadata, the GRB information file
    and raw 16 x 40 MESO-1 blocks of ABI `channels`."""
    pkts, ts = [], 700000000
    gen = bytes([0]) + ts.to_bytes(4, "big") + bytes(16)
    suvi = _scene(7, 40, 64, 12)
    cs = _encode(suvi.astype(np.uint16))
    pkts.append(sim.grb_packet(0x486, 2, sim.grb_image_header(
        ts, 64, 40, 10, 20, 1, len(cs)) + cs))
    pkts.append(sim.grb_packet(0x480, 0, gen + b"<suvi/>"))
    pkts.append(sim.grb_packet(0x580, 0, gen + b"<info/>"))
    for ch in channels:
        apid = 0xD0 + ch - 1
        blk = _scene(ch, 16, 40, 10)
        pkts.append(sim.grb_packet(apid, 2, sim.grb_image_header(
            ts, 40, 16, 0, 0, 0, blk.size * 2) + blk.astype("<u2").tobytes()))
        pkts.append(sim.grb_packet(apid - 0x10, 0, gen + b"<abi/>"))
    return sim.grb_cadus(pkts, 5), suvi


def test_grb_suvi_and_meta_equal_jax(tmp_path):
    """SUVI (J2K, no depth scale), the SUVI and ABI metadata XML and the
    GRB information file."""
    cadus, suvi = _suvi_meta_packets((1, 3))
    mods = _run_both(tmp_path, cadus)
    assert mods["torch"].stats["suvi_blocks"] == 1
    assert mods["torch"].stats["meta"] == 4
    _trees_equal(tmp_path / "jax", tmp_path / "torch")
    img = load_img(next((tmp_path / "torch" / "SUVI" / "Fe094")
                        .glob("*.png")))
    np.testing.assert_array_equal(img[20:60, 10:74], suvi)


def test_grb_rgb135_composite(tmp_path):
    """Channels 1, 3 and 5 of one time make the RGB135 composite. Port only:
    the JAX module raises there, since Pillow writes no 16-bit RGB PNG."""
    cadus, _ = _suvi_meta_packets((1, 3, 5))
    cadus.tofile(tmp_path / "grb.cadu")
    mod = tgrb.GRBDataDecoderModule(str(tmp_path / "grb.cadu"),
                                    str(tmp_path / "x"), {})
    mod.process()
    rgb = load_img(next(tmp_path.rglob("ABI_MESO1_RGB135_*.png")))
    chans = [load_img(next(tmp_path.rglob(f"ABI_MESO1_{c}_*.png")))
             for c in (5, 3, 1)]
    assert rgb.dtype == np.uint16 and rgb.shape == (1000, 1000, 3)
    np.testing.assert_array_equal(rgb, np.stack(chans, -1))


def test_glm_records_equal_jax(rng):
    frame = sim.grb_glm_flash_frame(rng, 4)
    assert tgrb.parse_glm_frame(frame, tgrb.GLM_FLASH) == \
        jgrb.parse_glm_frame(frame, jgrb.GLM_FLASH)
    ev = struct.pack("<Q", 2) + struct.pack("<I4HI", 1, 2, 3, 4, 5, 6) * 2
    gr = struct.pack("<Q", 1) + struct.pack("<I2H2f4H", 9, 1, 2, 3.5, -4.5,
                                            5, 6, 7, 8)
    for kind, data in ((tgrb.GLM_EVENT, ev), (tgrb.GLM_GROUP, gr)):
        assert tgrb.parse_glm_frame(data, kind) == \
            jgrb.parse_glm_frame(data, kind)


if __name__ == "__main__" and "--write-fixtures" in sys.argv:
    write_fixtures()
