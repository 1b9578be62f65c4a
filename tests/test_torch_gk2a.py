"""The port's GK-2A xRIT decoder against the JAX package's, on the CPU, on
the same inputs made from a seed: DES (FIPS 46-3 vector and round trips),
the key files (encrypted and decrypted formats), and
`gk2a_lrit_data_decoder` on a pass of encrypted, 8- and 12-bit JPEG and
J2K segments (one behind the 85-byte UHRIT preamble) and an
additional-data file. The J2K segments are a 12-bit scene at the other
channels' width, encoded by the port's `compress_j2k`, or the committed
codestreams at their own 32 x 256.

Everything is byte-identical (PNGs compared by their pixels). The JAX
module decodes J2K with Pillow, the port with its own decoder
(`native/j2k.c`); both take 8- and 12-bit JPEG through `jpeg12.c` first.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from satdump_tpu.utils.des import DES as JDES
from satdump_tpu.xrit import gk2a as jgk2a
from satdump_tpu_torch import sim
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.image.j2k import decompress_j2k
from satdump_tpu_torch.image.jpeg import decode_jpeg_gray
from satdump_tpu_torch.image.jpeg12 import decompress_jpeg12
from satdump_tpu_torch.utils.des import DES
from satdump_tpu_torch.xrit import gk2a as tgk2a
from tests.test_torch_j2k_grb import _trees_equal


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_des_fips_vector_and_roundtrip(rng):
    d = DES(bytes.fromhex("133457799BBCDFF1"))
    assert d.encrypt_block(bytes.fromhex("0123456789ABCDEF")) == \
        bytes.fromhex("85E813540F0AB405")
    key = bytes(rng.integers(0, 256, 8).astype(np.uint8))
    data = bytes(rng.integers(0, 256, 77).astype(np.uint8))
    assert DES(key).decrypt_ecb(data) == JDES(key).decrypt_ecb(data)
    blk = data[:8]
    assert DES(key).decrypt_block(DES(key).encrypt_block(blk)) == blk


def _encrypted_key_file(rng, mac: str):
    kdes = DES((int(mac, 16) << 16).to_bytes(8, "big"))
    keys = {i + 1: bytes(rng.integers(0, 256, 8).astype(np.uint8))
            for i in range(30)}
    body = b"".join(i.to_bytes(2, "big") + kdes.encrypt_block(k) + bytes(8)
                    for i, k in keys.items())
    raw = bytes(8) + body
    return raw + tgk2a._crc16_ccitt(raw).to_bytes(2, "big"), keys


def test_key_files_equal_jax(tmp_path, rng):
    mac = "0123456789AB"
    raw, keys = _encrypted_key_file(rng, mac)
    assert tgk2a.decrypt_key_file(raw, mac) == keys
    assert tgk2a.decrypt_key_file(raw, mac) == jgk2a.decrypt_key_file(raw,
                                                                      mac)
    p = tmp_path / "enc.bin"
    p.write_bytes(raw)
    assert tgk2a.load_key_file(str(p), mac) == jgk2a.load_key_file(str(p),
                                                                   mac)
    with pytest.raises(ValueError, match="CRC"):
        tgk2a.decrypt_key_file(raw[:-1] + b"\0", mac)
    _, keyfile, _ = sim.gk2a_xrit_files(rng, 16, 8)
    p.write_bytes(keyfile)
    assert tgk2a.load_key_file(str(p)) == jgk2a.load_key_file(str(p))


def _pass(tmp: Path, rng, with_keys: bool, width: int = 256,
          sw038: str = "encode"):
    files, keyfile, truth = sim.gk2a_xrit_files(rng, width, 32,
                                                sw038=sw038)
    (tmp / "keys.bin").write_bytes(keyfile)
    cadus = sim.xrit_geo_cadus(files)
    cadus.tofile(tmp / "x.cadu")
    params = {"gk2a_keys": str(tmp / "keys.bin")} if with_keys else {}
    mods = {}
    for name, cls in (("jax", jgk2a.GK2ALRITDataDecoderModule),
                      ("torch", tgk2a.GK2ALRITDataDecoderModule)):
        extra = {"torch_device": "cpu"} if name == "torch" else {}
        mods[name] = cls(str(tmp / "x.cadu"), str(tmp / name / "x"),
                         dict(params, **extra))
        mods[name].process()
    assert mods["torch"].stats == mods["jax"].stats
    return mods, truth


def test_gk2a_pass_equals_jax(tmp_path, rng):
    mods, truth = _pass(tmp_path, rng, True)
    assert mods["torch"].stats == {"files": 9, "images": 4}
    files = _trees_equal(tmp_path / "jax", tmp_path / "torch")
    assert "ADD/ANT_20260101_000000.txt" in files
    d = tmp_path / "torch" / "IMAGES" / "AMI"
    np.testing.assert_array_equal(load_img(d / "AMI_WV069_20260101000000.png"),
                                  truth["wv069"])
    # SW038: the 12-bit scene sent, at the decoder's 16-bit scale
    sw = load_img(d / "AMI_SW038_20260101000000.png")
    assert truth["sw038"].shape == (64, 256) and truth["sw038"].max() > 255
    np.testing.assert_array_equal(sw, truth["sw038"] << 4)
    np.testing.assert_array_equal(
        sw, np.concatenate([decompress_j2k(c) for c in truth["j2k"]]) << 4)
    np.testing.assert_array_equal(
        load_img(d / "AMI_VI006_20260101000000.png"),
        np.concatenate([decompress_jpeg12(j) for j in truth["jpeg8"]]))
    np.testing.assert_array_equal(
        load_img(d / "AMI_IR105_20260101000000.png"),
        np.concatenate([decompress_jpeg12(j) for j in truth["jpeg12"]]))


def test_gk2a_channels_wider_than_the_j2k_segments(tmp_path, rng):
    """The JPEG and raw channels at 600 columns, SW038 the committed
    codestreams at their 256: each channel's image takes its own segments'
    width."""
    mods, truth = _pass(tmp_path, rng, True, width=600, sw038="fixtures")
    assert mods["torch"].stats == {"files": 9, "images": 4}
    _trees_equal(tmp_path / "jax", tmp_path / "torch")
    d = tmp_path / "torch" / "IMAGES" / "AMI"
    np.testing.assert_array_equal(
        load_img(d / "AMI_SW038_20260101000000.png"),
        np.concatenate([decompress_j2k(c) for c in truth["j2k"]]))
    assert truth["sw038"] is None
    np.testing.assert_array_equal(load_img(d / "AMI_WV069_20260101000000.png"),
                                  truth["wv069"])
    assert truth["wv069"].shape == (64, 600)


def test_gk2a_without_keys_keeps_encrypted_files(tmp_path, rng):
    mods, _ = _pass(tmp_path, rng, False)
    assert mods["torch"].stats == {"files": 9, "images": 3}
    files = _trees_equal(tmp_path / "jax", tmp_path / "torch")
    assert sum(f.startswith("LRIT_ENCRYPTED") for f in files) == 2


def test_gk2a_jpeg_fallback_to_the_baseline_decoder(tmp_path, rng):
    """A grayscale JPEG whose SOF names 2x2 sampling: jpeg12.c refuses it,
    the JAX module decodes it with Pillow, the port with its own decoder.
    A progressive segment: the JAX module decodes it with Pillow, the port
    logs and skips it (its decoder takes baseline streams only)."""
    import io
    from PIL import Image

    from satdump_tpu_torch.xrit import ImageStructureRecord, build_xrit_file
    img = sim.smooth_scene(rng, 32, 64, 8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc0")
    data[sof + 11] = 0x22
    data = bytes(data)
    prog = io.BytesIO()
    Image.fromarray(img).save(prog, "JPEG", progressive=True)
    assert decompress_jpeg12(data) is None
    files = [build_xrit_file(
        f"IMG_FD_xx_{ch}_20260101_000000_000.lrit", payload,
        [ImageStructureRecord(bit_per_pixel=8, columns_count=64,
                              lines_count=32, compression_flag=2),
         sim.gk2a_segment_record(0, 1)])
        for ch, payload in (("VI008", data), ("NR013", prog.getvalue()))]
    sim.xrit_geo_cadus(files).tofile(tmp_path / "x.cadu")
    mods = {}
    for name, cls in (("jax", jgk2a.GK2ALRITDataDecoderModule),
                      ("torch", tgk2a.GK2ALRITDataDecoderModule)):
        mods[name] = cls(str(tmp_path / "x.cadu"), str(tmp_path / name / "x"),
                         {"torch_device": "cpu"} if name == "torch" else {})
        mods[name].process()
    # the JAX module decodes the progressive segment too (Pillow): the
    # port skips it, a divergence on inputs Pillow takes
    assert mods["jax"].stats == {"files": 2, "images": 2}
    assert mods["torch"].stats == {"files": 2, "images": 1}
    name = "IMAGES/AMI/AMI_VI008_20260101000000.png"
    np.testing.assert_array_equal(load_img(tmp_path / "torch" / name),
                                  load_img(tmp_path / "jax" / name))
    np.testing.assert_array_equal(load_img(tmp_path / "torch" / name),
                                  decode_jpeg_gray(data, "cpu"))
