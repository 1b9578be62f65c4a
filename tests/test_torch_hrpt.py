"""The port's HRPT riders against the JAX package's, on the CPU, on the same
inputs made from a seed: `codings_misc` (Manchester, LFSR, SimpleDeframer,
HDLC), the NOAA TIP readers (`noaa_tip`), `PunctiformProduct`, the NOAA
HRPT / GAC / DSB decoders and `noaa_instruments`, and the METEOR HRPT
decoder and `meteor_instruments`.

Everything here is host NumPy in both packages, so there is no tolerance:
frames, .frm / .cadu / .tip files, reader outputs and products (channel
pixels, product.json, product.cbor, dataset.json) are equal. METEOR's
timestamps read the wall clock's year unless `year_override` is given, so
both packages get one.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from satdump_tpu.models import meteor_hrpt as jmh
from satdump_tpu.models import noaa_hrpt as jnh
from satdump_tpu.models import noaa_tip as jtip
from satdump_tpu.ops.fec import codings_misc as jcm
from satdump_tpu.products.product import load_product as jload
from satdump_tpu.products.punctiform_product import PunctiformProduct as JPP
from satdump_tpu_torch import sim
from satdump_tpu_torch.models import meteor_hrpt as tmh
from satdump_tpu_torch.models import noaa_hrpt as tnh
from satdump_tpu_torch.models import noaa_tip as ttip
from satdump_tpu_torch.ops.fec import codings_misc as tcm
from satdump_tpu_torch.products.product import load_product as tload
from satdump_tpu_torch.products.punctiform_product import \
    PunctiformProduct as TPP


def _run_both(tmp: Path, src: Path, jcls, tcls, params: dict) -> dict:
    """One module of each package on `src`, each writing beside its own
    output hint; returns {"jax": module, "torch": module}."""
    out = {}
    for name, cls in (("jax", jcls), ("torch", tcls)):
        (tmp / name).mkdir(parents=True, exist_ok=True)
        mod = cls(str(src), str(tmp / name / "pass"), dict(params))
        mod.process()
        out[name] = mod
    return out


def _assert_products_equal(tmp: Path) -> list:
    """dataset.json, and each product's product.json, product.cbor and
    channel images, equal between tmp/jax and tmp/torch."""
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
        for a, b in zip(getattr(jp, "images", []), getattr(tp, "images", [])):
            assert b.channel_name == a.channel_name
            assert b.image.dtype == a.image.dtype, (rel, a.channel_name)
            np.testing.assert_array_equal(b.image, a.image)
    return products


# -- codings_misc -------------------------------------------------------------

def test_manchester_and_lfsr_equal_jax(rng):
    bits = rng.integers(0, 2, (3, 257)).astype(np.uint8)
    chips = tcm.manchester_encode(bits)
    np.testing.assert_array_equal(chips, jcm.manchester_encode(bits))
    np.testing.assert_array_equal(tcm.manchester_decode(chips), bits)
    noisy = chips[0].copy()
    noisy[rng.integers(0, noisy.size, 40)] ^= 1
    for off in (0, 1):
        assert tcm.manchester_phase(noisy[off:]) == \
            jcm.manchester_phase(noisy[off:])
        np.testing.assert_array_equal(tcm.manchester_decode(noisy, off),
                                      jcm.manchester_decode(noisy, off))
    for mask, seed, n in ((0x21, 0x1F, 6), (0x4001, 0x5A5A, 15)):
        np.testing.assert_array_equal(tcm.LFSR(mask, seed, n).sequence(999),
                                      jcm.LFSR(mask, seed, n).sequence(999))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_simple_deframer_equals_jax(rng, soft):
    """TIP frames behind random bits, a few sync bits flipped, fed in
    uneven blocks so frames straddle the calls."""
    frames = sim.tip_frames(rng, 9)
    bits = np.concatenate([rng.integers(0, 2, 301).astype(np.uint8),
                           np.unpackbits(frames.reshape(-1))])
    bits[301 + 832 * 3 + 5] ^= 1
    data = (bits.astype(np.int16) * 180 - 90).astype(np.int8) if soft \
        else bits
    d_t = tcm.SimpleDeframer(0xEDE2, 16, 832, 1, soft_bits_in=soft)
    d_j = jcm.SimpleDeframer(0xEDE2, 16, 832, 1, soft_bits_in=soft)
    got_t, got_j = [], []
    for a, b in ((0, 1000), (1000, 4321), (4321, len(data))):
        got_t += d_t.work(data[a:b])
        got_j += d_j.work(data[a:b])
    assert len(got_t) == len(got_j) == 9
    for t, j in zip(got_t, got_j):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(np.stack(got_t),
                                  np.packbits(bits[301:]).reshape(9, 104))


def _hdlc_bits(payload: bytes) -> np.ndarray:
    """payload + little-endian CRC-CCITT FCS, LSB first, bit-stuffed,
    between flags."""
    from satdump_tpu_torch.ops.fec.crc import crc_ccitt
    fcs = crc_ccitt.compute(np.frombuffer(payload, np.uint8))
    raw = payload + bytes([fcs & 0xFF, fcs >> 8])
    bits = np.unpackbits(np.frombuffer(raw, np.uint8)[:, None], axis=1
                         )[:, ::-1].reshape(-1)
    out, ones = [], 0
    for b in bits:
        out.append(int(b))
        ones = ones + 1 if b else 0
        if ones == 5:
            out.append(0)
            ones = 0
    flag = [0, 1, 1, 1, 1, 1, 1, 0]
    return np.array(flag + out + flag, np.uint8)


def test_hdlc_deframer_equals_jax(rng):
    payloads = [bytes(rng.integers(0, 256, n).astype(np.uint8))
                for n in (20, 64, 31)]
    payloads[1] = b"\xff" * 12 + payloads[1][12:]    # long runs of ones
    stream = np.concatenate([rng.integers(0, 2, 50).astype(np.uint8)]
                            + [_hdlc_bits(p) for p in payloads])
    t, j = tcm.HDLCDeframer(), jcm.HDLCDeframer()
    got_t = t.work(stream[:700]) + t.work(stream[700:])
    got_j = j.work(stream[:700]) + j.work(stream[700:])
    assert [g.tobytes() for g in got_t] == [g.tobytes() for g in got_j]
    assert [g.tobytes() for g in got_t] == payloads


# -- NOAA TIP readers ---------------------------------------------------------

def _tip_stream(rng, n: int) -> np.ndarray:
    """TIP frames with HIRS elements, SEM words and AMSU words drawn at
    random, minor frame numbers counting from 0 (a timestamp on frame 0)."""
    frames = sim.tip_frames(rng, n)
    frames[:, 22:24] = rng.integers(0, 256, (n, 2))
    return frames


def test_tip_readers_equal_jax(rng):
    frames = _tip_stream(rng, 640)
    readers = {}
    for name, mod in (("jax", jtip), ("torch", ttip)):
        h, s, a = mod.HIRSReader(2021), mod.SEMReader(2021), mod.AMSUReader()
        for f in frames:
            h.work(f)
            s.work(f)
            a.last_TIP_timestamp = h.last_timestamp
            a.work_noaa(f)
        readers[name] = (h, s, a)
    (jh, js, ja), (th, ts, ta) = readers["jax"], readers["torch"]
    assert th.line == jh.line > 0 and th.timestamps == jh.timestamps
    for ch in range(20):
        np.testing.assert_array_equal(th.get_channel(ch), jh.get_channel(ch))
    assert ts.channels == js.channels and ts.timestamps == js.timestamps
    assert sum(map(len, ts.channels)) > 0
    assert (ta.linesA1, ta.linesA2) == (ja.linesA1, ja.linesA2)
    assert ta.timestamps_a1 == ja.timestamps_a1
    for ch in range(13):
        np.testing.assert_array_equal(ta.get_channel_a1(ch),
                                      ja.get_channel_a1(ch))
    for ch in range(2):
        np.testing.assert_array_equal(ta.get_channel_a2(ch),
                                      ja.get_channel_a2(ch))
    assert jtip.tip_timestamp(frames[0], jtip.TIPTimeParser(2021)) == \
        ttip.tip_timestamp(frames[0], ttip.TIPTimeParser(2021))


def test_amsu_noaa_frames_equal_jax(rng):
    """AMSU A1 / A2 science frames behind the 24-bit 0xFFFFFF sync, carried
    in the filtered words of AIP frames."""
    # even bytes: every word pair passes the filter, so the A1 / A2 streams
    # ride 13 / 7 pairs a frame unchanged
    a1 = np.concatenate([[0xFF] * 3, 2 * rng.integers(0, 127, 1237)]
                        ).astype(np.uint8)
    a2 = np.concatenate([[0xFF] * 3, 2 * rng.integers(0, 127, 309)]
                        ).astype(np.uint8)
    frames = sim.tip_frames(rng, 200)
    s1, s2 = np.tile(a1, 3), np.tile(a2, 10)
    for i, f in enumerate(frames):
        f[8:34] = np.resize(s1[26 * i: 26 * i + 26], 26)
        f[34:48] = np.resize(s2[14 * i: 14 * i + 14], 14)
    out = {}
    for name, mod in (("jax", jtip), ("torch", ttip)):
        a = mod.AMSUReader()
        for f in frames:
            a.work_noaa(f)
        out[name] = a
    assert out["torch"].linesA1 == out["jax"].linesA1 > 0
    assert out["torch"].linesA2 == out["jax"].linesA2 > 0
    for ch in range(13):
        np.testing.assert_array_equal(out["torch"].get_channel_a1(ch),
                                      out["jax"].get_channel_a1(ch))


def test_punctiform_product_equals_jax(tmp_path, rng):
    ts = np.cumsum(rng.random(17)) + 1.6e9
    pos = rng.random((17, 3)) * 90
    data = rng.integers(0, 255, 17)
    for name, cls in (("jax", JPP), ("torch", TPP)):
        p = cls()
        p.instrument_name = "sem"
        p.add_channel("3", ts, pos, data)
        p.add_channel("7", ts[:5], pos[:5], data[:5])
        p.set_tle({"name": "NOAA 19", "norad": 33591})
        p.save(str(tmp_path / name))
    for f in ("product.json", "product.cbor"):
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    back = tload(str(tmp_path / "torch"))
    assert isinstance(back, TPP) and back.has_tle()
    assert back.data[back.get_channel_index("7")].data == list(
        np.asarray(data[:5], np.float64))


# -- NOAA HRPT / GAC / DSB ----------------------------------------------------

def test_noaa_deframer_equals_jax(rng):
    words, _ = sim.noaa_hrpt_frames(rng, 3)
    bits = np.concatenate([rng.integers(0, 2, 337).astype(np.uint8),
                           sim.words_to_bits(words)])
    bits[337 + 110900 + 3] ^= 1                 # a sync bit of frame 1
    got = {}
    for name, mod in (("jax", jnh), ("torch", tnh)):
        d = mod.NOAADeframer(threshold=5)
        got[name] = d.work(bits[:50000]) + d.work(bits[50000:])
    assert len(got["torch"]) == len(got["jax"]) == 3
    for t, j, w in zip(got["torch"], got["jax"], words):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, w)


def test_noaa_hrpt_soft_to_products_equals_jax(tmp_path, rng):
    """4 minor frames as softs -> .frm -> AVHRR / HIRS / AMSU / SEM
    products: identical, and AVHRR holds the lines sent."""
    words, lines = sim.noaa_hrpt_frames(rng, 4)
    soft = sim.soft_stream(sim.words_to_bits(words), rng, prefix=513)
    soft.tofile(tmp_path / "x.soft")
    dec = _run_both(tmp_path, tmp_path / "x.soft", jnh.NOAAHRPTDecoderModule,
                    tnh.NOAAHRPTDecoderModule, {"buffer_size": 100000})
    frm = {k: Path(m.d_output_file).read_bytes() for k, m in dec.items()}
    assert frm["torch"] == frm["jax"]
    assert dec["torch"].stats == {"frames": 4}
    np.testing.assert_array_equal(
        np.frombuffer(frm["torch"], "<u2").reshape(4, -1)[:, 6:], words[:, 6:])
    ins = _run_both(tmp_path, Path(dec["torch"].d_output_file),
                    jnh.NOAAInstrumentsDecoderModule,
                    tnh.NOAAInstrumentsDecoderModule,
                    {"satellite": "NOAA-19"})
    assert ins["torch"].stats == ins["jax"].stats
    products = _assert_products_equal(tmp_path)
    assert "AVHRR" in products
    img = tload(str(tmp_path / "torch" / "AVHRR")).get_channel("1").image
    np.testing.assert_array_equal(img >> 6, lines[:, :, 0])


def test_noaa_gac_soft_to_products_equals_jax(tmp_path, rng):
    bits, lines = sim.noaa_gac_frames(rng, 5)
    soft = -sim.soft_stream(bits, rng)       # the deframer takes either sign
    soft.tofile(tmp_path / "x.soft")
    dec = _run_both(tmp_path, tmp_path / "x.soft", jnh.NOAAGACDecoderModule,
                    tnh.NOAAGACDecoderModule, {})
    frm = {k: Path(m.d_output_file).read_bytes() for k, m in dec.items()}
    assert frm["torch"] == frm["jax"]
    assert dec["torch"].stats["frame_count"] == 5
    ins = _run_both(tmp_path, Path(dec["torch"].d_output_file),
                    jnh.NOAAInstrumentsDecoderModule,
                    tnh.NOAAInstrumentsDecoderModule, {"gac_mode": True})
    assert ins["torch"].stats == ins["jax"].stats
    _assert_products_equal(tmp_path)
    img = tload(str(tmp_path / "torch" / "AVHRR")).get_channel("4").image
    np.testing.assert_array_equal(img >> 6, lines[:, :, 3])


def test_noaa_gac_backward_equals_jax(tmp_path, rng):
    bits, _ = sim.noaa_gac_frames(rng, 3)
    rev = np.concatenate([b[::-1] for b in bits.reshape(3, -1)])
    sim.soft_stream(rev, rng).tofile(tmp_path / "x.soft")
    dec = _run_both(tmp_path, tmp_path / "x.soft", jnh.NOAAGACDecoderModule,
                    tnh.NOAAGACDecoderModule, {"backward": True})
    assert dec["torch"].stats == dec["jax"].stats
    assert Path(dec["torch"].d_output_file).read_bytes() == \
        Path(dec["jax"].d_output_file).read_bytes()


def test_noaa_dsb_soft_to_products_equals_jax(tmp_path, rng):
    frames = sim.tip_frames(rng, 330)
    soft = -sim.soft_stream(np.unpackbits(frames.reshape(-1)), rng)
    soft.tofile(tmp_path / "x.soft")
    dec = _run_both(tmp_path, tmp_path / "x.soft", jnh.NOAADSBDecoderModule,
                    tnh.NOAADSBDecoderModule, {})
    tip = Path(dec["torch"].d_output_file).read_bytes()
    assert tip == Path(dec["jax"].d_output_file).read_bytes()
    assert tip == frames.tobytes()
    ins = _run_both(tmp_path, Path(dec["torch"].d_output_file),
                    jnh.NOAAInstrumentsDecoderModule,
                    tnh.NOAAInstrumentsDecoderModule, {"dsb_mode": True})
    assert ins["torch"].stats == ins["jax"].stats
    assert "SEM" in _assert_products_equal(tmp_path)


# -- METEOR HRPT --------------------------------------------------------------

def test_meteor_hrpt_soft_to_products_equals_jax(tmp_path, rng):
    """Inverted softs of 3 MSU-MR lines -> .cadu -> MSU-MR products."""
    cadus, imgs = sim.meteor_hrpt_cadus(rng, 3)
    bits = np.unpackbits(cadus.reshape(-1))
    soft = -sim.soft_stream(bits, rng, prefix=333)
    soft.tofile(tmp_path / "x.soft")
    dec = _run_both(tmp_path, tmp_path / "x.soft",
                    jmh.MeteorHRPTDecoderModule, tmh.MeteorHRPTDecoderModule,
                    {})
    out = Path(dec["torch"].d_output_file).read_bytes()
    assert out == Path(dec["jax"].d_output_file).read_bytes()
    assert out == cadus.tobytes()
    ins = _run_both(tmp_path, Path(dec["torch"].d_output_file),
                    jmh.MeteorInstrumentsModule, tmh.MeteorInstrumentsModule,
                    {"year_override": 2024})
    assert ins["torch"].stats == ins["jax"].stats
    assert ins["torch"].stats["msumr_lines"] == 3
    assert "MSU-MR" in _assert_products_equal(tmp_path)
    img = tload(str(tmp_path / "torch" / "MSU-MR")).get_channel("2").image
    np.testing.assert_array_equal(img >> 6, imgs[:, 1])


def test_meteor_readers_equal_jax(rng):
    """MTVZA (both byte orders) and the BIS-M clock on random frames."""
    frames = rng.integers(0, 256, (60, 248)).astype(np.uint8)
    frames[:, 4], frames[:, 5] = 255, np.arange(60) % 27
    for endian in (False, True):
        got = {}
        for name, mod in (("jax", jmh), ("torch", tmh)):
            r = mod.MTVZAReader(endian)
            for f in (frames[:, [0, 1, 2, 3, 5, 4] + list(range(6, 248))]
                      if endian else frames):
                r.work(f)
            got[name] = r
        assert got["torch"].lines == got["jax"].lines > 0
        for ch in range(30):
            np.testing.assert_array_equal(got["torch"].get_channel(ch),
                                          got["jax"].get_channel(ch))
    assert tmh.BISMReader(2024).timestamp_offset == \
        jmh.BISMReader(2024).timestamp_offset


def test_noaa_instruments_year_minus_one_is_this_year(tmp_path, rng):
    """noaa_gac and noaa_dsb pass their file's year_override, -1 (this
    year, as the TIP readers take it). The JAX module hands -1 on to the
    AVHRR reader, whose calendar.timegm raises; the port resolves it to
    the current year."""
    import time
    bits, _ = sim.noaa_gac_frames(rng, 2)
    sim.soft_stream(bits, rng).tofile(tmp_path / "x.soft")
    dec = tnh.NOAAGACDecoderModule(str(tmp_path / "x.soft"),
                                   str(tmp_path / "d"), {})
    dec.process()
    params = {"gac_mode": True, "year_override": -1}
    with pytest.raises(ValueError, match="year -1"):
        jnh.NOAAInstrumentsDecoderModule(dec.d_output_file,
                                         str(tmp_path / "jax" / "p"),
                                         params).process()
    year = time.gmtime().tm_year
    mod = tnh.NOAAInstrumentsDecoderModule(dec.d_output_file,
                                           str(tmp_path / "torch" / "p"),
                                           params)
    mod.process()
    ts = json.loads((tmp_path / "torch" / "dataset.json").read_text())
    assert time.gmtime(ts["timestamp"]).tm_year == year
