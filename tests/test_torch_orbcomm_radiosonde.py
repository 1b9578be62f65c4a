"""The port's Orbcomm STX and M10 radiosonde modules (`models/orbcomm.py`,
`models/radiosonde.py`) and its copy of `geo/geodetic.py` against the JAX
package's, on the CPU, on the same inputs made from a seed; the sim
builders of their channel bits; and `orbcomm_stx` and `radiosonde_m10`
through the port's CLI from .soft and from baseband (fsk_demod's walkers on
the CPU).

Everything compared here is host NumPy in both packages, so there is no
tolerance: frames, .frm files and the JSON outputs are equal.
"""

import json

import numpy as np
import pytest
import torch

from satdump_tpu.geo import geodetic as jgeo
from satdump_tpu.models import orbcomm as jo
from satdump_tpu.models import radiosonde as jr
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.geo import geodetic as tgeo
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.models import orbcomm as to
from satdump_tpu_torch.models import radiosonde as tr
from tests.test_torch_hrpt import _run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """fsk_demod's plain walkers are loops of small torch ops on the CPU;
    with one intra-op thread they do not wait on a thread pool that the
    other test workers of a parallel run keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_geodetic_equals_jax(rng):
    xyz = rng.normal(0, 7000, (50, 3))
    np.testing.assert_array_equal(tgeo.ecef_to_lla(xyz),
                                  jgeo.ecef_to_lla(xyz))
    lat, lon = rng.uniform(-90, 90, 20), rng.uniform(-180, 180, 20)
    alt = rng.uniform(0, 900, 20)
    sat = tgeo.lla_to_ecef(lat, lon, alt)
    np.testing.assert_array_equal(sat, jgeo.lla_to_ecef(lat, lon, alt))
    for a, b in zip(tgeo.look_angles(45.0, 7.0, 0.3, sat),
                    jgeo.look_angles(45.0, 7.0, 0.3, sat)):
        np.testing.assert_array_equal(a, b)
    t = 1.7e9 + rng.uniform(0, 86400, 20)
    np.testing.assert_array_equal(tgeo.eci_to_ecef(xyz[:20], t),
                                  jgeo.eci_to_ecef(xyz[:20], t))
    np.testing.assert_array_equal(
        tgeo.vincenty_distance(lat, lon, lat[::-1], lon[::-1]),
        jgeo.vincenty_distance(lat, lon, lat[::-1], lon[::-1]))


def _orbcomm_frames(mod, n):
    return [mod.make_frame([(2, mod.make_ephemeris_packet(
        105 + i, 1700000000 + i, (6800.0, 1000.0 * i, 1500.0)))])
        for i in range(n)]


@pytest.mark.parametrize("invert", [False, True])
def test_orbcomm_deframer_equals_jax(invert, rng):
    frames = _orbcomm_frames(to, 3)
    for a, b in zip(frames, _orbcomm_frames(jo, 3)):
        np.testing.assert_array_equal(a, b)
    bits = np.concatenate([rng.integers(0, 2, 777, dtype=np.uint8)]
                          + [to.frame_to_channel_bits(f) for f in frames])
    bits[2000] ^= 1
    if invert:
        bits = 1 - bits
    got, ref = to.STXDeframer().work(bits), jo.STXDeframer().work(bits)
    np.testing.assert_array_equal(got, ref)
    got = to.reverse_bits(got)
    assert len(got) == 3
    for g, f in zip(got, frames):
        assert to.parse_frame(g) == jo.parse_frame(g)
    np.testing.assert_array_equal(got[1:], np.stack(frames[1:]))


def test_orbcomm_modules_equal_jax(tmp_path, rng):
    bits = sim.orbcomm_channel_bits(rng, 3)
    src = tmp_path / "x.soft"
    sim.symbols_to_soft_int8(bits, 60).tofile(src)
    mods = _run_both(tmp_path / "frm", src, jo.OrbcommSTXDeframerModule,
                     to.OrbcommSTXDeframerModule, {})
    assert mods["torch"].stats == mods["jax"].stats == {"frames": 3}
    frm = {k: m.d_output_file for k, m in mods.items()}
    assert open(frm["torch"], "rb").read() == open(frm["jax"], "rb").read()
    mods = _run_both(tmp_path / "pk", frm["torch"], jo.OrbcommPlotterModule,
                     to.OrbcommPlotterModule, {})
    assert mods["torch"].stats == mods["jax"].stats
    assert (tmp_path / "pk" / "torch" / "orbcomm.json").read_text() == \
        (tmp_path / "pk" / "jax" / "orbcomm.json").read_text()


def test_m10_equals_jax(tmp_path, rng):
    chan = tr.encode_frame({"timestamp": 1750000000, "lat": 48.8566,
                            "lon": 2.3522, "alt": 12345.678, "sat_count": 9})
    np.testing.assert_array_equal(chan, jr.encode_frame(
        {"timestamp": 1750000000, "lat": 48.8566, "lon": 2.3522,
         "alt": 12345.678, "sat_count": 9}))
    bits = sim.m10_channel_bits(rng, 4)
    bits[[700, 4000]] ^= 1                     # a sync error, a body error
    np.testing.assert_array_equal(tr.find_frames(bits), jr.find_frames(bits))
    src = tmp_path / "x.soft"
    sim.symbols_to_soft_int8(bits, 50).tofile(src)
    mods = _run_both(tmp_path, src, jr.M10DecoderModule, tr.M10DecoderModule,
                     {})
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["positions"] >= 3
    for f in ("m10_track.json", "pass.frm"):
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


@pytest.mark.parametrize("pipe_id,level", [
    ("orbcomm_stx", "soft"), ("radiosonde_m10", "soft"),
    ("radiosonde_m10", "baseband")])
def test_cli_orbcomm_and_m10(tmp_path, pipe_id, level, rng):
    if pipe_id == "orbcomm_stx":
        bits = sim.orbcomm_channel_bits(rng, 2)
    else:
        bits = sim.m10_channel_bits(rng, 3)
    if level == "soft":
        src = tmp_path / "in.soft"
        sim.symbols_to_soft_int8(bits, 60).tofile(src)
    else:
        src = tmp_path / "in.cf32"
        write_baseband(src, "cf32", sim.fsk_baseband(bits, 96000, 9600, rng,
                                                     4800.0))
    out = tmp_path / "out"
    assert cli.main(["pipeline", pipe_id, level, str(src), str(out),
                     "--torch_device", "cpu", "--samplerate", "96000"]) == 0
    if pipe_id == "orbcomm_stx":
        pk = json.loads((out / "orbcomm.json").read_text())
        eph = [p for p in pk if p["type"] == "ephemeris"]
        assert [p["scid"] for p in eph] == [105, 106]
    else:
        track = json.loads((out / "m10_track.json").read_text())
        np.testing.assert_allclose([t["lat"] for t in track],
                                   [45.0, 45.01, 45.02], atol=1e-6)
