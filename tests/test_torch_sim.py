"""Self-tests of the port's test signals (sim.py): each decodes through the
port alone on the CPU. BPSK (NRZ-M) at GOES HRIT's 6 Msps, OQPSK (NRZ-M)
at METEOR-M2-x's 1 Msps, QPSK with a DC term and a carrier offset (undone
by dc_block and freq_shift), and FM-modulated APT audio.

Tolerances: CADUs equal to those sent; the APT image holds sync A at every
line's start (its correlation with the pattern at least twice that of
the image data) and follows the lines sent (a correlation above 0.5 on
every line: the reference's envelope keeps the 4.8 kHz image of the
subcarrier, which the port mirrors, so pixels are not the words sent).
"""

from pathlib import Path

import numpy as np
import pytest

from satdump_tpu_torch import sim
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
from satdump_tpu_torch.pipeline.runner import run_pipeline

PIPELINES = Path(__file__).resolve().parents[1] / "resources" / "pipelines"


def _decode(tmp_path, fname, pipe_id, bb, params, stop="cadu"):
    src = tmp_path / "bb.cf32"
    write_baseband(src, "cf32", bb)
    pipe = parse_pipeline_file(PIPELINES / fname)[pipe_id]
    pipe.steps = pipe.steps[: pipe.level_index(stop) + 1]
    return run_pipeline(pipe, str(src), str(tmp_path / "out"),
                        user_params=dict(params, torch_device="cpu"))


@pytest.mark.parametrize("fname,pipe_id,sps,constellation,params,chan", [
    ("GOES.json", "goes_hrit", sim.GOES_HRIT_SPS, "bpsk",
     {"buffer_size": 65536}, {}),
    ("Meteor-M.json", "meteor_m2x_lrpt", sim.METEOR_1M_SPS, "oqpsk",
     {"buffer_size": 16384}, {}),
    ("Meteor-M.json", "meteor_m2_lrpt", sim.METEOR_1M_SPS, "qpsk",
     {"buffer_size": 16384, "freq_shift": -2500.0, "dc_block": True},
     {"freq_offset": 2.5e-3, "dc": 0.1 - 0.05j}),
], ids=["bpsk_nrzm_6msps", "oqpsk_nrzm_1msps", "qpsk_dc_offset_1msps"])
def test_psk_signal_decodes(tmp_path, fname, pipe_id, sps, constellation,
                            params, chan):
    rng = np.random.default_rng(31)
    cadus = sim.make_cadus(6, rng)
    nrzm = constellation != "qpsk"
    bb = sim.ccsds_psk_baseband(cadus, rng, sps, constellation, nrzm=nrzm,
                                **chan)
    assert len(bb) == pytest.approx(
        (cadus.size * 16 + 2048) / (2 if constellation != "bpsk" else 1)
        * sps[0] / sps[1], abs=2)
    got = np.fromfile(_decode(tmp_path, fname, pipe_id, bb, params),
                      np.uint8).reshape(-1, 1024)
    np.testing.assert_array_equal(got, cadus)


def test_apt_signal_decodes(tmp_path):
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.models.noaa_apt import SYNC_A
    rng = np.random.default_rng(32)
    audio, lines = sim.apt_audio(12, 50e3, rng)
    bb = sim.fm_modulate(audio, 50e3, 200e3, 12.5e3, rng=rng)
    assert len(bb) == 4 * len(audio)
    _decode(tmp_path, "NOAA.json", "noaa_apt", bb, {"samplerate": 200e3},
            stop="products")
    img = load_img(tmp_path / "out" / "AVHRR" / "raw_sync.png").astype(float)
    assert img.shape == (12, 2080)
    pat = SYNC_A - SYNC_A.mean()
    body = img[1:-1]
    assert (body[:, :len(SYNC_A)] @ pat).min() > \
        2 * np.abs(body[:, 500:500 + len(SYNC_A)] @ pat).max()
    for got, sent in zip(body, lines[1:-1]):
        assert np.corrcoef(got[100:1900], sent[100:1900])[0, 1] > 0.5
