"""The port's FM family (pipeline/modules/demod/fm.py) and NOAA APT decoder
(models/noaa_apt.py) against the JAX package's, on the CPU.

Tolerances, and why:
* fm_demod, ssb_demod WAVs: the audio passes the AGC (sub-block means),
  the resampler and the quadrature demod's atan2 (or the SSB shift's
  sin/cos), which round otherwise in XLA than in the port's float64 forms
  (test_torch_stages.py): int16 samples within 1 LSB, on at most 0.1 % of
  them.
* am_demod WAV: its envelope's DC blocker (alpha 1e-3) is a scan whose
  float32 error in JAX (~2e-5) is about one int16 LSB, so most samples
  may differ by 1 LSB: within 1 LSB.
* noaa_apt: the WAV as fm_demod's; the products level from the port's WAV
  (the synced and unsynced images, the A and B channels, product.json,
  dataset.json and the raw_sync composite): equal to the JAX package's
  from the same WAV.
"""

import wave
from pathlib import Path

import numpy as np
import pytest

from satdump_tpu.pipeline.module import module_registry as jregistry
from satdump_tpu.pipeline.module import register_all_modules as jregister
from satdump_tpu.pipeline.pipeline import parse_pipeline_file as jparse
from satdump_tpu.pipeline.runner import run_pipeline as jrun
from satdump_tpu_torch import sim
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.pipeline.module import module_registry as tregistry
from satdump_tpu_torch.pipeline.module import register_all_modules as tregister
from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file as tparse
from satdump_tpu_torch.pipeline.runner import run_pipeline as trun

ROOT = Path(__file__).resolve().parents[1]
NOAA = ROOT / "resources" / "pipelines" / "NOAA.json"


def _pcm(path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16
                             ).astype(np.int32)


def _assert_wav_close(tpath, jpath, max_share):
    t, j = _pcm(tpath), _pcm(jpath)
    assert t.shape == j.shape and len(t) > 0
    d = np.abs(t - j)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= max_share, (d > 0).mean()


FS, AUDIO = 96_000.0, 48_000.0
_T = np.arange(1 << 16) / FS


@pytest.mark.parametrize("module_id,iq,extra,max_share", [
    ("fm_demod", 0.4 * np.exp(1j * 2 * np.pi * (AUDIO / 2) * np.cumsum(
        0.6 * np.sin(2 * np.pi * 1000 * _T)) / FS), {}, 1e-3),
    ("am_demod", (1.0 + 0.6 * np.cos(2 * np.pi * 2000 * _T))
     * np.exp(2j * np.pi * 300.0 * _T), {}, 1.0),
    ("ssb_demod", np.exp(2j * np.pi * 13000.0 * _T), {"sideband": "usb"},
     1e-3),
    ("ssb_demod", np.exp(-2j * np.pi * 13000.0 * _T), {"sideband": "lsb"},
     1e-3),
], ids=["fm_tone", "am_tone", "usb_tone", "lsb_tone"])
def test_demod_wav_matches_jax(tmp_path, module_id, iq, extra, max_share):
    """A tone through each demodulator (96 ksps -> 48 kHz audio, blocks of
    2^14 samples, so four blocks and their seams)."""
    src = tmp_path / "in.cf32"
    write_baseband(src, "cf32", iq.astype(np.complex64))
    params = dict(extra, samplerate=FS, symbolrate=AUDIO, buffer_size=1 << 14)
    outs = []
    for name, registry, register, dev in (
            ("torch", tregistry, tregister, {"torch_device": "cpu"}),
            ("jax", jregistry, jregister, {})):
        register()
        m = registry.get(module_id)(str(src), str(tmp_path / name),
                                    dict(params, **dev))
        m.process()
        outs.append(m.d_output_file)
    _assert_wav_close(*outs, max_share)


def test_noaa_apt_baseband_to_products_matches_jax(tmp_path):
    """20 lines (10 s) of APT audio, FM-modulated at 250 ksps (deviation
    12.5 kHz, SNR 30 dB), through the `noaa_apt` pipeline: noaa_apt_demod
    to 50 kHz audio (blocks of 2^16 * 5 samples), noaa_apt_decoder to
    products and the processor's composite. The port's WAV is held to the
    JAX package's; the JAX package's decoder and processor then run on the
    port's WAV, and every product file, dataset.json and the composite
    equal the port's."""
    from satdump_tpu.models.noaa_apt import NOAAAPTDecoderModule
    from satdump_tpu.products.processor import process_path
    from test_torch_e2e import _assert_products_and_composites_match
    rng = np.random.default_rng(21)
    audio, _ = sim.apt_audio(20, 50e3, rng)
    src = tmp_path / "apt.cf32"
    write_baseband(src, "cf32", sim.fm_modulate(audio, 50e3, 250e3, 12.5e3,
                                                rng=rng))
    params = {"samplerate": 250e3, "buffer_size": 1 << 16}
    out, jout = tmp_path / "torch", tmp_path / "jax"
    trun(tparse(NOAA)["noaa_apt"], str(src), str(out),
         user_params=dict(params, torch_device="cpu"))
    jpipe = jparse(NOAA)["noaa_apt"]
    jpipe.steps = jpipe.steps[: jpipe.level_index("audio_wav") + 1]
    jrun(jpipe, str(src), str(jout), user_params=params)
    _assert_wav_close(out / "noaa_apt.wav", jout / "noaa_apt.wav", 1e-3)

    ref = tmp_path / "ref"
    ref.mkdir()
    NOAAAPTDecoderModule(str(out / "noaa_apt.wav"), str(ref / "noaa_apt"),
                         {"audio_samplerate": 50e3, "save_unsynced": True}
                         ).process()
    written = process_path(str(ref / "dataset.json"))
    assert (out / "dataset.json").read_text() == \
        (ref / "dataset.json").read_text()
    _assert_products_and_composites_match(out, ref, written, {
        "AVHRR": ("avhrr_apt", ["raw_sync"])})
    from PIL import Image
    from satdump_tpu_torch.image.io import load_img
    for name in ("raw_sync.png", "raw_unsync.png"):
        np.testing.assert_array_equal(
            load_img(out / "AVHRR" / name),
            np.asarray(Image.open(ref / "AVHRR" / name)))
