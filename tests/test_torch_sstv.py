"""The port's `sstv_decoder` (a host copy of satdump_tpu/pipeline/modules/
analog.py) against the JAX module on the CPU: mode-conformant FM audio
(tests/test_sstv.py's synthesis) in BW8, Robot36 and PD120, decoded to
images equal to the JAX module's, and the module's WAV -> PNG path (the
port's PNG codec read back equal to the JAX module's Pillow PNG).
"""

import wave

import numpy as np
import pytest

from satdump_tpu.pipeline.modules import analog as janalog
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.pipeline.modules import analog

SR = 48000.0


def _fm_synth(freqs: np.ndarray) -> np.ndarray:
    phase = np.cumsum(2 * np.pi * freqs / SR)
    return np.sin(phase).astype(np.float32)


def _line_freqs(cfg, segments):
    """One line of per-sample frequencies: the sync pulse, then each
    (offset, time, values) segment's luminance tones, black elsewhere."""
    n = int(round(cfg["line_time"] * SR))
    f = np.full(n, analog.FREQ_BLACK)
    f[: int(cfg["sync_time"] * SR)] = analog.FREQ_SYNC
    for off, dur, vals in segments:
        i0 = int(round(off * SR))
        i1 = int(round((off + dur) * SR))
        pos = np.linspace(0, 1, i1 - i0, endpoint=False)
        src = np.clip((pos * len(vals)).astype(int), 0, len(vals) - 1)
        f[i0:i1] = analog.FREQ_BLACK + np.asarray(vals, np.float64)[src] * (
            analog.FREQ_WHITE - analog.FREQ_BLACK)
    return f


def _audio(mode: str, rng, lines: int) -> np.ndarray:
    cfg = analog.SSTV_MODES[mode]
    out = []
    for i in range(lines):
        v = rng.uniform(0.1, 0.9, 8)
        if cfg["mode"] == "grayscale":
            segs = [(cfg["img_offset"], cfg["img_time"], v)]
        elif cfg["mode"] == "robot":
            segs = [(cfg["color_offset_y"], cfg["color_time_y"], v),
                    (cfg["color_sync_offset"], cfg["color_sync_time"],
                     [float(i % 2)]),
                    (cfg["color_offset_uv"], cfg["color_time_uv"], v[::-1])]
        else:
            segs = [(cfg[f"color_offset_{c}"], cfg[f"color_time_{c}"],
                     np.roll(v, k)) for k, c in enumerate(("y1", "u", "v",
                                                            "y2"))]
        out.append(_line_freqs(cfg, segs))
    lead = np.full(int(0.031 * SR), analog.FREQ_BLACK)
    return _fm_synth(np.concatenate([lead] + out))


@pytest.mark.parametrize("mode,lines", [("BW8", 24), ("Robot36", 12),
                                        ("PD120", 4)])
def test_decode_matches_jax(rng, mode, lines):
    audio = _audio(mode, rng, lines)
    img = analog.decode_sstv(audio, SR, mode)
    jimg = janalog.decode_sstv(audio, SR, mode)
    assert img.dtype == np.uint8 and img.shape[0] >= lines - 2
    assert img.shape[1] == analog.SSTV_MODES[mode]["img_width"]
    np.testing.assert_array_equal(img, jimg)


def test_module_wav_to_png_matches_jax(tmp_path, rng):
    audio = _audio("Robot36", rng, 10)
    wav_path = tmp_path / "sstv.wav"
    with wave.open(str(wav_path), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(int(SR))
        pcm = (audio * 32000).astype(np.int16)
        wf.writeframes(np.stack([pcm, -pcm], axis=1).tobytes())
    got = {}
    for name, mod in (("torch", analog), ("jax", janalog)):
        m = mod.SSTVDecoderModule(str(wav_path), str(tmp_path / name),
                                  {"sstv_mode": "Robot36"})
        m.process()
        assert m.d_output_file == str(tmp_path / name) + ".png"
        got[name] = (load_img(m.d_output_file), m.stats)
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1] == {
        "lines": got["torch"][0].shape[0], "mode": "Robot36"}
    with pytest.raises(ValueError, match="invalid SSTV mode"):
        analog.SSTVDecoderModule(str(wav_path), str(tmp_path / "x"),
                                 {"sstv_mode": "Martin1"}).process()
