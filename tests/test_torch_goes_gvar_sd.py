"""The port's GOES GVAR, sensor-data and MDL modules (`models/goes_gvar.py`,
`models/goes_sd.py`) against the JAX package's, on the CPU, on the same
inputs made from a seed; the sim builders of GVAR and SD signals; and
`goes_gvar`, `goesn_sd` and `goes_mdl` through the port's CLI from .soft.

Everything here is host code in both packages, except the MDL decoder's
sync correlation (the port's torch.fft correlator on the CPU, the JAX
package's XLA FFT): the frames it picks are equal. So there is no
tolerance: frames, images, product.json, product.cbor and dataset.json are
equal.
"""

import json

import numpy as np
import pytest
from PIL import Image

from satdump_tpu.models import goes_gvar as jg
from satdump_tpu.models import goes_sd as jsd
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.image.io import load_img
from satdump_tpu_torch.models import goes_gvar as tg
from satdump_tpu_torch.models import goes_sd as tsd
from satdump_tpu_torch.ops.fec import differential
from satdump_tpu_torch.products.product import load_product
from tests.test_goes_gvar import mk_ir_frame, mk_vis_frame
from tests.test_torch_hrpt import _assert_products_equal, _run_both


def _gvar_soft(frames, rng, lead=97):
    bits = np.concatenate([rng.integers(0, 2, lead).astype(np.uint8)]
                          + [np.unpackbits(tg.rand_frame_tx(f))[:tg.FRAME_BITS]
                             for f in frames]
                          + [rng.integers(0, 2, 300).astype(np.uint8)])
    enc, _ = differential.nrzs_encode(bits)
    return sim.symbols_to_soft_int8(enc, 90)


def test_gvar_tables_and_derand_equal_jax(rng):
    np.testing.assert_array_equal(tg.gvar_derand_table(),
                                  jg.gvar_derand_table())
    f = rng.integers(0, 256, tg.FRAME_BYTES).astype(np.uint8)
    np.testing.assert_array_equal(tg.rand_frame_tx(f), jg.rand_frame_tx(f))
    np.testing.assert_array_equal(tg.derand_frame(f), jg.derand_frame(f))


def test_sim_gvar_frames_equal_the_jax_suites_fixtures(rng):
    frames, ir, vis = sim.gvar_imager_frames(rng, 5, 2)
    np.testing.assert_array_equal(frames[0], mk_ir_frame(None, 1, 5, ir))
    for b in range(2):
        np.testing.assert_array_equal(frames[1 + b],
                                      mk_vis_frame(None, 3 + b, 5, vis[b]))


def test_gvar_decoder_and_images_equal_jax(tmp_path, rng):
    """GVAR softs -> both decoders (frames identical) -> both image
    decoders (products identical, holding the lines sent)."""
    frames, ir, vis = sim.gvar_imager_frames(rng, 4, 8)
    src = tmp_path / "g.soft"
    _gvar_soft(frames, rng).tofile(src)
    mods = _run_both(tmp_path / "frm", src, jg.GVARDecoderModule,
                     tg.GVARDecoderModule, {})
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["frame_count"] == 9
    got = np.fromfile(mods["torch"].d_output_file, np.uint8)
    np.testing.assert_array_equal(
        got, np.fromfile(mods["jax"].d_output_file, np.uint8))
    mods = _run_both(tmp_path / "img", mods["torch"].d_output_file,
                     jg.GVARImageDecoderModule, tg.GVARImageDecoderModule, {})
    assert mods["torch"].stats == mods["jax"].stats
    assert _assert_products_equal(tmp_path / "img") == ["IMAGER"]
    prod = load_product(str(tmp_path / "img" / "torch" / "IMAGER"))
    for k in range(8):
        np.testing.assert_array_equal(prod.images[0].image[4 * 8 + k] >> 6,
                                      vis[k])
    np.testing.assert_array_equal(prod.images[1].image[8] >> 6, ir[0])


def _mdl_soft(rng, n):
    frames = rng.integers(0, 256, (n, tsd.MDL_FRAME_BYTES), dtype=np.uint8)
    sync = ((tsd.MDL_SYNC >> np.arange(31, -1, -1)) & 1).astype(np.uint8)
    soft = [rng.integers(-90, 90, 333).astype(np.int8)]
    for fr in frames:
        bits = np.unpackbits(fr ^ 0xFF)
        bits[:32] = sync
        soft.append(np.where(bits > 0, 90, -90).astype(np.int8))
        fr[:] = np.packbits(bits) ^ 0xFF
    return np.concatenate(soft), frames


def test_mdl_and_sd_decoders_equal_jax(tmp_path, rng):
    soft, frames = _mdl_soft(rng, 5)
    src = tmp_path / "mdl.soft"
    soft.tofile(src)
    mods = _run_both(tmp_path / "mdl", src, jsd.GOESMDLDecoderModule,
                     tsd.GOESMDLDecoderModule, {"torch_device": "cpu"})
    assert mods["torch"].stats == mods["jax"].stats
    got = np.fromfile(mods["torch"].d_output_file, np.uint8)
    np.testing.assert_array_equal(
        got, np.fromfile(mods["jax"].d_output_file, np.uint8))
    np.testing.assert_array_equal(got.reshape(-1, tsd.MDL_FRAME_BYTES),
                                  frames)
    bits, payloads = sim.goesn_sd_bits(rng, 40)
    enc, _ = differential.nrzm_encode(bits)
    src = tmp_path / "sd.soft"
    sim.symbols_to_soft_int8(enc, 90).tofile(src)
    mods = _run_both(tmp_path / "sd", src, jsd.GOESNSDDecoderModule,
                     tsd.GOESNSDDecoderModule, {})
    assert mods["torch"].stats == mods["jax"].stats
    got = np.fromfile(mods["torch"].d_output_file, np.uint8)
    np.testing.assert_array_equal(
        got, np.fromfile(mods["jax"].d_output_file, np.uint8))
    np.testing.assert_array_equal(got.reshape(-1, 60), payloads)


def _sd_imager_frames(rng, scans: int) -> np.ndarray:
    """Decoded SD frames (60 bytes): per scan 12 imagery blocks (type 26),
    12 fill frames and a scanline end (type 21); then end-of-image frames
    (type 16)."""
    def frame(wtype, fill):
        w = np.full(48, fill, np.uint16)
        w[1] = wtype
        w[4:] = rng.integers(0, 64, 44)
        return np.packbits(((w[:, None] >> np.arange(9, -1, -1)) & 1
                            ).astype(np.uint8).reshape(-1))
    out = []
    for s in range(scans):
        out += [frame(26, 20 + i) for i in range(12)]
        out += [frame(0, 0) for _ in range(12)] + [frame(21, 0)]
    out += [frame(16, 0) for _ in range(30)]
    return np.stack(out)


def test_sd_image_decoder_equals_jax(tmp_path, rng):
    src = tmp_path / "x.frm"
    _sd_imager_frames(rng, 14).tofile(src)
    mods = _run_both(tmp_path, src, jsd.SDImageDecoderModule,
                     tsd.SDImageDecoderModule, {})
    assert mods["torch"].stats == mods["jax"].stats
    assert mods["torch"].stats["image_sets"] == 1
    pngs = sorted((tmp_path / "jax").rglob("*.png"))
    assert pngs
    for p in pngs:
        q = tmp_path / "torch" / p.relative_to(tmp_path / "jax")
        np.testing.assert_array_equal(load_img(q), np.asarray(Image.open(p)))
    assert len(pngs) == len(list((tmp_path / "torch").rglob("*.png")))


def test_cli_goes_gvar_from_soft(tmp_path, rng):
    frames, ir, vis = sim.gvar_imager_frames(rng, 2, 2)
    src = tmp_path / "in.soft"
    _gvar_soft(frames, rng).tofile(src)
    out = tmp_path / "out"
    assert cli.main(["pipeline", "goes_gvar", "soft", str(src), str(out),
                     "--torch_device", "cpu"]) == 0
    assert json.loads((out / "dataset.json").read_text())["products"] == \
        ["IMAGER"]
    prod = load_product(str(out / "IMAGER"))
    np.testing.assert_array_equal(prod.images[0].image[16] >> 6, vis[0])


@pytest.mark.parametrize("pipe_id", ["goesn_sd", "goes_mdl"])
def test_cli_goesn_sd_and_goes_mdl_from_soft(tmp_path, pipe_id, rng):
    if pipe_id == "goes_mdl":
        soft, frames = _mdl_soft(rng, 4)
        width = tsd.MDL_FRAME_BYTES
    else:
        bits, frames = sim.goesn_sd_bits(rng, 30)
        soft = sim.symbols_to_soft_int8(differential.nrzm_encode(bits)[0], 90)
        width = 60
    src = tmp_path / "in.soft"
    soft.tofile(src)
    out = tmp_path / "out"
    assert cli.main(["pipeline", pipe_id, "soft", str(src), str(out),
                     "--torch_device", "cpu"]) == 0
    got = np.fromfile(out / f"{pipe_id}.frm", np.uint8).reshape(-1, width)
    np.testing.assert_array_equal(got, frames)
