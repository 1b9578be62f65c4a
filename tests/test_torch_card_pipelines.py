"""Whole passes of the port on the card: what the card writes equals what
the CPU writes for the same input, and what was sent; every pass launches
the kernels of its path, so that none falls back to a plain version
unseen.

Every test here is marked `card` and skips where there is no CUDA card.
This file imports no JAX, nothing of the satdump_tpu package and no PIL; on
the card's host run it as tests/torch_card.py says.

Most passes are rows of PASSES: an input made by sim.py on a generator of
its own, then the pipeline from its first level to its last on the card,
one level a call with every kernel's launches counted, then on the CPU
from `cpu_from` (the card's output at that level) to the last level. The
files matching `files` must be byte-identical (.cadu, .frm, .ts, .bbframe,
PNGs, JSON), the products equal (dataset.json, each product's files and
its images' pixels), and what was sent must come out (`check`). Passes
held only against what was sent (a BER, the CADUs sent) have no
`cpu_from`. The main path, the options pass, the live path, projection,
ingest, the scale-out and the codecs are tests of their own below.
"""

import contextlib
import dataclasses
import io
import json
import socket
import threading
import time
import urllib.request
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import pytest
import torch

from torch_card import (ROOT, assert_launched, card,  # noqa: F401
                              counted)

SEED = 20261016
ALL_KERNELS = ("viterbi_re", "resample_arith_grid", "agc_walk", "pll_walk",
               "costas_walk", "mm_walk", "turbo_bcjr", "viterbi_block_acs",
               "viterbi_block_traceback", "gardner_walk", "resample_strip")
K1K2 = ("viterbi_re", "resample_arith_grid")
WALKERS = ("agc_walk", "pll_walk", "costas_walk", "mm_walk")


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([SEED, *key])


def _pipeline(fname: str, pipe_id: str, start: str = "baseband",
              stop: str = "cadu"):
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    pipe = parse_pipeline_file(ROOT / "resources" / "pipelines" /
                               fname)[pipe_id]
    pipe.steps = pipe.steps[pipe.level_index(start):
                            pipe.level_index(stop) + 1]
    return pipe


def _baseband(work: Path, bb: np.ndarray) -> Path:
    from satdump_tpu_torch.io import write_baseband
    work.mkdir(parents=True, exist_ok=True)
    write_baseband(work / "pass.cf32", "cf32", bb)
    return work / "pass.cf32"


def _softs(work: Path, soft: np.ndarray) -> Path:
    work.mkdir(parents=True, exist_ok=True)
    soft.tofile(work / "pass.soft")
    return work / "pass.soft"


def _check_cadus(out, cadus: np.ndarray, label: str = "") -> np.ndarray:
    """Every CADU out one that was sent, bit for bit, and at most 2 of
    those sent missing."""
    got = np.fromfile(out, dtype=np.uint8).reshape(-1, cadus.shape[1])
    sent = {c.tobytes() for c in cadus}
    bad = sum(g.tobytes() not in sent for g in got)
    assert not bad and len(got) >= len(cadus) - 2, \
        f"{label}: {bad} corrupt CADUs, {len(got)} of {len(cadus)} decoded"
    return got


def _same_images(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _tree(d: Path, pattern: str = "*") -> dict:
    """{relative path: bytes} of the files under d matching pattern."""
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob(pattern)) if p.is_file()}


def _same_products(a: Path, b: Path, label: str) -> list:
    """dataset.json, every product's product.json, product.cbor and
    channel images, and the pixels of every PNG in it (channels and
    composites), equal under a and b. Returns the products."""
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.products.product import load_product
    ds = (a / "dataset.json").read_text()
    assert (b / "dataset.json").read_text() == ds, f"{label}: dataset.json"
    products = json.loads(ds)["products"]
    for rel in products:
        for f in ("product.json", "product.cbor"):
            assert (a / rel / f).read_bytes() == (b / rel / f).read_bytes(), \
                f"{label}: {rel}/{f} differs"
        pa, pb = load_product(str(a / rel)), load_product(str(b / rel))
        for x, y in zip(getattr(pa, "images", []), getattr(pb, "images", [])):
            assert _same_images(x.image, y.image), \
                f"{label}: {rel} channel {x.channel_name} differs"
        for png in sorted((a / rel).glob("*.png")):
            c = png.relative_to(a)
            assert _same_images(load_img(a / c), load_img(b / c)), \
                f"{label}: image {c} differs"
    return products


def _autogen_composites(products: dict) -> list:
    """{product dir: instrument} -> the composite files that the
    instrument cfgs' autogen presets must give (the processor logs and
    skips a preset that fails, so a missing file is the sign of one)."""
    from satdump_tpu_torch.products.processor import load_instrument_cfg
    out = [f"{d}/{inst}_{name}.png" for d, inst in products.items()
           for name, preset in load_instrument_cfg(inst)["presets"].items()
           if preset.get("autogen")]
    assert out, f"no autogen preset for {products}"
    return out


METOP_PRODUCTS = {"AVHRR": "avhrr_3", "MHS": "mhs"}


def _check_avhrr_mhs(out_dir: Path, truth: dict) -> None:
    """The AVHRR/3 and MHS products in out_dir hold the lines sent, bit for
    bit (AVHRR slot 3 is channel 3a on 3a lines, 3b on the others), and
    every autogen composite of avhrr_3 and mhs is there."""
    from satdump_tpu_torch.products.product import load_product
    av = load_product(str(out_dir / "AVHRR"))
    sent, ch3a = truth["avhrr"], truth["ch3a"]
    for n, s in (("1", 0), ("2", 1), ("4", 3), ("5", 4)):
        assert np.array_equal(av.get_channel(n).image >> 6, sent[:, :, s]), n
    assert np.array_equal(av.get_channel("3a").image[ch3a] >> 6,
                          sent[ch3a, :, 2])
    assert np.array_equal(av.get_channel("3b").image[~ch3a] >> 6,
                          sent[~ch3a, :, 2])
    mhs = load_product(str(out_dir / "MHS"))
    for c in range(5):
        assert np.array_equal(mhs.get_channel(str(c + 1)).image,
                              truth["mhs"][:, :, c]), f"MHS {c + 1}"
    missing = [c for c in _autogen_composites(METOP_PRODUCTS)
               if not (out_dir / c).exists()]
    assert not missing, f"composites missing: {missing}"


def _check_msumr(product_dir: Path, truth: dict) -> None:
    """MSU-MR channels within 8 LSB (mean) of the image sent (JPEG at QF
    80)."""
    from satdump_tpu_torch.products.product import load_product
    prod = load_product(str(product_dir))
    for ch in sorted(truth):
        img = prod.get_channel(str(ch)).image
        err = float(np.abs((img >> 8).astype(int) - truth[ch]).mean())
        assert img.shape == truth[ch].shape and err <= 8.0, (ch, err)


# ---- the passes ------------------------------------------------------------

@dataclasses.dataclass
class Pass:
    """One pass: `make(rng, work)` writes the input and returns (its path,
    what was sent); `levels` the pipeline's levels from the input's to the
    last; `params` the user parameters of every level, `first` those of
    the first alone ("{work}" in a value is the pass's directory);
    `need` {level or "*" (all): kernels that must launch}; `cpu_from` the
    level the CPU starts from (None: the card alone); `files` the patterns
    of files that must be byte-identical; `check(out_dir, outs, truth)`
    holds the card's output to what was sent."""
    id: str
    seed: int
    file: str
    pipe_id: str
    levels: Tuple[str, ...]
    make: Callable
    check: Callable
    params: Dict = dataclasses.field(default_factory=dict)
    first: Dict = dataclasses.field(default_factory=dict)
    need: Dict = dataclasses.field(default_factory=dict)
    cpu_from: Optional[str] = None
    files: Tuple[str, ...] = ()

    def stage_params(self, i: int, work: Path, dev: str) -> dict:
        p = dict(self.params, **(self.first if i == 0 else {}))
        p = {k: v.format(work=work) if isinstance(v, str) else v
             for k, v in p.items()}
        return dict(p, torch_device=dev)


def _run(p: Pass, src: Path, work: Path, dev: str, start: int = 0,
         first_input=None):
    """p's stages from levels[start] on `dev` into work/dev, one
    run_pipeline call each: ({level: output}, {level: launches})."""
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    outs, launches = {}, {}
    cur = str(first_input or src)
    for i in range(start, len(p.levels) - 1):
        lo, hi = p.levels[i], p.levels[i + 1]

        def stage():
            return run_pipeline(_pipeline(p.file, p.pipe_id, lo, hi), cur,
                                str(work / dev),
                                user_params=p.stage_params(i, work, dev),
                                start_level=lo)
        if dev == "cpu":
            out = stage()
        else:
            out, launches[hi] = counted(stage, ALL_KERNELS)
        outs[hi] = cur = out
    return outs, launches


# the inputs. Each returns (input path, what was sent)

def _in_metop_small(rng, work):
    from satdump_tpu_torch import sim
    cadus = sim.make_cadus(12, rng)
    return _baseband(work, sim.ccsds_qpsk_baseband(cadus, rng, (18, 7))), \
        {"cadus": cadus}


def _in_meteor_small(rng, work):
    from satdump_tpu_torch import sim
    cadus, truth = sim.msumr_lrpt_cadus(rng, 2)
    return _baseband(work, sim.ccsds_qpsk_baseband(cadus, rng, (35, 9))), \
        {"cadus": cadus, "msumr": truth}


def _in_meteor_1msps(strips: int, oqpsk: bool):
    def make(rng, work):
        from satdump_tpu_torch import sim
        cadus, truth = sim.msumr_lrpt_cadus(rng, strips)
        bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS,
                                    "oqpsk" if oqpsk else "qpsk", nrzm=oqpsk)
        return _baseband(work, bb), {"cadus": cadus, "msumr": truth}
    return make


def _in_goes_hrit(rng, work):
    from satdump_tpu_torch import sim
    cadus = sim.make_cadus(79, rng)
    return _baseband(work, sim.ccsds_psk_baseband(
        cadus, rng, sim.GOES_HRIT_SPS, "bpsk", nrzm=True)), {"cadus": cadus}


APT_LINES = 40


def _in_apt(rng, work):
    from satdump_tpu_torch import sim
    audio, lines = sim.apt_audio(APT_LINES, 50e3, rng)
    return _baseband(work, sim.fm_modulate(audio, 50e3, 1e6, 12.5e3,
                                           rng=rng)), {"lines": lines}


def _in_integral(rng, work):
    """bpsk_90: the second symbol of each pair sent inverted, as CCSDS
    sends it; RS(255,239) x 4."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
    cadus = sim.make_cadus(15, rng, rs=ReedSolomon(k=239))
    bits = sim.encode_cadu_stream(cadus)
    bits[1::2] ^= 1
    return _baseband(work, sim.pm_bpsk_baseband(bits, 8, rng)), \
        {"cadus": cadus}


CLASSIC_SAMPLES = 1 << 23


def _in_pm_hrpt_soft(rng, work):
    """NOAA HRPT's pm_demod at 3 Msps (665.4 ksym/s, sps 4.51)."""
    from satdump_tpu_torch import sim
    lead = 1024
    nbits = int(CLASSIC_SAMPLES / (3e6 / 665.4e3)) - lead - 2048
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    bb = sim.pm_bpsk_baseband(bits, 3e6 / 665.4e3, rng, lead_bits=lead)
    return _baseband(work, bb), {
        "bits": np.concatenate([np.zeros(lead, np.uint8), bits]),
        "ber": 1e-3}


def _in_fsk_dragon_soft(rng, work):
    """Crew Dragon's fsk_demod at 6 Msps (2.35 Msym/s, sps 2.55)."""
    from satdump_tpu_torch import sim
    lead = 512
    nbits = int(CLASSIC_SAMPLES / (6e6 / 2.35e6)) - lead - 512
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    bb = sim.fsk_baseband(bits, 6e6, 2.35e6, rng, 2.35e6 / 4, lead_bits=lead)
    return _baseband(work, bb), {
        "bits": np.concatenate([np.zeros(lead, np.uint8), bits]),
        "ber": 1e-2}


def _in_elektro_ggak(rng, work):
    """pm_demod -> simple PSK, 5 ksym/s at 40 ksps."""
    from satdump_tpu_torch import sim
    asm = np.tile(np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8), (6, 1))
    cadus = np.concatenate([asm, rng.integers(0, 256, (6, 220)
                                              ).astype(np.uint8)], 1)
    bb = sim.pm_bpsk_baseband(sim.encode_cadu_stream_uncoded(
        cadus, randomize=False), 8, rng, tail_bits=1024)
    return _baseband(work, bb), {"cadus": cadus}


def _in_sts1(rng, work):
    """fsk_demod resampled from 140 ksps -> simple PSK, rs_i 1."""
    from satdump_tpu_torch import sim
    cadus = sim.make_cadus(6, rng, cadu_bytes=259, rs_i=1)
    return _baseband(work, sim.fsk_baseband(sim.encode_cadu_stream_uncoded(
        cadus), 140e3, 9600, rng, 2400.0)), {"cadus": cadus}


def _in_saral(rng, work):
    from satdump_tpu_torch import sim
    cadus = sim.make_cadus(8, rng, cadu_bytes=1279, rs_i=5)
    return _baseband(work, sim.ccsds_psk_baseband(cadus, rng, (5, 2))), \
        {"cadus": cadus}


def _in_juice(rng, work):
    """JUICE X-band: pm_demod at 526,316 sym/s recorded at sps 4, turbo 1/2
    base 1115, 32 frames; its narrow loops (PLL 0.002, Costas 0.001) lock
    in a few thousand symbols, so 8192 random bits go ahead of the first
    marker."""
    from satdump_tpu_torch import sim
    frames = sim.crc_frames(32, rng, 1115)
    bb = sim.pm_bpsk_baseband(sim.turbo_stream_bits(frames, 1115, "1/2"), 4,
                              rng, lead_bits=8192)
    return _baseband(work, bb), {"frames": frames}


def _in_tgo(rng, work):
    """One 2^20-soft block of 58 frames (50 iterations)."""
    from satdump_tpu_torch import sim
    frames = sim.crc_frames(58, rng, 1115)
    return _softs(work, sim.soft_stream(sim.turbo_stream_bits(
        frames, 1115, "1/2"), rng)), {"frames": frames}


def _in_sounder(rng, work):
    """GOES-R raw sounder data: psk_demod BPSK at 928 ksym/s at 2 Msps, C2
    LDPC, 8192-bit CADUs in the internal stream: 55 CADUs in 64 frames."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.fec.ldpc_ccsds import CCSDSLDPC
    cadus = sim.make_cadus(55, rng)
    bits = sim.ldpc_stream_bits(sim.ldpc_internal_frames(
        cadus, CCSDSLDPC("7/8"), rng), 0x1ACFFC1D, 32)
    chan = np.concatenate([rng.integers(0, 2, 4096).astype(np.uint8), bits,
                           rng.integers(0, 2, 2048).astype(np.uint8)])
    return _baseband(work, sim.psk_baseband(chan, rng, (125, 58), "bpsk")), \
        {"cadus": cadus, "all": True}


ORION_ASM = 0x034776C7272895B0


def _in_orion(rng, work):
    """OQPSK with the Q rail a symbol late and both rails negated (the
    correlator's swap path), AR4JA 1/2 k 1024, 64 frames."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.fec.ldpc_ccsds import CCSDSLDPC
    ld = CCSDSLDPC("1/2", 1024)
    frames = ld.encode_frames(ld.encoder(), rng.integers(
        0, 2, (64, ld.data_bits)).astype(np.uint8))
    soft = sim.oqpsk_q_late(sim.soft_stream(
        sim.ldpc_stream_bits(frames, ORION_ASM, 64), rng, mag=100,
        sigma=20.0, prefix=778))
    sent = np.concatenate([np.tile(np.frombuffer(
        ORION_ASM.to_bytes(8, "big"), np.uint8), (64, 1)),
        np.packbits(frames, axis=-1)], axis=1)
    return _softs(work, soft), {"bytes": sent.tobytes()}


def _grb_input(rng, frames: int):
    """GRB baseband at exactly 2 sps: `frames` BBFrames of 2048-byte CADUs
    then 2 more (the block trim and the extractor's look-ahead end there),
    every frame full of CADUs: (cadus, the count the first `frames` hold,
    baseband)."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.dvbs2 import tx
    per_frame = 58192 // 8 - 10
    n = (frames + 2) * per_frame // 2048
    cadus = rng.integers(0, 256, (n, 2048)).astype(np.uint8)
    cadus[:, :4] = [0x1A, 0xCF, 0xFC, 0x1D]
    syms = tx.bbframes_to_symbols(sim.grb_bbframes(cadus), 11, False,
                                  False).ravel()
    return cadus, frames * per_frame // 2048, sim.dvbs2_baseband(syms, rng)


def _in_grb(frames: int):
    def make(rng, work):
        cadus, n, bb = _grb_input(rng, frames)
        return _baseband(work, bb), {"cadus": cadus, "n": n}
    return make


S2_TS_PACKETS = 200


def _in_dvbs2(rng, work):
    """The `dvbs2` pipeline's file's MODCOD 4 and 1 Msym/s, short frames."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.dvbs2 import tx
    ts = rng.integers(0, 256, (S2_TS_PACKETS, 188)).astype(np.uint8)
    ts[:, 0] = 0x47
    return _baseband(work, sim.dvbs2_baseband(tx.ts_to_symbols(
        ts, 4, True, False), rng)), {"ts": ts}


def _in_fy3d(rng, work):
    """FY-3D AHRPT: QPSK at 30 Msym/s recorded at 90 Msps, sps 3, each rail
    its own r=1/2 k=7 code behind the FengYun differential code, RS x4;
    342 CADUs, 8,417,286 samples."""
    from satdump_tpu_torch import sim
    cadus = sim.make_cadus(342, rng)
    return _baseband(work, sim.fy3_ahrpt_baseband(cadus, rng)), \
        {"cadus": cadus}


def _in_fy3ab(rng, work):
    """FY-3A/B at 8.4 Msps: a VIRR line and the VCID-12 sounders."""
    from satdump_tpu_torch import sim
    cadus, lines = sim.fy3_instrument_cadus(rng, 1, 3, 2)
    return _baseband(work, sim.fy3_ahrpt_baseband(cadus, rng)), \
        {"cadus_bytes": cadus.tobytes(), "virr": lines[:, :, 0]}


HRPT_YEAR = 2024   # year_override of METEOR, GAC, DSB: no wall-clock year
HRPT_GAC_FRAMES = 24


def _in_gac(rng, work):
    """NOAA GAC: BPSK at 2.6616 Msym/s, 6 Msps, sps 2.254 (K2)."""
    from satdump_tpu_torch import sim
    bits, lines = sim.noaa_gac_frames(rng, HRPT_GAC_FRAMES)
    bits = np.concatenate([rng.integers(0, 2, 4096).astype(np.uint8), bits,
                           rng.integers(0, 2, 4096).astype(np.uint8)])
    return _baseband(work, sim.psk_baseband(bits, rng, (2500, 1109),
                                            "bpsk")), {"lines": lines}


HRPT_SPS = 3e6 / 665.4e3
HRPT_LEAD = 16384


def _in_noaa_hrpt(rng, work):
    """PM at 3 Msps: pm_bpsk_baseband sends a 1 as -1 and pm_demod returns
    a +1 as a positive soft, so the bits go out inverted to come back as
    sent; the loops get HRPT_LEAD bits to settle (the format carries no
    code that would absorb their first slips)."""
    from satdump_tpu_torch import sim
    words, lines = sim.noaa_hrpt_frames(rng, 5)
    bb = sim.pm_bpsk_baseband(1 - sim.words_to_bits(words), HRPT_SPS, rng,
                              lead_bits=HRPT_LEAD)
    return _baseband(work, bb), {"words": words, "lines": lines}


def _in_meteor_hrpt(rng, work):
    from satdump_tpu_torch import sim
    meteor, imgs = sim.meteor_hrpt_cadus(rng, 4)
    bb = sim.pm_bpsk_baseband(1 - np.unpackbits(meteor.reshape(-1)),
                              HRPT_SPS, rng, lead_bits=HRPT_LEAD)
    return _baseband(work, bb), {"bytes": meteor.tobytes(), "imgs": imgs}


def _in_dsb(rng, work):
    """NOAA DSB from the softs of 330 TIP frames."""
    from satdump_tpu_torch import sim
    tips = sim.tip_frames(rng, 330)
    return _softs(work, sim.soft_stream(np.unpackbits(tips.reshape(-1)),
                                        rng)), {"tips": tips.tobytes()}


# Inmarsat: STD-C (1200 sym/s BPSK at 48 ksps, 3 frames), Aero 10.5k (OQPSK
# at 12 ksps, sps 2.29: K2) and Aero 1.2k (SDPSK at 48 ksps, the walkers), 6
# frames each. The samplerates are chosen here: the Inmarsat pipeline
# files set none (at 48 ksps both packages' resampled OQPSK path loses lock
# on Aero 10.5k)
INM_FRAMES = 6
INM_START = 86400.0 * 20000   # the parsers' start_timestamp
INM_AERO = {"inmarsat_aero_105": (dict(oqpsk=True, dummy_bits=178,
                                       inter_cols=78, inter_blocks=1), 5250),
            "inmarsat_aero_12": (dict(oqpsk=False, dummy_bits=0,
                                      inter_cols=9, inter_blocks=2), 1200)}
INM_STDC_TEXT = "THE QUICK BROWN FOX JUMPS OVER"


def _noise(rng, n):
    return rng.integers(0, 2, n).astype(np.uint8)


def _in_stdc(rng, work):
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops import inmarsat_stdc as stdc
    frames = sim.stdc_frames()
    bits = np.concatenate([_noise(rng, 2000)]
                          + [stdc.encode_frame(f) for f in frames]
                          + [_noise(rng, 2000)])
    bb = sim.psk_baseband(bits, rng, (40, 1), "bpsk", snr_db=15.0,
                          freq_offset=2e-4)
    return _baseband(work, bb), {"frames": len(frames), "need": len(frames),
                                 "frame_bytes": 640, "text": INM_STDC_TEXT}


def _in_aero(pipe_id: str):
    def make(rng, work):
        from satdump_tpu_torch import sim
        from satdump_tpu_torch.ops import inmarsat_aero as aero
        cfg, symrate = INM_AERO[pipe_id]
        n = aero.frame_geometry(**cfg)["info"] // 16
        # an ACARS message in 6 signal units: one 72-byte 1.2k frame
        text = f"POS {symrate} BD"
        sus = sim.acars_signal_units("B-6543", "H1", text)
        frame = np.frombuffer(sus.ljust(n, b"\0")[:n], np.uint8)
        bits = np.concatenate([aero.encode_frame(frame, **cfg, rng=rng)
                               for _ in range(INM_FRAMES)])
        if cfg["oqpsk"]:
            # the symbols a quarter turn on, (I, Q) -> (-Q, I): the softs
            # leave psk_demod at +90 degrees. The correlator's OQPSK
            # replicas (90, 270, and 0 / 180 with the Q rail a symbol late)
            # hold none for softs at 0 degrees, in either package
            chan = np.concatenate([_noise(rng, 2000), bits,
                                   _noise(rng, 2000)])
            turned = np.empty_like(chan)
            turned[0::2], turned[1::2] = 1 - chan[1::2], chan[0::2]
            bb = sim.psk_baseband(turned, rng, (16, 7), "oqpsk",
                                  snr_db=15.0, freq_offset=2e-4)
        else:
            bb = sim.fsk_baseband(bits, 48e3, symrate, rng, symrate / 4,
                                  snr_db=15.0, lead_bits=1000)
        # the Aero decoder takes the best sync of a two-frame window, so
        # with noise it passes some over (in both packages)
        return _baseband(work, bb), {"frames": INM_FRAMES, "need": 2,
                                     "frame_bytes": n, "text": text}
    return make


JPSS_BANDS = ("M4",)
# psk_demod takes 2^16-sample blocks on JPSS-2 and Aqua DB (at its default
# 2^18 the OQPSK rails slip half a symbol after ~3 blocks on JPSS, and Aqua
# DB's carrier a quarter turn at a seam, in both packages)
JPSS_BLOCK = 1 << 16


def _in_jpss(npp: bool):
    """JPSS-2 HRD: OQPSK at 25 Msym/s recorded at 40 Msps, sps 1.6, CADUs
    carrying a VIIRS segment of each band in JPSS_BANDS, 4 ATMS scans and an
    OMPS nadir frame; Suomi NPP HRD: QPSK at 15 Msym/s, 25 Msps,
    sps 5/3, one VIIRS band and an ATMS scan."""
    def make(rng, work):
        from satdump_tpu_torch import sim
        cadus, truth = sim.jpss_instrument_cadus(
            rng, ("M6",) if npp else JPSS_BANDS, 1 if npp else 4,
            0 if npp else 1, npp=npp, idle=6)
        bb = sim.ccsds_psk_baseband(
            cadus, rng, sim.NPP_HRD_SPS if npp else sim.JPSS_HRD_SPS,
            "qpsk" if npp else "oqpsk", nrzm=True)
        return _baseband(work, bb), dict(truth, cadus=cadus)
    return make


XRIT_SEGMENTS, XRIT_WIDTH, XRIT_LINES = 4, 400, 20
XRIT_EMWIN = b"ZCZC TEST EMWIN BULLETIN\r\n" * 40


def _in_xrit(rng, work):
    """GOES-R HRIT at 6 Msps carrying a Rice-coded ABI image in
    XRIT_SEGMENTS segments and an EMWIN text file."""
    from satdump_tpu_torch import sim
    cadus, full = sim.goes_hrit_xrit_cadus(rng, XRIT_SEGMENTS, XRIT_WIDTH,
                                           XRIT_LINES, XRIT_EMWIN)
    return _baseband(work, sim.ccsds_psk_baseband(
        cadus, rng, sim.GOES_HRIT_SPS, "bpsk", nrzm=True)), \
        {"cadus": cadus, "image": full}


def _in_aqua(rng, work):
    """Aqua DB: OQPSK 7.5 Msym/s at 15 Msps, sps 2 (the strip path)."""
    from satdump_tpu_torch import sim
    cadus, _ = sim.aqua_modis_cadus(rng, 24)
    return _baseband(work, sim.aqua_db_baseband(cadus, rng)), \
        {"cadus": cadus}


GVAR_VIS_BLOCKS = 2


def _in_gvar(rng, work):
    """GOES GVAR: BPSK 2.11 Msym/s at 6 Msps (K2)."""
    from satdump_tpu_torch import sim
    frames, _, vis = sim.gvar_imager_frames(rng, 3, GVAR_VIS_BLOCKS)
    return _baseband(work, sim.gvar_baseband(frames, rng)), {"vis": vis}


SD_FRAMES = 400


def _in_goesn_sd(rng, work):
    """GOES-N sensor data: BPSK 2.621 Msym/s at 6 Msps (K2)."""
    from satdump_tpu_torch import sim
    bits, payloads = sim.goesn_sd_bits(rng, SD_FRAMES)
    return _baseband(work, sim.goesn_sd_baseband(bits, rng)), \
        {"payloads": payloads}


M10_FRAMES, ORBCOMM_FRAMES = 3, 3


def _in_m10(rng, work):
    from satdump_tpu_torch import sim
    return _baseband(work, sim.fsk_baseband(sim.m10_channel_bits(
        rng, M10_FRAMES), 96e3, 9600, rng, 4800.0)), {}


def _in_orbcomm(rng, work):
    from satdump_tpu_torch import sim
    return _baseband(work, sim.fsk_baseband(sim.orbcomm_channel_bits(
        rng, ORBCOMM_FRAMES), 48e3, 4800, rng, 2400.0)), {}


# the xRIT image decoders. Segments are cut in lines only: 32 lines at
# MSU-GS's full-disk 2,784 columns (ELEKTRO) and 8 at GK-2A LRIT's
# full-disk 2,200 (every GK-2A channel, its J2K channel a 12-bit scene
# encoded by the port's compress_j2k); GRB's ABI blocks are 32 rows of
# MESO's 500, cut from one 12-bit scene and encoded by the port
XRIT2_SEGMENTS, XRIT2_WIDTH, XRIT2_LINES = 2, 2784, 32
GK2A_WIDTH, GK2A_LINES = 2200, 8
GRB2_RATE, GRB2_BLOCKS, GRB2_FLASHES = 2 * 8_665_938, 8, 5


def _in_elektro_hrit(rng, work):
    """ELEKTRO-L HRIT at its file's 3 Msps (1.157 Msym/s QPSK, sps 2.593:
    K2 picks the symbols): 8-bit JPEG and 10-bit wavelet segments."""
    from satdump_tpu_torch import sim
    files, truth = sim.elektro_xrit_files(rng, XRIT2_SEGMENTS, XRIT2_WIDTH,
                                          XRIT2_LINES)
    cadus = sim.xrit_geo_cadus(files)
    return _baseband(work, sim.ccsds_psk_baseband(
        cadus, rng, sim.ELEKTRO_HRIT_SPS, "qpsk")), dict(truth, cadus=cadus)


def _in_gk2a(rng, work):
    """GK-2A HRIT at its file's 6 Msps (3 Msym/s QPSK, sps 2: the strip
    path): encrypted, 8- and 12-bit JPEG and J2K segments (one behind the
    UHRIT preamble) and an additional-data file."""
    from satdump_tpu_torch import sim
    files, keyfile, truth = sim.gk2a_xrit_files(rng, GK2A_WIDTH, GK2A_LINES)
    cadus = sim.xrit_geo_cadus(files)
    src = _baseband(work, sim.ccsds_psk_baseband(cadus, rng, (2, 1), "qpsk"))
    (work / "keys.bin").write_bytes(keyfile)
    return src, dict(truth, cadus=cadus)


def _in_grb_products(rng, work):
    """GOES-R GRB at 2 sps: ABI MESO-1 channel 13 in J2K blocks of 32 rows
    at 500 columns (GRB2_BLOCKS blocks of one 12-bit scene, encoded by the
    port's compress_j2k, each decoding to its rows) and a GLM flash
    frame."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.j2k import compress_j2k, decompress_j2k
    from satdump_tpu_torch.models.goes_grb import ABI_CHANNEL_PARAMS
    from satdump_tpu_torch.ops.dvbs2 import tx
    depth = ABI_CHANNEL_PARAMS[13][1]
    scene = sim.smooth_scene(rng, 32 * GRB2_BLOCKS, 500, depth)
    blocks = []
    for k in range(GRB2_BLOCKS):
        rows = scene[32 * k: 32 * (k + 1)]
        cs = compress_j2k(rows)
        assert np.array_equal(decompress_j2k(cs), rows), f"block {k}"
        blocks.append((cs, rows))
    cadus, truth = sim.grb_abi_cadus(rng, blocks, glm_flashes=GRB2_FLASHES)
    # fill behind the data: the extractor's look-ahead ends two BBFrames
    # before the stream does
    fill = sim.grb_cadus([], 5, idle=12)
    syms = tx.bbframes_to_symbols(sim.grb_bbframes(
        np.concatenate([cadus, fill])), 11, False, False).ravel()
    return _baseband(work, sim.dvbs2_baseband(syms, rng)), \
        dict(truth, depth=depth)


# the checks against what was sent: check(out_dir, outs, truth)

def _sent_cadus(level: str = "cadu"):
    def check(d, outs, truth):
        got = _check_cadus(outs[level], truth["cadus"])
        if truth.get("all"):
            assert len(got) == len(truth["cadus"])
    return check


def _meteor_products(d, outs, truth):
    _check_cadus(outs["cadu"] if "cadu" in outs else
                 next(d.glob("*.cadu")), truth["cadus"])
    _check_msumr(d / "MSU-MR", truth["msumr"])


def _apt(d, outs, truth):
    """The synced image holds sync A at every line start and follows the
    lines sent."""
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.models.noaa_apt import SYNC_A
    img = load_img(d / "AVHRR" / "raw_sync.png").astype(float)
    assert img.shape == (APT_LINES, 2080)
    body = img[1:-1]
    pat = SYNC_A - SYNC_A.mean()
    sync = (body[:, :len(SYNC_A)] @ pat).min()
    data = np.abs(body[:, 500:500 + len(SYNC_A)] @ pat).max()
    corr = min(np.corrcoef(g[100:1900], t[100:1900])[0, 1]
               for g, t in zip(body, truth["lines"][1:-1]))
    assert sync > 2 * data and corr > 0.5, (sync, data, corr)


def _ber_check(d, outs, truth):
    """Hard decisions against the bits sent (polarity free: the loops lock
    either way), over the soft stream's middle half, at the best lag within
    64 symbols."""
    s = np.fromfile(outs["soft"], np.int8) > 0
    bits = truth["bits"]
    a, b = len(s) // 4, 3 * len(s) // 4
    best = 1.0
    for lag in range(-64, 65):
        if a - lag < 0 or b - lag > len(bits):
            continue
        e = float(np.mean(s[a:b] != bits[a - lag: b - lag]))
        best = min(best, e, 1 - e)
    assert best <= truth["ber"], best


def _frames_check(d, outs, truth):
    """The .frm holds every frame sent, in order, bit-exact behind the
    ASM, each with a valid CRC-16."""
    from satdump_tpu_torch.ops.fec.crc import crc_ccitt
    frames = truth["frames"]
    got = np.fromfile(outs["cadu"], np.uint8).reshape(-1, 4 + frames.shape[1])
    assert len(got) == len(frames) and np.array_equal(got[:, 4:], frames)
    assert all(crc_ccitt.compute(g[4:-2]) == (int(g[-2]) << 8 | int(g[-1]))
               for g in got)


def _orion_check(d, outs, truth):
    assert Path(outs["cadu"]).read_bytes() == truth["bytes"]


def _dsb_check(d, outs, truth):
    assert (d / "noaa_dsb.tip").read_bytes() == truth["tips"]


def _grb_check(d, outs, truth):
    """Every CADU out one that was sent, and at least the `n` that the
    data frames hold less 2 at the edges."""
    got = np.fromfile(outs["cadu"], np.uint8).reshape(-1, 2048)
    sent = {c.tobytes() for c in truth["cadus"]}
    assert sum(g.tobytes() not in sent for g in got) == 0
    assert len(got) >= truth["n"] - 2, (len(got), truth["n"])


def _dvbs2_check(d, outs, truth):
    got = np.fromfile(outs["ts"], np.uint8).reshape(-1, 188)
    sent = {r.tobytes() for r in truth["ts"]}
    assert sum(g.tobytes() not in sent for g in got) == 0
    assert len(got) >= S2_TS_PACKETS * 9 // 10, len(got)


def _fy3ab_check(d, outs, truth):
    from satdump_tpu_torch.products.product import load_product
    assert (d / "fengyun3_ab_ahrpt.cadu").read_bytes() == truth["cadus_bytes"]
    virr = load_product(str(d / "VIRR")).get_channel("1").image
    assert np.array_equal(virr // 64, truth["virr"])


def _gac_check(d, outs, truth):
    from satdump_tpu_torch.products.product import load_product
    assert Path(outs["frm"]).stat().st_size // 4159 == HRPT_GAC_FRAMES
    img = load_product(str(d / "AVHRR")).get_channel("1").image
    assert np.array_equal(img >> 6, truth["lines"][:, :, 0])


def _noaa_hrpt_check(d, outs, truth):
    from satdump_tpu_torch.products.product import load_product
    got = np.fromfile(outs["frm"], "<u2").reshape(-1, 11090)
    assert len(got) == 5 and np.array_equal(got[:, 6:],
                                            truth["words"][:, 6:])
    img = load_product(str(d / "AVHRR")).get_channel("2").image
    assert np.array_equal(img >> 6, truth["lines"][:, :, 1])


def _meteor_hrpt_check(d, outs, truth):
    from satdump_tpu_torch.products.product import load_product
    assert Path(outs["cadu"]).read_bytes() == truth["bytes"]
    img = load_product(str(d / "MSU-MR")).get_channel("1").image
    assert np.array_equal(img >> 6, truth["imgs"][:, 0])


def _inmarsat_check(d, outs, truth):
    """STD-C decodes every frame; Aero passes some over (see _in_aero).
    Every message out is the one sent."""
    n_frm = len(Path(outs["frm"]).read_bytes()) // truth["frame_bytes"]
    msgs = _tree(d, "*.json")
    texts = {json.loads(v).get("message") for k, v in msgs.items()
             if k.startswith(("ACARS", "Full Message"))}
    assert n_frm >= truth["need"] and texts == {truth["text"]}, \
        (n_frm, texts)


def _jpss_check(d, outs, truth):
    """VIIRS, ATMS and OMPS products hold what was sent."""
    from satdump_tpu_torch.image.geometry import correct_generic_bowtie
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.models.jpss import VIIRS_CHANNELS
    from satdump_tpu_torch.products.product import load_product
    _check_cadus(outs["cadu"], truth["cadus"])
    vp = load_product(str(d / "VIIRS"))
    for band, rows in truth["viirs"].items():
        h = VIIRS_CHANNELS[band].zone_height
        want = correct_generic_bowtie(rows, h, 1.0 / 1.9, 0.52333)
        assert np.array_equal(vp.get_channel(band.lower()).image[:h], want), \
            band
    ap = load_product(str(d / "ATMS"))
    for c in range(22):
        assert np.array_equal(ap.get_channel(str(c + 1)).image,
                              truth["atms"][:, c, :96][:, ::-1]), c + 1
    if len(truth["omps"]):
        omps = load_img(d / "OMPS" / "Nadir" / "OMPS-Nadir-1.png")
        assert np.array_equal(omps, truth["omps"][:, 0])


def _xrit_check(d, outs, truth):
    from satdump_tpu_torch.image.io import load_img
    _check_cadus(outs["cadu"], truth["cadus"])
    assert np.array_equal(load_img(d / "IMAGES" / "GOES-16_13_7.png"),
                          truth["image"])
    assert (d / "EMWIN" / "A_EMWIN_TEST.txt").read_bytes() == XRIT_EMWIN


def _aqua_check(d, outs, truth):
    from satdump_tpu_torch.products.product import load_product
    _check_cadus(outs["cadu"], truth["cadus"])
    modis = load_product(str(d / "MODIS"))
    assert modis.get_channel("1").image.shape[1] == 1354 * 4


def _gvar_check(d, outs, truth):
    from satdump_tpu_torch.products.product import load_product
    img = load_product(str(d / "IMAGER")).images[0].image
    for k in range(GVAR_VIS_BLOCKS):
        assert np.array_equal(img[3 * 8 + k] >> 6, truth["vis"][k]), k


def _goesn_sd_check(d, outs, truth):
    """A 14-bit marker with no check on the frame: the random bits around
    the frames may hold one, as on the air, so count the frames sent."""
    got = {g.tobytes() for g in
           np.fromfile(outs["frm"], np.uint8).reshape(-1, 60)}
    found = sum(p.tobytes() in got for p in truth["payloads"])
    assert found >= SD_FRAMES - 2, found


def _m10_check(d, outs, truth):
    assert len(json.loads((d / "m10_track.json").read_text())) == M10_FRAMES


def _orbcomm_check(d, outs, truth):
    eph = [p["scid"] for p in json.loads((d / "orbcomm.json").read_text())
           if p["type"] == "ephemeris"]
    assert eph == list(range(105, 105 + ORBCOMM_FRAMES)), eph


def _elektro_hrit_check(d, outs, truth):
    """The wavelet image equals what was sent, the JPEG image the CPU's
    decode of the segments sent."""
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.image.jpeg import decode_jpeg_gray
    _check_cadus(outs["cadu"], truth["cadus"])
    i = d / "IMAGES" / "MSU-GS"
    jpeg = np.concatenate([decode_jpeg_gray(j, "cpu") for j in truth["jpeg"]])
    assert np.array_equal(load_img(i / "MSU-GS_GOMS3_ch9_202601010000.png"),
                          truth["wt"])
    assert np.array_equal(load_img(i / "MSU-GS_GOMS3_ch5_202601010000.png"),
                          jpeg)


def _gk2a_check(d, outs, truth):
    """The encrypted and J2K images equal what was sent (SW038: the 12-bit
    scene at the decoder's 16-bit scale), the JPEG images the CPU's decode
    of the segments sent."""
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.image.j2k import decompress_j2k
    from satdump_tpu_torch.image.jpeg12 import decompress_jpeg12
    _check_cadus(outs["cadu"], truth["cadus"])
    assert np.array_equal(np.concatenate([decompress_j2k(c)
                                          for c in truth["j2k"]]),
                          truth["sw038"])
    want = {"WV069": truth["wv069"], "SW038": truth["sw038"] << 4,
            "VI006": np.concatenate([decompress_jpeg12(j)
                                     for j in truth["jpeg8"]]),
            "IR105": np.concatenate([decompress_jpeg12(j)
                                     for j in truth["jpeg12"]])}
    for ch, img in want.items():
        assert np.array_equal(load_img(d / "IMAGES" / "AMI" /
                                       f"AMI_{ch}_20260101000000.png"), img), \
            ch


def _grb_products_check(d, outs, truth):
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.models.goes_grb import GLM_FLASH, parse_glm_frame
    img = load_img(next((d / "ABI" / "MESO1").rglob("ABI_MESO1_13_*.png")))
    n = len(truth["image"])
    assert np.array_equal(img[:n], truth["image"] << (16 - truth["depth"]))
    assert not img[n:].any()
    glm = json.loads(next((d / "GLM" / "Flash").glob("*.json")).read_text())
    assert glm == json.loads(json.dumps(parse_glm_frame(truth["glm"],
                                                        GLM_FLASH)))


BB_CADU = ("baseband", "cadu")
BB_PRODUCTS = ("baseband", "products")
STAGED = ("baseband", "soft", "cadu", "products")

PASSES = (
    # a 12-CADU MetOp AHRPT pass (6 Msps, sps 18/7) and a METEOR-M2 LRPT one
    # (280 ksps, sps 35/9) of two strips of MSU-MR channels 1-3; m2x_mode:
    # the MSU-MR day from the packets, not from the wall clock
    Pass("metop_ahrpt 12 CADUs", 5, "MetOp.json", "metop_ahrpt", BB_CADU,
         _in_metop_small, _sent_cadus(), cpu_from="baseband",
         files=("metop_ahrpt.cadu",)),
    Pass("meteor_m2_lrpt 280 ksps to products", 6, "Meteor-M.json",
         "meteor_m2_lrpt", BB_PRODUCTS, _in_meteor_small, _meteor_products,
         params={"samplerate": 280e3, "m2x_mode": True},
         cpu_from="baseband", files=("meteor_m2_lrpt.cadu",)),
    # the resampled pipelines at their default rates: METEOR-M2-x at 1 Msps
    # (OQPSK, NRZ-M; 18 strips in one default psk_demod block of 125 * 2^18
    # samples), METEOR-M2 at 1 Msps (2 strips), GOES-R HRIT at 6 Msps (BPSK,
    # NRZ-M; 79 CADUs, ~2^23 samples), NOAA APT at 1 Msps (40 lines)
    Pass("meteor_m2x_lrpt 1 Msps", 10, "Meteor-M.json", "meteor_m2x_lrpt",
         ("baseband", "cadu", "products"), _in_meteor_1msps(18, True),
         _meteor_products, need={"cadu": K1K2}, cpu_from="baseband",
         files=("meteor_m2x_lrpt.cadu",)),
    Pass("meteor_m2_lrpt 1 Msps", 11, "Meteor-M.json", "meteor_m2_lrpt",
         ("baseband", "cadu", "products"), _in_meteor_1msps(2, False),
         _meteor_products, params={"m2x_mode": True}, need={"cadu": K1K2},
         cpu_from="baseband", files=("meteor_m2_lrpt.cadu",)),
    Pass("goes_hrit 6 Msps", 12, "GOES.json", "goes_hrit", BB_CADU,
         _in_goes_hrit, _sent_cadus(), need={"cadu": K1K2},
         cpu_from="baseband", files=("goes_hrit.cadu",)),
    Pass("noaa_apt 1 Msps", 13, "NOAA.json", "noaa_apt", BB_PRODUCTS,
         _in_apt, _apt, cpu_from="baseband", files=("AVHRR/*.png",)),
    # the classic demod chain: INTEGRAL S-band at 2.096 Msps (pm_demod ->
    # ccsds_conv_concat_decoder, bpsk_90, RS(255,239) x 4; ~2^21 samples),
    # NOAA HRPT's pm_demod and Crew Dragon's fsk_demod, ~2^23 samples each
    # to .soft held to the bits sent; ELEKTRO-L GGAK, SpaceTeamSat1 9k6 and
    # Saral on the card and the CPU
    Pass("integral_s_link 2.096 Msps", 20, "Integral.json",
         "integral_s_link", BB_CADU, _in_integral, _sent_cadus(),
         params={"samplerate": 2.096e6},
         need={"cadu": ("viterbi_re",) + WALKERS}),
    Pass("noaa_hrpt pm_demod 3 Msps", 21, "NOAA.json", "noaa_hrpt",
         ("baseband", "soft"), _in_pm_hrpt_soft, _ber_check,
         params={"samplerate": 3e6}, need={"soft": WALKERS}),
    Pass("crew_dragon_tlm fsk_demod 6 Msps", 22, "SpaceX.json",
         "crew_dragon_tlm", ("baseband", "soft"), _in_fsk_dragon_soft,
         _ber_check, params={"samplerate": 6e6},
         need={"soft": ("agc_walk", "mm_walk")}),
    Pass("elektro_ggak 40 ksps", 23, "Elektro_Arktika.json", "elektro_ggak",
         BB_CADU, _in_elektro_ggak, _sent_cadus(),
         params={"samplerate": 40e3}, need={"cadu": WALKERS},
         cpu_from="baseband", files=("elektro_ggak.cadu",)),
    Pass("sts1_9k6 140 ksps", 24, "spaceteamsat1.json", "sts1_9k6", BB_CADU,
         _in_sts1, _sent_cadus(), need={"cadu": ("agc_walk", "mm_walk")},
         cpu_from="baseband", files=("sts1_9k6.cadu",)),
    Pass("saral_dump rs_i 5, 40 Msps", 25, "Saral.json", "saral_dump",
         BB_CADU, _in_saral, _sent_cadus(), params={"samplerate": 40e6},
         need={"cadu": K1K2}, cpu_from="baseband",
         files=("saral_dump.cadu",)),
    # the deep-space FEC. The decoders hold their correlation to 0.5 of
    # softs at full scale (127) by default, as in the JAX package, where
    # pm_demod's softs sit near +-19 and psk_demod's near +-55: the baseband
    # passes set the threshold below their demod's scale and above the best
    # match that noise of that scale reaches over a block
    Pass("juice_x_link 2.105 Msps", 30, "Juice.json", "juice_x_link",
         BB_CADU, _in_juice, _frames_check,
         params={"samplerate": 2_105_264, "correlator_threshold": 0.1},
         need={"cadu": WALKERS + ("turbo_bcjr",)}),
    Pass("tgo_link from .soft", 31, "TGO.json", "tgo_link", ("soft", "cadu"),
         _in_tgo, _frames_check, need={"cadu": ("turbo_bcjr",)}),
    Pass("goes_raw_sounder_data 2 Msps", 32, "GOES.json",
         "goes_raw_sounder_data", BB_CADU, _in_sounder, _sent_cadus(),
         params={"samplerate": 2e6, "corr_threshold": 0.3},
         need={"cadu": ("resample_arith_grid",)}, cpu_from="baseband",
         files=("goes_raw_sounder_data.cadu",)),
    Pass("orion_link from .soft", 33, "Orion.json", "orion_link",
         ("soft", "cadu"), _in_orion, _orion_check, cpu_from="soft",
         files=("orion_link.cadu",)),
    # DVB-S2: GOES-R GRB at full width (8,665,938 sym/s, QPSK 9/10 = MODCOD
    # 11, normal frames, at 2 sps = 17.33 Msps; 67 PLFRAMEs, ~4.36 M
    # samples) on the card; the same pipeline on 9 PLFRAMEs on the card
    # and the CPU; the `dvbs2` pipeline on 200 TS packets
    Pass("goes_grb 17.33 Msps", 40, "GOES.json", "goes_grb", BB_CADU,
         _in_grb(65), _grb_check, params={"samplerate": GRB2_RATE},
         need={"cadu": ("agc_walk", "resample_strip")}),
    Pass("goes_grb 9 PLFRAMEs", 41, "GOES.json", "goes_grb", BB_CADU,
         _in_grb(7), _grb_check, params={"samplerate": GRB2_RATE},
         cpu_from="baseband", files=("goes_grb.bbframe", "goes_grb.cadu")),
    Pass("dvbs2 MODCOD 4 short", 42, "DVB-S2.json", "dvbs2",
         ("baseband", "ts"), _in_dvbs2, _dvbs2_check,
         params={"samplerate": 2e6, "shortframes": True},
         need={"ts": ("agc_walk",)}),
    # FengYun-3, the HRPT family and Inmarsat
    Pass("fengyun3_d_ahrpt 90 Msps", 50, "FengYun-3.json",
         "fengyun3_d_ahrpt", ("baseband", "soft", "cadu"), _in_fy3d,
         _sent_cadus(), params={"samplerate": 90e6},
         need={"soft": ("resample_strip",), "cadu": ("viterbi_re",)}),
    Pass("fengyun3_ab_ahrpt 8.4 Msps", 51, "FengYun-3.json",
         "fengyun3_ab_ahrpt", BB_PRODUCTS, _in_fy3ab, _fy3ab_check,
         params={"samplerate": 8.4e6}, cpu_from="baseband",
         files=("fengyun3_ab_ahrpt.cadu",)),
    Pass("noaa_gac 6 Msps", 52, "NOAA.json", "noaa_gac",
         ("baseband", "soft", "frm", "products"), _in_gac, _gac_check,
         params={"samplerate": 6e6, "year_override": HRPT_YEAR},
         need={"soft": ("resample_arith_grid",)}, cpu_from="frm"),
    Pass("noaa_hrpt 3 Msps", 53, "NOAA.json", "noaa_hrpt",
         ("baseband", "soft", "frm", "products"), _in_noaa_hrpt,
         _noaa_hrpt_check, params={"samplerate": 3e6},
         need={"soft": WALKERS}, cpu_from="soft", files=("*.frm",)),
    Pass("meteor_hrpt 3 Msps", 54, "Meteor-M.json", "meteor_hrpt", STAGED,
         _in_meteor_hrpt, _meteor_hrpt_check,
         params={"samplerate": 3e6, "year_override": HRPT_YEAR},
         need={"soft": WALKERS}, cpu_from="soft", files=("*.cadu",)),
    Pass("noaa_dsb from .soft", 55, "NOAA.json", "noaa_dsb",
         ("soft", "products"), _in_dsb, _dsb_check,
         params={"year_override": HRPT_YEAR}, cpu_from="soft",
         files=("*.tip",)),
    Pass("inmarsat_std_c 48 ksps", 56, "Inmarsat.json", "inmarsat_std_c",
         ("baseband", "soft", "frm", "msg"), _in_stdc, _inmarsat_check,
         params={"samplerate": 48e3, "start_timestamp": INM_START},
         cpu_from="soft", files=("*.frm", "*.json")),
    Pass("inmarsat_aero_105 12 ksps", 57, "Inmarsat.json",
         "inmarsat_aero_105", ("baseband", "soft", "frm", "msg"),
         _in_aero("inmarsat_aero_105"), _inmarsat_check,
         params={"samplerate": 12e3, "start_timestamp": INM_START},
         cpu_from="soft", files=("*.frm", "*.json")),
    Pass("inmarsat_aero_12 48 ksps", 58, "Inmarsat.json",
         "inmarsat_aero_12", ("baseband", "soft", "frm", "msg"),
         _in_aero("inmarsat_aero_12"), _inmarsat_check,
         params={"samplerate": 48e3, "start_timestamp": INM_START},
         cpu_from="soft", files=("*.frm", "*.json")),
    # JPSS HRD, GOES HRIT's products level and the host decoders
    Pass("jpss_hrd 40 Msps", 60, "JPSS.json", "jpss_hrd", STAGED,
         _in_jpss(False), _jpss_check,
         first={"samplerate": 40e6, "buffer_size": JPSS_BLOCK},
         need={"*": K1K2}, cpu_from="baseband",
         files=("jpss_hrd.cadu", "*.png")),
    Pass("npp_hrd 25 Msps", 61, "JPSS.json", "npp_hrd", STAGED,
         _in_jpss(True), _jpss_check, first={"samplerate": 25e6},
         need={"*": K1K2}, cpu_from="baseband",
         files=("npp_hrd.cadu", "*.png")),
    Pass("goes_hrit xRIT 6 Msps", 62, "GOES.json", "goes_hrit", STAGED,
         _in_xrit, _xrit_check, first={"samplerate": 6e6}, need={"*": K1K2},
         cpu_from="baseband",
         files=("goes_hrit.cadu", "IMAGES/*.png", "EMWIN/*")),
    Pass("aqua_db 15 Msps", 63, "EOS.json", "aqua_db", STAGED, _in_aqua,
         _aqua_check, first={"samplerate": 15e6, "buffer_size": JPSS_BLOCK},
         cpu_from="baseband", files=("aqua_db.cadu",)),
    Pass("goes_gvar 6 Msps", 64, "GOES.json", "goes_gvar",
         ("baseband", "soft", "gvar", "products"), _in_gvar, _gvar_check,
         first={"samplerate": 6e6}, need={"*": ("resample_arith_grid",)},
         cpu_from="baseband", files=("goes_gvar.gvar",)),
    Pass("goesn_sd 6 Msps", 65, "GOES.json", "goesn_sd",
         ("baseband", "soft", "frm"), _in_goesn_sd, _goesn_sd_check,
         first={"samplerate": 6e6}, need={"*": ("resample_arith_grid",)},
         cpu_from="baseband", files=("goesn_sd.frm",)),
    Pass("radiosonde_m10 96 ksps", 66, "Radiosonde.json", "radiosonde_m10",
         ("baseband", "soft", "frames"), _in_m10, _m10_check,
         first={"samplerate": 96e3}, need={"*": ("agc_walk", "mm_walk")},
         cpu_from="baseband",
         files=("radiosonde_m10.frm", "m10_track.json")),
    Pass("orbcomm_stx 48 ksps", 67, "Orbcomm.json", "orbcomm_stx",
         ("baseband", "soft", "frm", "packets"), _in_orbcomm, _orbcomm_check,
         first={"samplerate": 48e3}, need={"*": ("agc_walk", "mm_walk")},
         cpu_from="baseband", files=("orbcomm_stx.frm", "orbcomm.json")),
    # the xRIT image decoders and GOES-R GRB's products on the port's own
    # codecs
    Pass("elektro_hrit 3 Msps", 70, "Elektro_Arktika.json", "elektro_hrit",
         STAGED, _in_elektro_hrit, _elektro_hrit_check,
         first={"samplerate": 3e6}, need={"*": K1K2}, cpu_from="baseband",
         files=("elektro_hrit.cadu", "*.png")),
    Pass("gk2a_hrit 6 Msps", 71, "GK2A.json", "gk2a_hrit", STAGED, _in_gk2a,
         _gk2a_check, params={"gk2a_keys": "{work}/keys.bin"},
         first={"samplerate": 6e6}, need={"*": ("viterbi_re",)},
         cpu_from="baseband", files=("gk2a_hrit.cadu", "*.png", "ADD/*")),
    Pass("goes_grb products 17.33 Msps", 72, "GOES.json", "goes_grb",
         ("baseband", "bbframe", "cadu", "products"), _in_grb_products,
         _grb_products_check, first={"samplerate": GRB2_RATE},
         cpu_from="baseband", files=("goes_grb.cadu", "*.png", "*.json")),
)


@pytest.mark.card
@pytest.mark.parametrize("p", PASSES, ids=[p.id for p in PASSES])
def test_pass_on_the_card_equals_the_cpu_and_what_was_sent(p, card,
                                                           tmp_path):
    src, truth = p.make(_rng(p.seed), tmp_path)
    outs, launches = _run(p, src, tmp_path, card)
    for level, names in p.need.items():
        got = launches.get(level) if level != "*" else {
            k: sum(ln[k] for ln in launches.values()) for k in ALL_KERNELS}
        assert_launched(got, names, f"{p.id} -> {level}")
    if p.cpu_from is not None:
        start = p.levels.index(p.cpu_from)
        _run(p, src, tmp_path, "cpu", start,
             first_input=outs[p.cpu_from] if start else src)
        for pat in p.files:
            a, b = _tree(tmp_path / card, pat), _tree(tmp_path / "cpu", pat)
            assert a and a == b, \
                f"{pat} differs between cuda and cpu ({sorted(a)} / " \
                f"{sorted(b)})"
        if (tmp_path / card / "dataset.json").exists():
            _same_products(tmp_path / card, tmp_path / "cpu", p.id)
    p.check(tmp_path / card, outs, truth)


# ---- the main path, and what reads its output ------------------------------
# ~2^23 samples of MetOp AHRPT at 6 Msps (sps 18/7): 26 AVHRR lines and 8
# MHS lines between 4 idle frames make 399 CADUs
MAIN_AVHRR_LINES, MAIN_MHS_LINES, MAIN_IDLE = 26, 8, 2


@pytest.fixture(scope="module")
def main_pass(tmp_path_factory):
    """The main path on the card, baseband -> CADU -> products: (input,
    .cadu, CADUs sent, AVHRR/MHS truth, output dir, launches)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: runs on the card")
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.cuda import _build
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    _build.build()
    work = tmp_path_factory.mktemp("main")
    rng = _rng(6)
    data, truth = sim.metop_instrument_cadus(rng, MAIN_AVHRR_LINES,
                                             MAIN_MHS_LINES)
    idle = sim.idle_cadus(MAIN_IDLE)
    cadus = np.concatenate([idle, data, idle])
    src = _baseband(work, sim.ccsds_qpsk_baseband(cadus, rng, (18, 7)))
    out_dir = work / "out"
    cadu, launches = counted(lambda: run_pipeline(
        _pipeline("MetOp.json", "metop_ahrpt"), str(src), str(out_dir)),
        ALL_KERNELS)
    run_pipeline(_pipeline("MetOp.json", "metop_ahrpt", "cadu", "products"),
                 cadu, str(out_dir), start_level="cadu")
    return {"input": src, "cadu": Path(cadu), "cadus": cadus,
            "truth": truth, "out": out_dir, "launches": launches}


@pytest.mark.card
def test_main_path_baseband_to_products(main_pass, card):
    """Every CADU one that was sent, AVHRR and MHS equal to the lines sent,
    every autogen composite written; K1, K2 and K3 (the lock search)
    launched."""
    _check_cadus(main_pass["cadu"], main_pass["cadus"])
    _check_avhrr_mhs(main_pass["out"], main_pass["truth"])
    assert_launched(main_pass["launches"], K1K2 + (
        "viterbi_block_acs", "viterbi_block_traceback"), "main path")


@pytest.mark.card
def test_bitview_finds_the_cadu_period(main_pass, card, tmp_path):
    """`bitview` through the CLI on the main path's .cadu (the period it
    finds; given 8192 bits, every row starts with the ASM) and on CADUs of
    random payload (the period found: 8192 bits)."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    sim.make_cadus(400, _rng(18, 3)).tofile(tmp_path / "random.cadu")
    found = {}
    for name, src, opts in (("found", main_pass["cadu"], []),
                            ("given", main_pass["cadu"], ["--period",
                                                          "8192"]),
                            ("random", tmp_path / "random.cadu", [])):
        png = tmp_path / f"{name}.png"
        info = _cli_json(["bitview", str(src), "-o", str(png), *opts])
        raster = load_img(png)
        assert raster.shape == (min(info["bits"] // info["period"], 4096),
                                info["period"]), (name, raster.shape)
        found[name] = info["period"]
    asm = np.unpackbits(np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8)) * 255
    assert (load_img(tmp_path / "given.png")[:, :32] == asm).all()
    assert found["random"] == 8192, found


@pytest.mark.card
def test_sharded_pass_equals_the_single_device_one(main_pass, card,
                                                   tmp_path):
    """The main path's signal through psk_demod `multichip: true` on 4 ranks
    sharing the card (one process a rank, gloo between them; K2 and K3
    launched in the ranks), then metop_ahrpt_decoder (K1, and K3 in its
    lock search): the .cadu byte-equal to the single-device one."""
    from satdump_tpu_torch.parallel import timeshard
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    timeshard.set_virtual_devices(4)
    try:
        soft = run_pipeline(_pipeline("MetOp.json", "metop_ahrpt", "baseband",
                                      "soft"), str(main_pass["input"]),
                            str(tmp_path), user_params={"multichip": True})
        st = timeshard.run_sharded.last_stats
        cadu, launches = counted(lambda: run_pipeline(
            _pipeline("MetOp.json", "metop_ahrpt", "soft", "cadu"), soft,
            str(tmp_path), user_params={"multichip": True},
            start_level="soft"), ALL_KERNELS)
    finally:
        timeshard.set_virtual_devices(None)
    assert st and st["ranks"] == 4 and st["device"] == "cuda", st
    ranks = {k: sum(r["launches"][k] for r in st["rank"])
             for k in st["rank"][0]["launches"]}
    assert_launched(ranks, label="sharded pass, ranks")
    assert_launched(launches, ("viterbi_re", "viterbi_block_acs",
                               "viterbi_block_traceback"), "sharded decoder")
    _check_cadus(cadu, main_pass["cadus"])
    assert Path(cadu).read_bytes() == main_pass["cadu"].read_bytes()


# ---- products, MSU-MR's IDCT ------------------------------------------------
FULL_AVHRR_LINES, FULL_MHS_LINES = 1800, 112   # 5 minutes of AVHRR/3, MHS


@pytest.fixture(scope="module")
def full_pass(tmp_path_factory):
    """A 5-minute MetOp pass through metop_instruments (host) from the
    cadu level, once for the products and the projection tests: (the
    product directories' parent, AVHRR/MHS truth)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: runs on the card")
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.models.metop import MetOpInstrumentsDecoderModule
    work = tmp_path_factory.mktemp("full")
    cadus, truth = sim.metop_instrument_cadus(_rng(8), FULL_AVHRR_LINES,
                                              FULL_MHS_LINES)
    cadus.tofile(work / "full.cadu")
    MetOpInstrumentsDecoderModule(str(work / "full.cadu"),
                                  str(work / "out" / "metop_ahrpt"),
                                  {}).process()
    return work / "out", truth


@pytest.mark.card
def test_products_at_full_width_card_equals_cpu(full_pass, card, tmp_path):
    """The products processor on the card and on the CPU, each on its own
    copy of the 5-minute pass's product directories: the lines sent come
    out and every autogen composite is pixel-identical."""
    import shutil
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.products.processor import process_path
    products, truth = full_pass
    for d in ("cuda", "cpu"):
        shutil.copytree(products, tmp_path / d)
        process_path(str(tmp_path / d / "dataset.json"), device=d)
    base = tmp_path / "cuda"
    _check_avhrr_mhs(base, truth)
    for c in _autogen_composites(METOP_PRODUCTS):
        assert _same_images(load_img(base / c),
                            load_img(tmp_path / "cpu" / c)), c


IDCT_BLOCKS = (1600 // 8) * (1568 // 8) * 3   # a full METEOR pass's


@pytest.mark.card
def test_msumr_idct_card_within_1_lsb_of_the_cpu(card):
    """METEOR MSU-MR's dequantize + IDCT at a full pass's block count."""
    from satdump_tpu_torch.image import jpeg
    rng = _rng(9)
    # quantized coefficients falling off with zig-zag index, as a coded
    # image's are, each block with its own quality factor's table
    scale = 40.0 / (1.0 + np.arange(64))
    zz = np.round(rng.laplace(0, 1, (IDCT_BLOCKS, 64)) * scale
                  ).astype(np.int32)
    q = np.stack([jpeg.quantization_table(float(f))
                  for f in rng.integers(50, 96, IDCT_BLOCKS)])
    got = jpeg.dequantize_idct(zz, q, device=card)
    ref = jpeg.dequantize_idct(zz, q, device="cpu")
    assert np.abs(got.astype(np.int16) - ref).max() <= 1


# ---- passes with their own shape --------------------------------------------

@pytest.mark.card
def test_freq_shift_dc_block_doppler_pass_card_equals_cpu(card, tmp_path):
    """METEOR-M2 LRPT at 1 Msps with a DC term, a carrier offset of -3 kHz
    and a Doppler ramp of 2-6 kHz: psk_demod with dc_block, freq_shift 3000
    and a Doppler provider, then meteor_lrpt_decoder; K1 and K2 launched,
    the .cadu byte-identical and holding the CADUs sent."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.pipeline.module import (module_registry,
                                                   register_all_modules)
    rng = _rng(14)
    cadus = sim.make_cadus(8, rng)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS,
                                freq_offset=-3e-3, dc=0.05 + 0.03j)
    dop = np.linspace(2e3, 6e3, len(bb))
    bb = (bb * np.exp(2j * np.pi * np.cumsum(dop) / 1e6)).astype(np.complex64)
    dop = dop.astype(np.float32)
    src = _baseband(tmp_path, bb)

    def provider(pos, n):
        d = dop[pos: pos + n]
        return np.concatenate([d, np.full(n - len(d), dop[-1], np.float32)])

    register_all_modules()
    pipe = _pipeline("Meteor-M.json", "meteor_m2_lrpt")
    demod_p = pipe.prepare_parameters(pipe.steps[1], dict(
        freq_shift=3000.0, dc_block=True))
    dec_p = pipe.prepare_parameters(pipe.steps[2], {})

    def run(dev):
        (tmp_path / dev).mkdir()
        demod = module_registry.get("psk_demod")(
            str(src), str(tmp_path / dev / "m"),
            dict(demod_p, torch_device=dev))
        demod.doppler_provider = provider
        demod.process()
        dec = module_registry.get("meteor_lrpt_decoder")(
            demod.d_output_file, str(tmp_path / dev / "m"),
            dict(dec_p, torch_device=dev))
        dec.process()
        return dec.d_output_file
    out, launches = counted(lambda: run(card), ALL_KERNELS)
    assert_launched(launches, K1K2)
    _check_cadus(out, cadus)
    assert Path(out).read_bytes() == Path(run("cpu")).read_bytes()


DVBS_TS_PACKETS, DVBS_PUNCTURED = 128, "3/4"


@pytest.mark.card
def test_dvbs_demod_punctured_card_equals_cpu(card, tmp_path):
    """dvbs_demod at rate 3/4, found by its rate search (100 ksym/s at 220
    ksps): the .ts byte-identical and holding packets sent."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.pipeline.modules.dvbs2.dvbs import DVBSDemodModule
    rng = _rng(43)
    ts = rng.integers(0, 256, (DVBS_TS_PACKETS, 188)).astype(np.uint8)
    ts[:, 0] = 0x47
    bb = sim.ChannelModel(snr_db=17.0, freq_offset=1e-4, phase=0.3,
                          seed=int(rng.integers(1 << 30))).apply(
        sim.qpsk_modulate(sim.dvbs_symbols(ts, DVBS_PUNCTURED), sps=2.2,
                          rrc_alpha=0.35))
    src = _baseband(tmp_path, bb)
    got, stats = {}, {}
    for dev in (card, "cpu"):
        mod = DVBSDemodModule(str(src), str(tmp_path / dev), dict(
            samplerate=220e3, symbolrate=100e3, conv_rate="auto",
            torch_device=dev))
        mod.process()
        got[dev] = np.fromfile(mod.d_output_file, np.uint8)
        stats[dev] = mod.stats
    pk = got[card].reshape(-1, 188)
    sent = {r.tobytes() for r in ts}
    assert np.array_equal(got[card], got["cpu"])
    assert sum(g.tobytes() not in sent for g in pk) == 0
    assert len(pk) >= DVBS_TS_PACKETS // 2, len(pk)
    assert stats[card]["viterbi_rate"] == DVBS_PUNCTURED, stats


@pytest.mark.card
def test_dvbs2_demod_without_modcod_raises(card):
    """Its modcod, symbolrate and rrc_alpha come from the pipeline file's
    parameters block; a module given none raises, as in the JAX
    package."""
    from satdump_tpu_torch.core.exceptions import PipelineError
    from satdump_tpu_torch.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule
    with pytest.raises(PipelineError):
        DVBS2DemodModule("", "", {"samplerate": 2e6, "symbolrate": 1e6,
                                  "rrc_alpha": 0.25, "torch_device": card})


@pytest.mark.card
def test_network_server_sends_every_ts_packet(card, tmp_path):
    """dvbs2_test's last level: a .ts file's packets out of network_server
    (udp_send) to a receiver on localhost, every byte back."""
    from satdump_tpu_torch.io.net import UDPFrameReceiver
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    n = 70
    ts = _rng(15).integers(0, 256, (n, 188), dtype=np.uint8)
    ts[:, 0] = 0x47
    ts.tofile(tmp_path / "pass.ts")
    rx = UDPFrameReceiver(0, timeout=5.0)
    try:
        run_pipeline(_pipeline("DVB_Test.json", "dvbs2_test", "ts", "net"),
                     str(tmp_path / "pass.ts"), str(tmp_path),
                     user_params={"server_port": rx.port}, start_level="ts")
        got = b"".join(rx.recv(1316) or b"" for _ in range(n // 7))
    finally:
        rx.close()
    assert got == ts.tobytes()


@pytest.mark.card
def test_himawaricast_decoder_card_equals_cpu(card, tmp_path):
    """himawaricast_data_decoder from a .cadu of ten 16-bit segments (its
    pipeline feeds it BBFrames, which it reads as CADUs): the image equal to
    what was sent on both devices."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.xrit.geo import HimawariCastDataDecoderModule
    files, img = sim.himawari_xrit_files(_rng(73), 1100, 11)
    sim.xrit_geo_cadus(files).tofile(tmp_path / "h.cadu")
    for dev in (card, "cpu"):
        HimawariCastDataDecoderModule(str(tmp_path / "h.cadu"),
                                      str(tmp_path / dev / "x"),
                                      {"torch_device": dev}).process()
        got = load_img(tmp_path / dev / "IMAGES" / "AHI" /
                       "AHI_3_202601010000.png")
        assert np.array_equal(got, img << 6), dev


@pytest.mark.card
def test_j2k_fixtures_decode_as_their_manifest(card):
    """Every committed J2K codestream: its SHA-256 and its decode's as
    MANIFEST.json says."""
    import hashlib
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image import j2k
    manifest = json.loads((sim.J2K_TESTDATA / "MANIFEST.json").read_text())
    assert manifest
    for name, m in manifest.items():
        data = (sim.J2K_TESTDATA / name).read_bytes()
        img = j2k.decompress_j2k(data)
        assert hashlib.sha256(data).hexdigest() == m["sha256"], name
        assert hashlib.sha256(img.tobytes()).hexdigest() == \
            m["decoded_sha256"], name


@pytest.mark.card
@pytest.mark.parametrize("lossless", [True, False], ids=["5/3", "9/7"])
def test_j2k_encoder_round_trip(lossless, card):
    """The port's J2K encoder on a 32 x 2,200 12-bit segment (GK-2A's SW038
    at full width): its decode exact (5/3), within 4 levels (9/7)."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image import j2k
    img = sim.smooth_scene(_rng(74), 32, 2200, 12)
    data = j2k.compress_j2k(img, lossless=lossless)
    err = int(np.abs(j2k.decompress_j2k(data).astype(np.int64) - img).max())
    assert err <= (0 if lossless else 4), err


@pytest.mark.card
def test_islow_idct_card_equals_host(card):
    """The 8-bit JPEG decoder's islow IDCT on a segment at a full-disk
    product's size (464 x 2,784): the same pixels on the card and the
    host."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image import jpeg
    from satdump_tpu_torch.image.jpeg12 import compress_jpeg12
    img = sim.smooth_scene(_rng(75), 464, 2784, 8)
    data = compress_jpeg12(img, 8, quality_div=4)
    hdr = jpeg.parse_jfif_gray(data)
    zz = jpeg.huffman_decode_gray(hdr, data)
    assert np.array_equal(jpeg.idct_islow(zz, hdr["q"], card),
                          jpeg.idct_islow(zz, hdr["q"], "cpu"))


# ---- the live path -----------------------------------------------------------
LIVE_CHUNK = 1 << 16           # samples a remote-IQ packet
LIVE_BIT_DEPTH = 16


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_json(argv) -> dict:
    """The port's CLI in this process; its last stdout line as JSON."""
    from satdump_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, f"{argv[0]}: exit code {rc}"
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.card
def test_live_metop_over_tcp_equals_offline(card, tmp_path):
    """MetOp AHRPT (6 Msps, sps 18/7; 2^23 samples, 32 blocks) served
    unpaced by a RemoteIQServer thread at 16 bits and decoded through the
    CLI's `live metop_ahrpt tcp://...`, /status polled mid-pass: every CADU
    sent decoded, K1 and K2 launched, the .soft and .cadu byte-identical to
    run_pipeline's on the same samples."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import net
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    rng = _rng(17, 1)
    n_samples = 1 << 23
    up, down = sim.METOP_SPS
    n_cadus = (n_samples - 2048 * up // down) // (8192 * up // down)
    cadus = sim.make_cadus(n_cadus, rng)
    bb = sim.ccsds_qpsk_baseband(cadus, rng, sim.METOP_SPS)
    pad = n_samples - len(bb)
    bb = np.concatenate([bb, (0.05 * (rng.standard_normal(pad) + 1j *
                                      rng.standard_normal(pad)))
                         .astype(np.complex64)])
    # the packets, made before the server starts so that its thread only
    # sends bytes; what the client decodes off them is run_pipeline's input
    pkts = [net.encode_iq_pkt(bb[o: o + LIVE_CHUNK], LIVE_BIT_DEPTH)
            for o in range(0, len(bb), LIVE_CHUNK)]
    wire = _baseband(tmp_path / "wire", np.concatenate(
        [net.decode_iq_pkt(pk) for pk in pkts]))
    srv = net.RemoteIQServer(port=0, bit_depth=LIVE_BIT_DEPTH)
    http_port = _free_port()
    polled = {}

    def serve():
        try:
            srv.wait_client(timeout=60)
            for i, pk in enumerate(pkts):
                srv.send_pkt(pk)
                # mid-pass, until the pipeline has run a block
                url = f"http://127.0.0.1:{http_port}/status"
                deadline = time.monotonic() + 30
                while i == len(pkts) // 2 and not polled.get("blocks") \
                        and time.monotonic() < deadline:
                    with urllib.request.urlopen(url, timeout=30) as r:
                        polled.update(json.loads(r.read()))
                    time.sleep(0.05)
        except Exception as e:  # reported by the check after the pass
            polled["error"] = repr(e)
        finally:
            srv.end()

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    try:
        res, launches = counted(lambda: _cli_json([
            "live", "metop_ahrpt", f"tcp://127.0.0.1:{srv.port}",
            str(tmp_path / "live"), "--http-port", str(http_port)]),
            ALL_KERNELS)
    finally:
        server.join(timeout=60)
        srv.close()
    assert not server.is_alive() and polled.get("samples"), polled
    assert_launched(launches, K1K2, "live MetOp")
    soft, cadu = res["outputs"][:2]
    _check_cadus(cadu, cadus)
    off = run_pipeline(_pipeline("MetOp.json", "metop_ahrpt"), str(wire),
                       str(tmp_path / "offline"))
    assert Path(soft).read_bytes() == \
        (tmp_path / "offline" / "metop_ahrpt.soft").read_bytes()
    assert Path(cadu).read_bytes() == Path(off).read_bytes()


# one RTL-SDR class capture of the 137 MHz band, 2.048 Msps centred at 137.5
# MHz, 2^25 samples (16.4 s), carrying METEOR-M2-x (OQPSK, NRZ-M) at +400
# kHz and METEOR-M2 (QPSK) at -400 kHz, Meteor-M.json's 137.9 and 137.1 MHz,
# both 72 ksym/s: the default VFO rate (2.4 x 72k) snaps the decimation from
# 12 to 8, so each VFO runs at 256 ksps
VFO_FS = 2.048e6
VFO_SAMPLES = 1 << 25
VFO_BLOCK = 1 << 18
VFO_UP = 8                     # each carrier made at 256 ksps, then x8
VFO_NOISE = 0.02               # the wideband noise floor, each component
VFO_CARRIERS = (("a", 400e3, "meteor_m2x_lrpt", "oqpsk", True),
                ("b", -400e3, "meteor_m2_lrpt", "qpsk", False))
VFO_CPU_BLOCKS = 8
# tests/test_torch_vfo.py's tolerance for the FFT forms
VFO_ATOL = 2e-5


def _vfo_wideband(rng, dev):
    """The two METEOR carriers of VFO_CARRIERS, each made at 256 ksps
    (sim.ccsds_psk_baseband: RRC 0.5, 18 dB, a carrier offset), then on
    the card interpolated by VFO_UP (zero-stuffed, a 53 dB low-pass),
    mixed to its offset and summed over a noise floor of VFO_NOISE; returns
    (2.048 Msps complex64 samples, {name: CADUs sent})."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops import fir, firdes
    up, down = 32, 9                        # 256 ksps / 72 ksym/s
    n_cadus = (VFO_SAMPLES // VFO_UP - 2048 * up // down) // \
        (8192 * up // down)
    taps = firdes.low_pass(float(VFO_UP), VFO_FS, 100e3, 40e3)
    k = torch.arange(VFO_SAMPLES, dtype=torch.float64, device=dev)
    wide = torch.zeros(VFO_SAMPLES, dtype=torch.complex128, device=dev)
    truth = {}
    for name, off, _, const, nrzm in VFO_CARRIERS:
        cadus = sim.make_cadus(n_cadus, rng)
        bb = sim.ccsds_psk_baseband(cadus, rng, (up, down), const, nrzm=nrzm)
        x = torch.zeros(len(bb) * VFO_UP, dtype=torch.complex64, device=dev)
        x[::VFO_UP] = torch.from_numpy(bb).to(dev)
        _, y = fir.fir_apply(fir.fir_init(len(taps), device=dev), x, taps)
        ph = k[: len(y)] * (2 * np.pi * off / VFO_FS)
        wide[: len(y)] += y.to(torch.complex128) * torch.polar(
            torch.ones_like(ph), ph)
        truth[name] = cadus
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    noise = torch.randn((VFO_SAMPLES, 2), generator=g, device=dev)
    wide += torch.view_as_complex(noise * VFO_NOISE)
    return wide.to(torch.complex64).cpu().numpy(), truth


@pytest.mark.card
def test_live_two_vfos(card, tmp_path):
    """Two METEOR LRPT VFOs of one 2.048 Msps stream through `live --vfo`
    from a file: every CADU of each carrier decoded, K1 and K2 launched in
    each VFO; the channelizer's first blocks on the card within VFO_ATOL of
    the CPU's."""
    from satdump_tpu_torch.ops.vfo import VFOChannelizer
    wide, truth = _vfo_wideband(_rng(17, 2), card)
    src = _baseband(tmp_path, wide)
    res = _cli_json(["live", "-", f"file://{src}", str(tmp_path / "live"),
                     "--samplerate", str(VFO_FS)]
                    + [a for name, off, pid, _, _ in VFO_CARRIERS
                       for a in ("--vfo", f"{name}:{off:.0f}:{pid}")])
    for name, *_ in VFO_CARRIERS:
        # each VFO's launches: its LivePipeline's, counted around its blocks
        assert_launched(res["stats"][name]["launches"], K1K2, f"VFO {name}")
        cadu = [o for o in res["outputs"][name] if o.endswith(".cadu")][0]
        _check_cadus(cadu, truth[name], f"VFO {name}")
    chans = {d: VFOChannelizer(VFO_FS, VFO_BLOCK, device=d)
             for d in (card, "cpu")}
    for c in chans.values():
        for name, off, *_ in VFO_CARRIERS:
            c.add_vfo(name, off, 2.4 * 72e3)
    for b in range(VFO_CPU_BLOCKS):
        x = wide[b * VFO_BLOCK: (b + 1) * VFO_BLOCK]
        got, ref = chans[card].work(x), chans["cpu"].work(x)
        for n in got:
            err = float(np.abs(got[n] - ref[n]).max())
            assert err <= VFO_ATOL, (b, n, err)


# METEOR-M2 LRPT at 1 Msps carrying NOAA 19's predicted Doppler at 137.1 MHz
# over 2.5 of psk_demod's blocks centred on its highest point over LIVE_QTH
# (where the Doppler slews at ~21 Hz/s), so the pass crosses two block seams
LIVE_DOP_SAMPLES = 16_384_000
LIVE_DOP_FREQ = 137.1e6
# NOAA 19 (tests/test_torch_tracking.py's element set), the QTH and a time
# near the element set's epoch
LIVE_TLE = ("1 33591U 09005A   21100.47420639  .00000090  00000-0  74103-4 "
            "0  9998",
            "2 33591  99.1922 114.0067 0013577 245.5357 114.4418 "
            "14.12500029627277")
LIVE_QTH = (48.0, 2.0)
LIVE_T0 = 1618232411.0


def _cadu_count(out, cadus: np.ndarray) -> tuple:
    """(CADUs decoded that were sent, CADUs decoded that were not)."""
    got = np.fromfile(out, dtype=np.uint8).reshape(-1, cadus.shape[1])
    sent = {c.tobytes() for c in cadus}
    good = sum(g.tobytes() in sent for g in got)
    return good, len(got) - good


@pytest.mark.card
def test_live_doppler_card_equals_cpu(card, tmp_path):
    """A live pass with set_doppler on the tracker on the card and the CPU:
    every CADU, the same .cadu, and the provider asked at each block's
    absolute position for the Doppler put on the signal (within 0.01 Hz).
    A control pass on the card without set_doppler must lose CADUs."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.geo import TLE
    from satdump_tpu_torch.pipeline.live import LivePipeline
    from satdump_tpu_torch.tracking import ObjectTracker
    rng = _rng(17, 3)
    trk = ObjectTracker(TLE.parse("NOAA 19", *LIVE_TLE), *LIVE_QTH)
    ts = LIVE_T0 + np.arange(0, 86400, 30.0)
    fs = 1e6
    t0 = float(ts[np.argmax(trk.az_el(ts)[..., 1])]) \
        - LIVE_DOP_SAMPLES / fs / 2
    up, down = sim.METEOR_1M_SPS
    n_cadus = (LIVE_DOP_SAMPLES - 2048 * up // down) // (8192 * up // down)
    cadus = sim.make_cadus(n_cadus, rng)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS)
    step = 4096                          # set_doppler's grid

    def truth(pos: int, n: int) -> np.ndarray:
        grid = np.arange(0, n + step, step)
        return np.interp(np.arange(n), grid, trk.doppler_shift(
            t0 + (pos + grid) / fs, LIVE_DOP_FREQ))
    dop = truth(0, len(bb))
    bb = (bb * np.exp(2j * np.pi * np.cumsum(dop) / fs)).astype(np.complex64)

    def run(dev, doppler=True):
        lp = LivePipeline(_pipeline("Meteor-M.json", "meteor_m2_lrpt"),
                          str(tmp_path / f"{dev}_{doppler}"),
                          {"torch_device": dev})
        asked = []
        if doppler:
            lp.set_doppler(trk, LIVE_DOP_FREQ, fs, t0=t0)
            provider = lp.modules[0].doppler_provider

            def recorded(pos, n):
                asked.append((pos, n, provider(pos, n)))
                return asked[-1][2]
            lp.modules[0].doppler_provider = recorded
        out = lp.run_source(bb[o: o + LIVE_CHUNK]
                            for o in range(0, len(bb), LIVE_CHUNK))[1]
        return out, lp.block_size, asked
    (out, block, asked), launches = counted(lambda: run(card), ALL_KERNELS)
    assert_launched(launches, K1K2, "live Doppler")
    # the provider: one call a block at its absolute sample position,
    # giving the Doppler that was put on the signal there
    want = [(i * block, block) for i in range(-(-len(bb) // block))]
    assert [a[:2] for a in asked] == want
    dop_err = max(float(np.abs(d - truth(pos, n)).max())
                  for pos, n, d in asked)
    assert dop_err <= 0.01, dop_err
    _check_cadus(out, cadus)
    assert Path(out).read_bytes() == Path(run("cpu")[0]).read_bytes()
    good, bad = _cadu_count(run(card, doppler=False)[0], cadus)
    assert good < n_cadus - 2 or bad, \
        "the pass decodes without set_doppler, so it does not test it"


# ---- projection, ingest -----------------------------------------------------
GEO_CHANNELS = ("1", "2", "4")                 # the warped RGB's channels
GEO_OUT_WIDTH = 2048
GEO_CPU_WIDTH = 512           # the whole warp on both devices at this width
GEO_SMART_CPU = (2048, 512)   # the smart warp on both: width, tile
GEO_BAND_ROWS = 64            # rows of the full-width warp the CPU repeats
GEO_COORD_TOL = 1e-6          # px, card against CPU (float64 both)
GEO_PIXEL_SHARE = 1e-4        # of the pixels, each at most 1 LSB apart
GEO_GCP_TOL = 1e-2            # px, the spline at its own GCPs (reg 1e-6)


def _geo_close(a, b, what: str) -> None:
    """Card against CPU: at most GEO_PIXEL_SHARE of the pixels differ."""
    assert a.shape == b.shape and a.dtype == b.dtype, what
    n = int((a.astype(np.int64) != b.astype(np.int64)).sum())
    assert n <= max(1, GEO_PIXEL_SHARE * a.size), f"{what}: {n} differ"


@contextlib.contextmanager
def _spline_xy():
    """The output coordinates of every device evaluation of a
    ThinPlateSpline in the block."""
    from satdump_tpu_torch.geo import warp
    calls = []
    orig = warp.ThinPlateSpline._eval_torch

    def rec(self, flat, band=None):
        out = orig(self, flat, band)
        calls.append(out)
        return out
    warp.ThinPlateSpline._eval_torch = rec
    try:
        yield calls
    finally:
        warp.ThinPlateSpline._eval_torch = orig


def _latlon_to_xy(georef: dict, shape):
    h, w = shape[:2]

    def f(lon, lat):
        lon = np.asarray(lon, np.float64)
        if georef["lon_max"] > 180.0:
            lon = np.mod(lon + 360.0, 360.0)
        x = (lon - georef["lon_min"]) / (georef["lon_max"]
                                        - georef["lon_min"]) * (w - 1)
        y = (georef["lat_max"] - np.asarray(lat)) / (
            georef["lat_max"] - georef["lat_min"]) * (h - 1)
        return x, y
    return f


def _geo_overlays(img, georef, work: Path) -> None:
    """A grid, a GeoJSON map written here and city labels on the warped
    image, then its GeoTIFF and a read-back of the tags and the strip."""
    from satdump_tpu_torch.geo.shapefile import read_geojson
    from satdump_tpu_torch.image import geotiff, overlay, text
    lon0, lon1 = georef["lon_min"], georef["lon_max"]
    lat0, lat1 = georef["lat_min"], georef["lat_max"]
    wrap = (lambda v: (v + 180.0) % 360.0 - 180.0)
    lons = np.linspace(lon0, lon1, 50)
    feats = [{"type": "Feature", "geometry": {
        "type": "LineString", "coordinates": [
            [float(wrap(x)), float(lat0 + (lat1 - lat0) * (0.3 + 0.1 * k
                                    + 0.05 * np.sin(x)))] for x in lons]}}
        for k in range(4)]
    feats.append({"type": "Feature", "geometry": {
        "type": "Polygon", "coordinates": [[
            [float(wrap(lon0 + (lon1 - lon0) * u)),
             float(lat0 + (lat1 - lat0) * v)]
            for u, v in ((0.4, 0.4), (0.6, 0.4), (0.6, 0.6), (0.4, 0.6),
                         (0.4, 0.4))]]}})
    gj = work / "map.geojson"
    gj.write_text(json.dumps({"type": "FeatureCollection",
                              "features": feats}))
    out = img.copy()
    to_xy = _latlon_to_xy(georef, out.shape)
    overlay.draw_latlon_grid(out, to_xy, (0, 65535, 0), spacing_deg=5.0)
    overlay.draw_map_overlay(out, to_xy, str(gj), (65535, 65535, 65535),
                             thickness=2)
    cities = np.array([[wrap(lon0 + (lon1 - lon0) * u),
                        lat0 + (lat1 - lat0) * v]
                       for u, v in ((0.5, 0.5), (0.3, 0.7), (0.7, 0.2))])
    out = text.draw_city_labels(out, to_xy, cities, ["Alpha", "Beta", "Gamma"],
                                (255, 255, 0))
    inked = int(np.any(out != img, axis=-1).sum())
    assert inked >= 1000 and len(read_geojson(gj)) == 5, inked
    w, h = out.shape[1], out.shape[0]
    tif = work / "pass.tif"
    geotiff.save_geotiff(out, tif, lon0, lat1, (lon1 - lon0) / (w - 1),
                         (lat1 - lat0) / (h - 1))
    tags = geotiff.read_geotiff_tags(tif)
    assert (tags["width"], tags["height"]) == (w, h)
    assert tags["lon_min"] == lon0 and tags["lat_max"] == lat1
    assert tags["geo_keys"] == {1024: 2, 1025: 1, 2048: 4326}
    assert tif.read_bytes()[-out.nbytes:] == out.astype("<u2").tobytes()


@pytest.mark.card
def test_projection_card_against_cpu(full_pass, card, tmp_path):
    """The AVHRR/3 product of the 5-minute pass (1,800 lines of 2048
    columns) with a MetOp-B TLE an hour before it: compute_gcps; warp_to_equirect at 2048
    columns with the spline on the card, 64 of its rows' spline on the CPU
    (coordinates within GEO_COORD_TOL, pixels within GEO_PIXEL_SHARE); the
    card's spline at its own GCPs; the whole warp at 512 columns and
    smart_warp_to_equirect at 2048 / tile 512 on both devices;
    reproject_equirect to a stereographic and a geostationary target; a
    lat/lon grid, a GeoJSON map, city labels and the GeoTIFF."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.geo import projs, raytrace, reproject, warp
    from satdump_tpu_torch.geo.tle import TLE
    from satdump_tpu_torch.products.product import load_product
    prod = load_product(str(full_pass[0] / "AVHRR" / "product.json"))
    cfg = prod.get_proj_cfg()
    ts = np.asarray(cfg["timestamps"])
    tle = TLE.parse("METOP-B", *sim.metop_b_tle(
        float(np.median(ts[ts > 0])) - 3600.0))
    img = np.stack([prod.get_channel(c).image for c in GEO_CHANNELS], -1)
    gcps = raytrace.compute_gcps(cfg, img.shape[1], img.shape[0], tle=tle)
    assert len(gcps) >= 900, len(gcps)
    with _spline_xy() as calls:
        full, georef = warp.warp_to_equirect(img, gcps, GEO_OUT_WIDTH,
                                             device=card)
    # a band of the full-width warp's rows on the CPU
    hout = georef["height"]
    rows = slice(hout // 2, hout // 2 + GEO_BAND_ROWS)
    glon = np.linspace(georef["lon_min"], georef["lon_max"], GEO_OUT_WIDTH)
    glat = np.linspace(georef["lat_max"], georef["lat_min"], hout)[rows]
    band = np.stack(np.meshgrid(glon, glat), -1).reshape(-1, 2)
    lon, lat = gcps[:, 2], gcps[:, 3]
    if lon.max() - lon.min() > 180.0:
        lon = np.mod(lon + 360.0, 360.0)
    tps = warp.ThinPlateSpline(np.stack([lon, lat], -1), gcps[:, :2],
                               reg=1e-6, device="cpu")
    xy_cpu = tps._eval_torch(band)
    xy_card = calls[-1].reshape(hout, GEO_OUT_WIDTH, 2)[rows].reshape(-1, 2)
    assert np.abs(xy_cpu - xy_card).max() <= GEO_COORD_TOL
    _geo_close(full[rows], reproject.bilinear_sample(
        img, xy_cpu[:, 0].reshape(-1, GEO_OUT_WIDTH),
        xy_cpu[:, 1].reshape(-1, GEO_OUT_WIDTH)), "warp rows at 2048")
    # the spline on the card passes through its GCPs (reg 1e-6)
    fit = warp.ThinPlateSpline(tps.src, gcps[:, :2], reg=1e-6,
                               device=card)._eval_torch(tps.src)
    assert np.abs(fit - gcps[:, :2]).max() <= GEO_GCP_TOL
    small = {d: warp.warp_to_equirect(img, gcps, GEO_CPU_WIDTH, device=d)
             for d in (card, "cpu")}
    assert small[card][1] == small["cpu"][1]
    _geo_close(small[card][0], small["cpu"][0], "warp at 512")
    # the smart warp: tiles of local splines; one channel
    ch = np.ascontiguousarray(img[..., 2])
    sw, st = GEO_SMART_CPU
    pair = [warp.smart_warp_to_equirect(ch, gcps, sw, tile=st, device=d)
            for d in (card, "cpu")]
    assert pair[0][1] == pair[1][1]
    _geo_close(pair[0][0], pair[1][0], "smart warp at 2048, tile 512")
    clon = float(np.median(gcps[:, 2]))
    for name, tgt in (("stereo", {"type": "stereo", "lon0": clon,
                                  "lat0": 90.0 if lat.mean() > 0 else -90.0}),
                      ("geos", {"type": "geos", "lon0": round(clon)})):
        out, _ = reproject.reproject_equirect(full, georef, tgt, 2048)
        x, _ = projs.forward(tgt, gcps[:, 2], gcps[:, 3])
        assert np.isfinite(x).all(), name
        assert float((out.max(-1) > 0).mean()) > 0.05, name
    _geo_overlays(full, georef, tmp_path)


ING_NAT_LINES = 232           # of 3,712 VIS/IR lines (HRV 696 of 11,136)
ING_HSD_SEG_LINES, ING_HSD_SEGS = 275, 2     # of band 13's 10 segments


@pytest.mark.card
def test_ingest_process_card_equals_cpu(card, tmp_path):
    """`ingest --process` through the CLI on the card and on the CPU: a
    SEVIRI .nat at its 3,712 columns (12 channels with HRV) and two band-13
    HSD segments at 5,500 columns; the products and composites equal."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    rng = _rng(18, 2)
    raw, _ = sim.seviri_nat(rng, ING_NAT_LINES)
    (tmp_path / "in").mkdir()
    paths = [tmp_path / "in" / "MSG4-SEVI-MSG15-0100-NA-20240101121243.nat"]
    paths[0].write_bytes(raw)
    files, _ = sim.ahi_hsd_segments(rng, ING_HSD_SEG_LINES, ING_HSD_SEGS)
    for i, f in enumerate(files, 1):
        paths.append(tmp_path / "in" / f"HS_H09_20240101_1200_B13_FLDK_R20_"
                     f"S{i:02d}{ING_HSD_SEGS:02d}.DAT.bz2")
        paths[-1].write_bytes(f)
    res = {d: _cli_json(["ingest", *map(str, paths), "-o", str(tmp_path / d),
                         "--process", "--torch_device", d])
           for d in (card, "cpu")}
    assert res[card]["composites"] >= 3, res
    tree = {d: sorted(p.relative_to(tmp_path / d)
                      for p in (tmp_path / d).rglob("*")
                      if p.is_file() and p.name != ".preset_cache.json")
            for d in (card, "cpu")}
    assert tree[card] == tree["cpu"]
    for r in tree[card]:
        a, b = tmp_path / card / r, tmp_path / "cpu" / r
        same = _same_images(load_img(a), load_img(b)) if r.suffix == ".png" \
            else a.read_bytes() == b.read_bytes()
        assert same, r


# ---- the scale-out and the bench --------------------------------------------

@pytest.mark.card
def test_dryrun_multichip_step_card_against_cpu(card):
    """dryrun_multichip(8) on the card (its step, then 12 of 12 CADUs
    through the runner), and its step against the same step on the CPU.
    The first shard's halo is zeros whose filtered values are FFT
    round-off, so each stream's rotation (a multiple of 90 degrees) and its
    first sub_phase samples of signal are arbitrary on either device: the
    softs are held after the channel's rotation, the first shard's lead
    left out, within 5 LSB and at a median of 0; every kernel of the step
    launched."""
    from satdump_tpu_torch.parallel import dryrun, timeshard

    def turned(soft: np.ndarray, k: int) -> np.ndarray:
        """Interleaved int8 IQ softs times j^k."""
        c = soft.astype(np.int16).reshape(-1, 2)
        for _ in range(k % 4):
            c = np.stack([-c[:, 1], c[:, 0]], axis=1)
        return c.reshape(-1)
    a = dryrun.dryrun_multichip(8, device=card)["step"]
    mesh = timeshard.make_mesh(8)
    b = timeshard.run_sharded(dryrun.step_signal(mesh), mesh, "cpu",
                              **dryrun.STEP_KW)
    assert np.array_equal(a.valid, b.valid)
    lead = 2 * int(np.ceil(dryrun.STEP_KW["sub_phase"] /
                           dryrun.STEP_KW["sps"]))
    for ch in range(mesh.n_ch):
        k = int(np.argmin([np.abs(turned(a.soft[1, ch], k)
                                  - b.soft[1, ch]).sum() for k in range(4)]))
        for t in range(mesh.n_t):
            d = np.abs(turned(a.soft[t, ch], k)
                       - b.soft[t, ch].astype(np.int16))[lead if t == 0
                                                         else 0:]
            assert d.max() <= 5 and np.median(d) == 0, (ch, t, d.max())
    launches = {k: sum(r["launches"][k] for r in a.stats["rank"])
                for k in a.stats["rank"][0]["launches"]}
    assert_launched(launches, label="dryrun step")


BENCH_CATEGORIES = ("freq_shift", "agc", "rrc", "quadrature_demod", "snr_est",
                    "ff_cfo", "ff_timing", "ff_qpsk_full", "viterbi_k7",
                    "rs_decode", "soft_to_cadu")


@pytest.mark.card
def test_bench_rates_every_category(card):
    from satdump_tpu_torch import bench
    res = bench.run_bench(device=card)
    assert sorted(res) == sorted(BENCH_CATEGORIES), res
