"""The port's hand-written CUDA kernels on the card, each against its plain
version, at the tolerance the kernel is held to, with its wrapper's
`launches` count read around the call; and their SASS.

Every test here is marked `card` and skips where there is no CUDA card.
This file imports no JAX, nothing of the satdump_tpu package and no PIL; on
the card's host run it as tests/torch_card.py says. K4's cases are in
tests/test_torch_resample_strip.py.

Tolerances: 0 (`torch.equal` or equal bits) for K1, K3, the toolchain probe,
the AGC, the PLL, M&M, Gardner, walk_math and turbo_bcjr; K2_ATOL for K2
(the same branch picks, only the 8-term sum's order differs); WALK_ATOL for
the Costas loop alone (its float64 sin / cos may round an ulp of a double
apart on the card and in the CPU's libm, and the loop carries the last-bit
step on). The walkers' SASS holds no FFMA that rounds (one would part the
card from the plain version), nor the AGC's and the PLL's any float64
instruction; K1's, K3's and turbo_bcjr's hold no FFMA that rounds either.
"""

import re

import numpy as np
import pytest
import torch

from satdump_tpu_torch.ops.fec.turbo import _RATES
from torch_card import assert_launched, card, counted, sass  # noqa: F401

SEED = 20261016


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([SEED, *key])


def _max_err(a, b) -> float:
    """The largest difference of two outputs (a count for booleans)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        return float((a != b).sum())
    if not a.numel():
        return 0.0
    return float((a.to(torch.complex128) - b.to(torch.complex128)).abs()
                 .max())


def _held(what: str, dev, cpu, tol: float) -> None:
    """A walker's outputs and state on the card within tol of its plain
    version's."""
    torch.cuda.synchronize()
    err = max(_max_err(a, b) for a, b in zip(dev, cpu))
    assert np.isfinite(err) and err <= tol, \
        f"{what} differs from its plain version: max |err| {err}"


# ---- the toolchain probe (y = 2x + 1) ------------------------------------
# its (8, 128) arange input (tools/pallas_smoke.py's), odd sizes, a view 4
# bytes past 16-byte alignment and 2^24 elements
PROBE_CASES = ("(8, 128) arange", "n=1", "n=1023", "n=4097", "n=2^24",
               "n=4097 at 4 bytes past 16-byte alignment")


@pytest.mark.card
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_equals_plain_on_the_card(case, card):
    from satdump_tpu_torch.ops.cuda.probe import affine_probe
    rng = _rng(1, PROBE_CASES.index(case))
    if case == "(8, 128) arange":
        x = torch.arange(8 * 128, dtype=torch.float32,
                         device=card).reshape(8, 128)
    elif case.startswith("n=4097 at"):
        base = torch.from_numpy(rng.standard_normal(4098).astype(np.float32))
        x = base.to(card)[1:]
        assert x.data_ptr() % 16 == 4
    else:
        n = {"n=1": 1, "n=1023": 1023, "n=4097": 4097, "n=2^24": 1 << 24}[case]
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             * 1e3).to(card)
    got, launches = counted(lambda: affine_probe(x), ["affine_probe"])
    assert_launched(launches, label=case)
    assert torch.equal(got, x * 2 + 1)
    if case == "(8, 128) arange":
        expect = np.arange(8 * 128, dtype=np.float32).reshape(8, 128) * 2 + 1
        np.testing.assert_array_equal(got.cpu().numpy(), expect)


# ---- K1, the register-exchange Viterbi (csrc/viterbi_re.cu) --------------
K1_T = (1 << 20) + 1024           # CaduChain.vit_pairs at chunk 2^20 pairs
# label: (seg, ovl, lanes (None: K1_T steps), softs): the main path's shape,
# then the shapes K1's chunking (32 steps) and grouping (two lanes a warp,
# eight a block) touch
K1_CASES = {
    "integer softs, T=2^20+1024": (1024, 128, None, "integer"),
    "non-integer softs, T=2^20+1024": (1024, 128, None, "coded"),
    "L=5 lanes": (1024, 128, 5, "coded"),
    "erasure tail": (1024, 128, 4, "erasure"),
    "uniform-noise integer softs": (1024, 128, 3, "uniform"),
    "seg 512 / ovl 64": (512, 64, 6, "coded"),
    "seg 1024 / ovl 200": (1024, 200, 3, "coded"),
}


def _k1_softs(rng, kind: str, T: int, seg: int) -> np.ndarray:
    """(T, 2) float32 soft pairs: a coded stream with noise (rounded to
    integers for "integer"), pure noise ("uniform": ties everywhere), or
    one with its last `seg` pairs erased as the CADU chain pads chunks."""
    if kind == "uniform":
        return np.round(rng.uniform(0, 255, (T, 2))).astype(np.float32)
    from satdump_tpu_torch.ops.fec import convolutional as cc
    enc = cc.conv_encode_batch(rng.integers(0, 2, T).astype(np.uint8))
    soft = np.clip(np.where(enc > 0, 235.0, 20.0)
                   + rng.normal(0, 30.0, enc.shape), 0, 255)
    if kind == "integer":
        soft = np.round(soft)
    soft = soft.astype(np.float32).reshape(-1, 2)
    if kind == "erasure":
        soft[T - seg:] = 128.0
    return soft


@pytest.mark.card
def test_k1_sass_holds_no_ffma(card):
    """The path-metric sums are plain adds: no FFMA in any K1 function."""
    funcs = re.split(r"\n\s*Function : ", sass("viterbi_re"))[1:]
    assert funcs, "cuobjdump showed no K1 function"
    for f in funcs:
        ops = [m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
            f)]
        assert ops and "FFMA" not in ops, f.split("\n", 1)[0]


@pytest.mark.card
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_equals_plain_on_the_card(case, card):
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.fec import convolutional as cc
    seg, ovl, lanes, kind = K1_CASES[case]
    T = K1_T if lanes is None else lanes * seg
    x = torch.from_numpy(_k1_softs(_rng(3, list(K1_CASES).index(case)),
                                   kind, T, seg)).to(card)
    got, launches = counted(lambda: viterbi_re(x, seg=seg, ovl=ovl),
                            ["viterbi_re"])
    assert_launched(launches, label=case)
    ref = cc.viterbi_decode_tiled_re(x, seg=seg, ovl=ovl)
    assert torch.equal(got, ref), \
        f"{int((got != ref).sum())} bits differ from the plain version"


# ---- K2, the arithmetic-grid resampler (csrc/resample_arith.cu) -----------
K2_ATOL = 1e-4
METOP_SPS = 6e6 / 2333333
METEOR_SPS = 35 / 9
# label: (n_ext, sps, skew, out_cap or None for psk_demod's)
K2_CASES = {
    "n=2^18 skew 0": ((1 << 18) + 7, METOP_SPS, 0.0, None),
    "n=2^18 skew 0.005": ((1 << 18) + 7, METOP_SPS, 0.005, None),
    "n=2^21 skew 0": ((1 << 21) + 7, METOP_SPS, 0.0, None),
    "n=2^21 skew 0.005": ((1 << 21) + 7, METOP_SPS, 0.005, None),
    "METEOR sps 35/9 n=2^18 skew 0.005": ((1 << 18) + 7, METEOR_SPS, 0.005,
                                          None),
    "n_ext 8, out_cap 1": (8, METOP_SPS, 0.0, 1),
    # beyond the 2 % the TPU kernel's window allows
    "n=2^18 skew 0.03": ((1 << 18) + 7, METOP_SPS, 0.03, None),
    # the resampled pipelines' default blocks after the input resampler
    # (psk_demod's block * interp / decim samples + 7 of history)
    "METEOR-M2 1 Msps: 7/25 of 25*2^18, sps 35/9": (1835008 + 7, METEOR_SPS,
                                                    0.0, None),
    "METEOR-M2-x 1 Msps: 21/125 of 125*2^18, sps 7/3": (5505024 + 7, 7 / 3,
                                                        0.0, None),
    "GOES HRIT 6 Msps: 3/5 of 5*2^18, sps 3.6e6/927e3": (786432 + 7,
                                                         3.6e6 / 927e3, 0.0,
                                                         None),
}
# the two METEOR VFOs of one 2.048 Msps stream (the live test's): each
# VFO demod's own block after its input resampler, sps and out_cap, read
# off the running psk_demod
VFO_FS = 2.048e6
VFO_CARRIERS = (("a", 400e3, "meteor_m2x_lrpt"), ("b", -400e3,
                                                  "meteor_m2_lrpt"))
K2_VFO_CASES = {f"VFO {name} {pid}, skew {skew}": (name, skew)
                for name, _, pid in VFO_CARRIERS for skew in (0.0, 0.005)}
_vfo_shapes: dict = {}


def _vfo_shape(name: str, work) -> tuple:
    """(n_ext, sps, out_cap) of VFO `name`'s psk_demod in the two-VFO
    live path."""
    if not _vfo_shapes:
        from satdump_tpu_torch.pipeline.multivfo import MultiVFOLive
        from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
        from torch_card import ROOT
        pipes = parse_pipeline_file(ROOT / "resources" / "pipelines" /
                                    "Meteor-M.json")
        mv = MultiVFOLive(VFO_FS, str(work))
        for vfo, off, pid in VFO_CARRIERS:
            mv.add_vfo(vfo, off, pipes[pid])
            d = mv.pipes[vfo].modules[0]
            _vfo_shapes[vfo] = (d._out_n + 7, d.final_sps, d._ff_cap)
        mv.stop()
    return _vfo_shapes[name]


def _k2_check(rng, n_ext: int, sps: float, skew: float, cap, card) -> None:
    from satdump_tpu_torch.ops.cuda.resample import (
        resample_arith_grid, resample_arith_grid_plain)
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    bank = torch.as_tensor(mm_interpolator_bank()).to(card)
    ext = torch.from_numpy((rng.standard_normal(n_ext)
                            + 1j * rng.standard_normal(n_ext)
                            ).astype(np.complex64)).to(card)
    start = torch.tensor(0.37, dtype=torch.float32, device=card)
    omega = torch.tensor(sps * (1 + skew), dtype=torch.float32, device=card)
    if cap is None:
        cap = int(np.ceil((n_ext - 7) / (sps * 0.99))) + 2   # psk_demod's
    got, launches = counted(lambda: resample_arith_grid(
        ext, start, omega, bank, out_cap=cap), ["resample_arith_grid"])
    assert_launched(launches)
    ref = resample_arith_grid_plain(ext, start, omega, bank, out_cap=cap)
    err = float((got - ref).abs().max())
    assert np.isfinite(err) and err <= K2_ATOL, \
        f"max |err| {err} over {cap} symbols"


@pytest.mark.card
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_within_atol_of_plain_on_the_card(case, card):
    _k2_check(_rng(4, list(K2_CASES).index(case)), *K2_CASES[case], card)


@pytest.mark.card
@pytest.mark.parametrize("case", list(K2_VFO_CASES))
def test_k2_within_atol_of_plain_at_the_live_vfo_shapes(case, card,
                                                        tmp_path):
    name, skew = K2_VFO_CASES[case]
    n_ext, sps, cap = _vfo_shape(name, tmp_path)
    _k2_check(_rng(17, list(K2_VFO_CASES).index(case)), n_ext, sps, skew,
              cap, card)


# ---- CaduChain's RS decode replayed from its CUDA graph -------------------
RS_FRAMES = 64


def _rs_case(rng, frames: int):
    """`frames` MetOp payloads of 4 interleaved RS(255,223) codewords in the
    dual basis, with 0-16 byte errors a codeword and 17-20 (past what RS
    corrects) in one codeword of four; and the host codec's decode."""
    from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
    rs = ReedSolomon(223)
    msgs = rng.integers(0, 256, (frames, 223 * 4)).astype(np.uint8)
    data = rs.encode_interleaved(msgs, True, 4)
    for f in range(frames):
        for b in range(4):
            n = int(rng.integers(17, 21)) if b == f % 4 and f % 2 \
                else int(rng.integers(0, 17))
            pos = rng.choice(255, n, replace=False) * 4 + b
            data[f, pos] ^= rng.integers(1, 256, n).astype(np.uint8)
    return (data,) + tuple(rs.decode_interleaved(data, True, 4))


@pytest.mark.card
def test_rs_graph_replay_equals_the_direct_decode_and_the_host_codec(card):
    """Two batches through one graph, each equal to the direct decode and
    to the host codec."""
    from satdump_tpu_torch.ops.fec import cadu_chain
    chain = cadu_chain.CaduChain(cadu_bits=8192, chunk_pairs=1 << 14,
                                 rs_i=4, device=card)
    rng = _rng(21)
    for batch in range(2):
        data, want, want_err = _rs_case(rng, RS_FRAMES)
        x = torch.as_tensor(data.astype(np.int32), device=card)
        got, got_err = chain._rs_decode(x)
        ref, ref_err = chain.rs.decode_interleaved(x, 4)
        for name, a, b in (("graph", got, want), ("graph", got_err, want_err),
                           ("direct", ref, want),
                           ("direct", ref_err, want_err)):
            np.testing.assert_array_equal(a.cpu().numpy(), b,
                                          err_msg=f"{name}, batch {batch}")
    assert cadu_chain._RS_GRAPHS, "CaduChain's RS decode was not graphed"


# ---- the classic chain's walkers (csrc/sample_walk.cu, mm_clock.cu,
# gardner_clock.cu) ----------------------------------------------------------
# two blocks of WALK_BLOCK samples with the state carried (the kernel's
# state on the card, the plain version's on the CPU), then one block of
# WALK_MAIN (the classic demods' default block, the main path's)
WALK_BLOCK, WALK_MAIN = 1 << 15, 1 << 18
WALK_ATOL = 1e-4
# the walkers' kernels that must hold no float64 instruction
FP32_WALKERS = ("sample_walk_kernelILi0E", "sample_walk_kernelILi1E",
                "walk_math_kernel")
# label: (mode: "agc" | "pll" | Costas order, loop bw, limit). Costas
# against its frequency limit and the PLL at max_offset 20 (a step's sum
# beyond the in-range wrap's reach: its walk for any phase) take the two
# blocks alone
WALK_CASES = {
    "agc": ("agc", None, None),
    "pll": ("pll", 0.01, 0.5),
    "costas order 2": (2, 0.005, 1.0),
    "costas order 4": (4, 0.005, 1.0),
    "costas order 8": (8, 0.005, 1.0),
    "costas order 2, freq_limit 2e-4": (2, 0.02, 2e-4),
    "pll, max_offset 20": ("pll", 0.01, 20.0),
}
WALK_BLOCKS_ONLY = ("costas order 2, freq_limit 2e-4", "pll, max_offset 20")
# label: (sps, complex mode): NOAA HRPT's pm_demod, INTEGRAL's (the main
# path's: sps 8 and its out_cap) and a real-mode (fsk_demod) case; on
# these inputs each carries an inc past a block end
MM_CASES = {"mm complex, sps 4.5": (4.5, True),
            "mm complex, sps 8": (8.0, True),
            "mm real, sps 7.99": (7.99, False)}
# at the JAX test's sps and at MetOp's; complex mode, the demods' loop
# defaults (clock alpha 8.7e-3, omega limit 0.005). No pipeline of either
# package calls Gardner, so gardner_clock_recovery is driven here
GARD_CASES = {"gardner, sps 100/42": 100 / 42, "gardner, sps 18/7": 18 / 7}
GARD_ALPHA, GARD_LIMIT = 8.7e-3, 0.005


def _walk_input(rng, n: int, sps: float = 4.5) -> np.ndarray:
    """QPSK-like symbols held for sps samples, a carrier offset of 2e-3
    cycles a sample, a gain of 1.7 and AWGN: what the classic chain's
    loops lock to."""
    k = np.arange(n)
    sym = ((rng.integers(0, 2, int(n / sps) + 2) * 2 - 1)
           + 1j * (rng.integers(0, 2, int(n / sps) + 2) * 2 - 1))
    x = sym[(k / sps).astype(np.int64)] * np.exp(2j * np.pi * 2e-3 * k + 0.3)
    x = 1.7 * x / np.sqrt(2) + 0.1 * (rng.standard_normal(n)
                                      + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _walk_call(mode, bw, limit):
    """(wrapper name, wrapper, plain version) of one walker case, each as
    f(x, state) -> (y, state')."""
    from satdump_tpu_torch.ops import costas
    from satdump_tpu_torch.ops.cuda import sample_walk as sw
    if mode == "agc":
        p = (1e-2, 1.0, 65536.0)      # rate, reference, ceiling
        return ("agc_walk", lambda x, s: sw.agc_walk(x, s, *p),
                lambda x, s: sw.agc_walk_plain(x, s, *p))
    a, b = costas.costas_gains(bw)
    if mode == "pll":
        return ("pll_walk", lambda x, s: sw.pll_walk(x, s, a, b, limit),
                lambda x, s: sw.pll_walk_plain(x, s, a, b, limit))
    return ("costas_walk",
            lambda x, s: sw.costas_walk(x, s, a, b, mode, limit),
            lambda x, s: sw.costas_walk_plain(x, s, a, b, mode, limit))


@pytest.mark.card
@pytest.mark.parametrize("src", ["sample_walk", "mm_clock", "gardner_clock"])
def test_walker_sass_holds_no_rounding_ffma(src, card):
    """No FFMA that rounds (sass_chain.rounding_ffma: an FFMA with a zero
    factor or inside nvcc's correctly rounded division and square root does
    not), and no float64 instruction in the AGC's, the PLL's and
    walk_math's kernels."""
    from satdump_tpu_torch.tools import sass_chain as sc
    fp32 = set()
    for f in sc.parse_sass(sass(src)):
        rounding, _ = sc.rounding_ffma(f)
        assert not rounding, (f.name, [x.text for x in rounding[:4]])
        for k in FP32_WALKERS:
            if k in f.name:
                fp32.add(k)
                fp64 = sc.fp64_instructions(f)
                assert not fp64, (f.name, [x.text for x in fp64[:6]])
    if src == "sample_walk":
        assert fp32 == set(FP32_WALKERS), sorted(fp32)


WALK_MATH_GRID = 1 << 22


def _walk_math_inputs(rng):
    """phases, then (y, x) pairs: WALK_MATH_GRID phases spread over
    [-2 pi, 2 pi] with every float32 within 64 ulp of each multiple of
    pi/4 there; WALK_MATH_GRID pairs of magnitudes 10^-45..10^38 (some
    subnormal) at random signs, half of them at one magnitude and a random
    angle (the octants and the diagonal), then the special cases: every
    pair of +-0, +-1, +-the smallest subnormal, +-the largest float32,
    +-inf and NaN."""
    f32 = np.float32
    two_pi = float(f32(2 * np.pi))
    ph = rng.uniform(-two_pi, two_pi, WALK_MATH_GRID).astype(f32)
    near = []
    for m in range(-8, 9):
        v = f32(m * np.pi / 4)
        steps = np.arange(-64, 65, dtype=np.int64)
        if v == 0:
            near.append(np.concatenate([
                np.arange(65, dtype=np.int32).view(f32),
                -np.arange(65, dtype=np.int32).view(f32)]))
        else:
            bits = np.array([v], f32).view(np.int32).astype(np.int64)
            near.append((bits + steps).astype(np.int32).view(f32))
    ph = np.concatenate([ph, *near, np.array([two_pi, -two_pi], f32)])
    half = WALK_MATH_GRID // 2
    mag = 10.0 ** rng.uniform(-45, 38.5, (2, half))
    sgn = rng.choice([-1.0, 1.0], (2, half))
    with np.errstate(over="ignore"):
        yx = (mag * sgn).astype(f32)
        r = 10.0 ** rng.uniform(-40, 38, half)
        a = rng.uniform(-np.pi, np.pi, half)
        polar = np.stack([r * np.sin(a), r * np.cos(a)]).astype(f32)
    tiny, big = np.float32(1e-45), np.finfo(f32).max
    sp = np.array([0.0, -0.0, 1.0, -1.0, tiny, -tiny, big, -big, np.inf,
                   -np.inf, np.nan], f32)
    special = np.stack(np.meshgrid(sp, sp)).reshape(2, -1)
    pairs = np.concatenate([yx, polar, special], axis=1)
    return ph, np.ascontiguousarray(pairs[0]), np.ascontiguousarray(pairs[1])


@pytest.mark.card
@pytest.mark.parametrize("fn", ["sincos", "atan2", "abs"])
def test_walk_math_equals_plain_bit_for_bit_on_the_card(fn, card):
    """The AGC's and the PLL's float32 sincos, atan2 and |x| on the card
    (walk_math) equal their plain versions in every bit (two NaNs count as
    equal)."""
    from satdump_tpu_torch.ops.cuda.sample_walk import walk_math
    ph, y, x = _walk_math_inputs(_rng(6))
    args = (ph,) if fn == "sincos" else (y, x)
    dev = walk_math(fn, *(torch.from_numpy(a).to(card) for a in args))
    with np.errstate(all="ignore"):
        cpu = walk_math(fn, *(torch.from_numpy(a) for a in args))
    torch.cuda.synchronize()
    for d, c in zip(dev, cpu):
        d, c = d.cpu().numpy(), c.numpy()
        same = (d.view(np.int32) == c.view(np.int32)) | (np.isnan(d)
                                                        & np.isnan(c))
        assert same.all(), f"{int((~same).sum())} outputs differ"


@pytest.mark.card
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_sample_walker_equals_plain_on_the_card(case, card):
    mode, bw, limit = WALK_CASES[case]
    name, kern, plain = _walk_call(mode, bw, limit)
    tol = 0 if mode in ("agc", "pll") else WALK_ATOL
    rng = _rng(7, list(WALK_CASES).index(case))
    s0 = torch.tensor([1.0] if mode == "agc" else [0.0, 0.0],
                      dtype=torch.float32)
    s_dev, s_cpu = s0.to(card), s0.clone()
    x = _walk_input(rng, 2 * WALK_BLOCK)
    for blk in range(2):
        xb = torch.from_numpy(x[blk * WALK_BLOCK:(blk + 1) * WALK_BLOCK])
        (y_dev, s_dev), launches = counted(lambda: kern(xb.to(card), s_dev),
                                           [name])
        assert_launched(launches, label=f"{case} block {blk}")
        y_cpu, s_cpu = plain(xb, s_cpu)
        _held(f"{case} block {blk}", (y_dev, s_dev), (y_cpu, s_cpu), tol)
    if case in WALK_BLOCKS_ONLY:
        return
    xt = torch.from_numpy(_walk_input(rng, WALK_MAIN))
    y_cpu, s_cpu = plain(xt, s0.clone())
    y_dev, s_dev = kern(xt.to(card), s0.to(card))
    _held(f"{case} at {WALK_MAIN}", (y_dev, s_dev), (y_cpu, s_cpu), tol)


def _mm_call(sps: float, complex_mode: bool):
    """The M&M wrapper and its plain version at the demods' defaults (clock
    alpha 8.7e-3, omega limit 0.005) and their out_cap, as
    f(ext, n, state, bank) -> (syms, valid, state')."""
    from satdump_tpu_torch.ops.cuda import mm_clock
    kw = dict(omega_mid=sps, gain_omega=8.7e-3 ** 2 / 4, gain_mu=8.7e-3,
              omega_limit=0.005 * sps, complex_mode=complex_mode)

    def cap(n):
        return int(np.ceil(n / (sps * (1 - 0.005)))) + 2
    return (lambda e, n, s, bank: mm_clock.mm_walk(e, n, s, bank,
                                                   out_cap=cap(n), **kw),
            lambda e, n, s, bank: mm_clock.mm_walk_plain(
                e, n, s, bank, out_cap=cap(n), **kw))


@pytest.mark.card
@pytest.mark.parametrize("case", list(MM_CASES))
def test_mm_walker_equals_plain_on_the_card(case, card):
    """Symbols, valid masks and state equal over two carried blocks (an inc
    carried past a block end) and at WALK_MAIN."""
    from satdump_tpu_torch.ops import clock_recovery
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    sps, cm = MM_CASES[case]
    kern, plain = _mm_call(sps, cm)
    rng = _rng(8, list(MM_CASES).index(case))

    def signal(n):
        x = _walk_input(rng, n, sps)
        return x if cm else x.real.astype(np.complex64)

    def state0():
        return clock_recovery._pack(clock_recovery.mm_init(omega=sps,
                                                           device="cpu"))
    bank = torch.as_tensor(mm_interpolator_bank())
    bank_dev = bank.to(card)
    x = signal(2 * WALK_BLOCK)
    s_dev, s_cpu = state0().to(card), state0()
    h = torch.zeros(7, dtype=torch.complex64)
    carried = []
    for blk in range(2):
        ext = torch.cat([h, torch.from_numpy(
            x[blk * WALK_BLOCK:(blk + 1) * WALK_BLOCK])])
        h = ext[WALK_BLOCK:]
        out_dev, launches = counted(lambda: kern(ext.to(card), WALK_BLOCK,
                                                 s_dev, bank_dev), ["mm_walk"])
        assert_launched(launches, label=f"{case} block {blk}")
        out_cpu = plain(ext, WALK_BLOCK, s_cpu, bank)
        s_dev, s_cpu = out_dev[2], out_cpu[2]
        carried.append(int(s_cpu[2:3].view(torch.int32)))
        _held(f"{case} block {blk}", out_dev, out_cpu, 0)
    assert any(carried), f"no inc carried past a block end: {carried}"
    ext = torch.from_numpy(np.concatenate([np.zeros(7, np.complex64),
                                           signal(WALK_MAIN)]))
    out_cpu = plain(ext, WALK_MAIN, state0(), bank)
    out_dev = kern(ext.to(card), WALK_MAIN, state0().to(card), bank_dev)
    _held(f"{case} at {WALK_MAIN}", out_dev, out_cpu, 0)


@pytest.mark.card
@pytest.mark.parametrize("case", list(GARD_CASES))
def test_gardner_walker_equals_plain_on_the_card(case, card):
    """Two blocks through gardner_clock_recovery on the card (two launches)
    and on the CPU, the state carried, then a WALK_MAIN block through the
    wrapper: symbols, valid masks and state equal."""
    from satdump_tpu_torch.ops import clock_recovery as cr
    from satdump_tpu_torch.ops.cuda import gardner
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    sps = GARD_CASES[case]
    rng = _rng(20, list(GARD_CASES).index(case))
    kw = dict(omega_mid=sps, gain_omega=GARD_ALPHA ** 2 / 4,
              gain_mu=GARD_ALPHA, omega_relative_limit=GARD_LIMIT)
    x = _walk_input(rng, 2 * WALK_BLOCK, sps)
    st = {d: cr.gardner_init(sps, device=d) for d in (card, "cpu")}
    blocks = [torch.from_numpy(x[b * WALK_BLOCK:(b + 1) * WALK_BLOCK])
              for b in range(2)]

    def on_card():
        out = []
        for xb in blocks:
            st[card], y, v = cr.gardner_clock_recovery(st[card], xb.to(card),
                                                       **kw)
            out.append((y, v, cr._gardner_pack(st[card])))
        return out
    dev, launches = counted(on_card, ["gardner_walk"])
    assert launches == {"gardner_walk": 2}
    for blk, xb in enumerate(blocks):
        st["cpu"], y, v = cr.gardner_clock_recovery(st["cpu"], xb, **kw)
        _held(f"{case} block {blk}", dev[blk],
              (y, v, cr._gardner_pack(st["cpu"])), 0)
    bank = torch.as_tensor(mm_interpolator_bank())
    ext = torch.from_numpy(np.concatenate([np.zeros(7, np.complex64),
                                           _walk_input(rng, WALK_MAIN, sps)]))
    s0 = cr._gardner_pack(cr.gardner_init(sps, device="cpu"))
    cap = int(np.ceil(WALK_MAIN / (sps * (1 - GARD_LIMIT)))) + 2
    wk = dict(omega_mid=sps, gain_omega=GARD_ALPHA ** 2 / 4,
              gain_mu=GARD_ALPHA, omega_limit=GARD_LIMIT * sps, out_cap=cap)
    out_cpu = gardner.gardner_walk_plain(ext, WALK_MAIN, s0, bank, **wk)
    out_dev = gardner.gardner_walk(ext.to(card), WALK_MAIN, s0.to(card),
                                   bank.to(card), **wk)
    _held(f"{case} at {WALK_MAIN}", out_dev, out_cpu, 0)


# ---- turbo_bcjr, the max-log BCJR (csrc/turbo_bcjr.cu) --------------------
# (base, rate, frames) at base 223 at each rate, both constituent codes,
# and at base 1115, rate 1/2, JUICE's 58-frame batch
BCJR_CASES = {f"base {base} rate {rate} {'+'.join(comps)} B {B}":
              (base, tuple(comps), B)
              for base, rate, B in tuple((223, r, 4) for r in
                                         ("1/2", "1/3", "1/4", "1/6"))
              + ((1115, "1/2", 58),)
              for comps in _RATES[rate]}


@pytest.mark.card
def test_turbo_bcjr_sass_holds_no_rounding_ffma_and_no_float64(card):
    """Every add, max and scaling by 0.5 is its own correctly rounded
    instruction (__fadd_rn / __fmul_rn, which nvcc never contracts)."""
    from satdump_tpu_torch.tools import sass_chain as sc
    funcs = sc.parse_sass(sass("turbo_bcjr"))
    assert funcs
    for f in funcs:
        rounding, _ = sc.rounding_ffma(f)
        fp64 = sc.fp64_instructions(f)
        assert not rounding and not fp64, (
            f.name, [x.text for x in rounding[:4]], [x.text for x in fp64[:4]])


@pytest.mark.card
@pytest.mark.parametrize("case", list(BCJR_CASES))
def test_turbo_bcjr_equals_plain_on_the_card(case, card):
    from satdump_tpu_torch.ops.cuda.turbo_bcjr import (turbo_bcjr,
                                                       turbo_bcjr_plain)
    from satdump_tpu_torch.ops.fec.turbo_trellis import MEMORY
    base, comps, B = BCJR_CASES[case]
    rng = _rng(12, list(BCJR_CASES).index(case))
    K = 8 * base
    S, C = K + MEMORY, len(comps)
    L = torch.from_numpy(rng.normal(0, 3, (B, S, C)).astype(np.float32)
                         ).to(card)
    La = torch.from_numpy(rng.normal(0, 4, (B, K)).astype(np.float32)
                          ).to(card)
    got, launches = counted(lambda: turbo_bcjr(L, La, comps), ["turbo_bcjr"])
    assert_launched(launches, label=case)
    ref = turbo_bcjr_plain(L, La, comps)
    assert torch.equal(got, ref), float((got - ref).abs().max())


# ---- K3, the block Viterbi (csrc/viterbi_block.cu) ------------------------
# label: ((rows, pairs), renorm). A full-width shard of the sharded MetOp
# pass (its 8,407,625 samples on 4 ranks: a block of 2,105,344 samples,
# 827,011 Viterbi pairs) takes minutes in the plain version on the host, so
# one row ends as such a shard does modulo the lcm of K3's ACS (256) and
# traceback (1024) chunks: the ACS's partial last chunk and the traceback's
# partial first one, a block with three idle warps. Renorm is on where the
# sharded step, the lock search and Aero decode, off in the tiled decoder
VB_T = 1 << 15
SHARD_SAMPLES, SHARD_RANKS = 8_407_625, 4
SHARD_BLOCK = -(-(SHARD_SAMPLES + 64) // (SHARD_RANKS * 4096)) * 4096
SHARD_PAIRS = int(np.ceil(SHARD_BLOCK / (METOP_SPS * 0.99))) + 4 - 8
K3_CASES = {
    "rows": ((4, VB_T), True),
    "a full-width shard's chunk ends": ((1, VB_T + SHARD_PAIRS % 1024), True),
    "lock search": ((1024, 1023), True),   # max_lanes x (TEST_BITS-2)/2
    "Aero 10.5k frame": ((1, 2496), True),
    "tiled lanes": ((8, 1024 + 2 * 128), False),
}


@pytest.mark.card
@pytest.mark.parametrize("fn", ["viterbi_acs_kernel",
                                "viterbi_traceback_kernel"])
def test_k3_sass_holds_no_ffma(fn, card):
    from satdump_tpu_torch.tools import sass_chain as sc
    f = next(f for f in sc.parse_sass(sass("viterbi_block")) if fn in f.name)
    assert not [x.text for x in f.ins if x.mnemonic == "FFMA"]


@pytest.mark.card
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_equals_plain_on_the_card(case, card):
    """Path metrics, decision words and bits equal to the plain version on
    CPU copies of the same inputs: rows of a coded stream's int8 softs."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.cuda.viterbi_block import (
        viterbi_block_acs, viterbi_block_traceback)
    from satdump_tpu_torch.ops.fec import convolutional as cc
    (B, T), renorm = K3_CASES[case]
    rng = _rng(19, list(K3_CASES).index(case))
    bits = rng.integers(0, 2, 1 << 17).astype(np.uint8)
    soft = sim.soft_stream(cc.conv_encode_batch(bits), rng)
    pairs = cc.soft_int8_to_u8(soft[: len(soft) // 2 * 2]).reshape(
        -1, 2).astype(np.float32)
    offs = rng.integers(0, len(pairs) - T, B)
    x = torch.from_numpy(np.stack([pairs[o:o + T] for o in offs])).to(card)
    pm0 = torch.zeros((B, 64), device=card)

    def decode():
        pm, dec = viterbi_block_acs(pm0, x, renorm)
        return pm, dec, viterbi_block_traceback(pm, dec)
    got, launches = counted(decode, ["viterbi_block_acs",
                                     "viterbi_block_traceback"])
    assert_launched(launches, label=case)
    pm, dec = cc._acs_plain(pm0.cpu(), x.cpu(), renorm)
    ref = (pm, dec, cc._traceback_plain(pm, dec))
    for name, a, b in zip(("path metrics", "decisions", "bits"), got, ref):
        assert torch.equal(a.cpu(), b), name
