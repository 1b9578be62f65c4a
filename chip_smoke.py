#!/usr/bin/env python3
"""On-card smoke test of satdump_tpu_torch (the PyTorch/CUDA port).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
 1. environment: torch, nvcc, the card's name and power limit;
 2. build: every CUDA source under satdump_tpu_torch/csrc, one nvcc each,
    all started together;
 2b. the toolchain probe (y = 2x + 1, the counterpart of
    tools/pallas_smoke.py) on its (8, 128) arange input, at odd sizes
    (1, 1023, 4097), on a view offset by 4 bytes and at 2^24 elements: must
    equal x * 2 + 1 exactly; its device time, the plain version's and one
    PyTorch call's (torch.add) and the bound, at (8, 128) and at 2^24;
 3. K1 (register-exchange Viterbi): its SASS must hold no FFMA; against
    its plain torch version on the card, bit-identical, at the main-path
    shape (integer and non-integer softs) and at the shapes its chunking
    and grouping touch (5 lanes, an erasure tail, uniform-noise softs,
    seg 512 / ovl 64, seg 1024 / ovl 200); the kernel's device time
    (median over launches in torch.profiler's trace), the time per
    wrapper call (median of CUDA events around single calls), the plain
    version's time and the bound;
 4. K2 (arithmetic-grid resampler) against its plain version at 2^18- and
    2^21-sample blocks, sps 18/7, skew 0 and 0.005, at METEOR's sps 35/9,
    at n_ext 8 / out_cap 1 and at skew 0.03 (beyond the 2 % the TPU
    kernel's window allows); the same numbers, the device time both with
    ext warm in L2 and after a 64 MB write;
 5. a 12-CADU pass of MetOp AHRPT (6 Msps, sps 18/7) to CADU, and a
    METEOR-M2 LRPT pass (280 ksps, sps 35/9) carrying two strips of MSU-MR
    channels 1-3 to products, through the port on the card and on the CPU:
    the .cadu files must be byte-identical and equal to the sent CADUs, the
    MSU-MR channel images identical, the 321_false_color composite written
    on both;
 6. the main path: ~2^23 samples (~1.4 s) of MetOp AHRPT at 6 Msps,
    carrying AVHRR/3 and MHS packets, through the port's run_pipeline on
    the card: baseband -> CADU (psk_demod, metop_ahrpt_decoder), timed as
    before, then CADU -> products (metop_instruments and the products
    processor), timed on its own. Every CADU must be one that was sent,
    the AVHRR and MHS channels must equal the lines sent, every autogen
    composite of avhrr_3 and mhs must be written, and every kernel of the
    path must have launched;
 7. where the main path's time goes: its psk_demod and decoder steps run
    again on the same input, once timed and once under torch.profiler,
    giving the device busy time, idle share, launches, copies and the top
    device kernels and host operators;
 8. products at full width: a 5-minute MetOp pass (1,800 AVHRR/3 lines of
    2048 px and 112 MHS lines) from the cadu level: metop_instruments once,
    then the products processor on the card and on the CPU, whose
    composites must be pixel-identical, and once more on the card under
    torch.profiler;
 9. METEOR MSU-MR's dequantize + IDCT at a full pass's block count
    (1,600 lines x 1568 px x 3 channels = 117,600 blocks): the card against
    the CPU, at most 1 LSB apart, and its device time;
 10. one JSON line describing each kernel, then the card's line and the
    result line. No kernel of the port lies on the products level.

Imports nothing of JAX and nothing of the satdump_tpu package. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # float32 outside the tensor cores
# the same units issue one add, compare or select where they issue one FMA
# (two flops), so operations that are not FMAs run at half the flop rate
H100_F32_OPS = H100_F32_FLOPS / 2
SEED = 20261016
# host idle at each end of a profiler session: the profiler keeps only the
# device records that fall inside its session on the host clock, and its
# reading of the device clock jumps now and then by up to ~3 ms on an H100
# (python3 -m satdump_tpu_torch.tools.profiler_window), so a session of a
# few short launches could lose every record
PROFILE_PAD_S = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def profiled():
    """A torch.profiler session of host and device activity, with
    PROFILE_PAD_S of host idle at each end of the work it traces."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        time.sleep(PROFILE_PAD_S)


def call_ms(fn, reps: int) -> float:
    """Time per call of fn(): the median over `reps` calls of CUDA events
    recorded around each single call, after one warm-up call. For a
    kernel's wrapper this includes the host's launch path wherever that
    takes longer than the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    `kernel`: the median over the launches of `reps` calls of fn() in
    torch.profiler's device trace."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    # a median over most of the launches will do; fewer means a lost trace
    if not 0.9 * reps <= len(ev) <= reps:
        raise AssertionError(f"profiler saw {len(ev)} launches of {kernel}, "
                             f"expected {reps}")
    return float(np.median([e.time_range.elapsed_us() for e in ev])) / 1e3


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env():
    import torch
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                        check=True).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc [{nv}] devices "
        f"{torch.cuda.device_count()}")
    log(f"card: {smi}")
    return smi


def phase_build():
    from satdump_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(secs)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s {secs}")
    for name, text in _build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def device_ms(fn, reps: int) -> float:
    """Device time per call of fn(): the summed duration of every CUDA
    kernel in torch.profiler's trace of `reps` calls, over reps (for a
    PyTorch call whose kernels' names are not known in advance)."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        raise AssertionError("profiler saw no device work")
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3


PROBE_SIZES = (1, 1023, 4097, 1 << 24)


def phase_probe(rng):
    """The toolchain probe against its plain version, tolerance 0."""
    import torch
    from satdump_tpu_torch.ops.cuda.probe import affine_probe
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    got = affine_probe(x)
    ref = x * 2 + 1
    torch.cuda.synchronize()
    ndiff = int((got != ref).sum())
    expect = np.arange(8 * 128, dtype=np.float32).reshape(8, 128) * 2 + 1
    log(f"probe (8, 128) 2x+1: {ndiff} values differ from plain "
        f"(tolerance: 0), equal to pallas_smoke.py's expected values: "
        f"{bool(np.array_equal(got.cpu().numpy(), expect))}")
    if ndiff or not np.array_equal(got.cpu().numpy(), expect):
        raise AssertionError("probe differs from its plain version")
    cases = [(f"n={n}", torch.from_numpy(
        rng.standard_normal(n).astype(np.float32) * 1e3).cuda())
        for n in PROBE_SIZES]
    base = torch.from_numpy(rng.standard_normal(4098).astype(np.float32)
                            ).cuda()
    cases.append(("n=4097 at 4 bytes past 16-byte alignment", base[1:]))
    for label, xs in cases:
        got = affine_probe(xs)
        torch.cuda.synchronize()
        ndiff = int((got != xs * 2 + 1).sum())
        log(f"probe {label} (data_ptr % 16 = {xs.data_ptr() % 16}): {ndiff} "
            f"values differ from x * 2 + 1 (tolerance: 0)")
        if ndiff:
            raise AssertionError(f"probe {label} differs from x * 2 + 1")
    ones = torch.ones_like(x)
    res = {"max_abs_err": 0.0,
           "ms": kernel_ms(lambda: affine_probe(x), "probe_affine_kernel",
                           50),
           "call_ms": call_ms(lambda: affine_probe(x), 50),
           "plain_ms": call_ms(lambda: x * 2 + 1, 50),
           # one PyTorch call of the same function; the port never calls it
           "library_ms": device_ms(lambda: torch.add(ones, x, alpha=2.0),
                                   50)}
    # one read and one write per element; one exact product and one add
    res["bound_ms"], res["bound_by"] = bound_ms(2 * x.numel() * 4,
                                                2 * x.numel(),
                                                H100_F32_FLOPS)
    log(f"probe times: kernel {res['ms']:.4f} ms on the card (profiler), "
        f"{res['call_ms']:.4f} ms per wrapper call (events), plain "
        f"{res['plain_ms']:.4f} ms, torch.add {res['library_ms']:.4f} ms "
        f"(profiler), bound {res['bound_ms']:.6f} ms ({res['bound_by']})")
    xl = cases[len(PROBE_SIZES) - 1][1]
    onesl = torch.ones_like(xl)
    big_ms = kernel_ms(lambda: affine_probe(xl), "probe_affine_kernel", 20)
    big_add = device_ms(lambda: torch.add(onesl, xl, alpha=2.0), 20)
    big_bound, _ = bound_ms(2 * xl.numel() * 4, 2 * xl.numel(),
                            H100_F32_FLOPS)
    log(f"probe times at n=2^24: kernel {big_ms:.4f} ms "
        f"({2 * xl.numel() * 4 / big_ms / 1e9:.3f} TB/s), torch.add "
        f"{big_add:.4f} ms, bound {big_bound:.4f} ms (bytes)")
    return res


def _k1_sass():
    """Static instruction counts of each K1 kernel in its SASS; fails if
    any FFMA is there (the path-metric sums must be plain adds)."""
    from satdump_tpu_torch.ops.cuda import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(_build._target("viterbi_re"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]
    if not funcs:
        raise AssertionError("cuobjdump showed no K1 function")
    for f in funcs:
        name = f.split("\n", 1)[0].strip()
        ops = [m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
            f)]
        counts = {op: ops.count(op) for op in
                  ("FFMA", "FADD", "FSETP", "FSEL", "SHFL", "LDS", "STS",
                   "LDGSTS", "LDG", "STG", "WARPSYNC", "BAR")}
        log(f"K1 SASS {name[:60]}: {len(ops)} instructions, {counts}")
        if counts["FFMA"]:
            raise AssertionError(f"K1 SASS holds {counts['FFMA']} FFMA")


def _viterbi_inputs(rng, T: int, integer: bool):
    from satdump_tpu_torch.ops.fec import convolutional as cc
    bits = rng.integers(0, 2, T).astype(np.uint8)
    enc = cc.conv_encode_batch(bits)
    soft = np.where(enc > 0, 235.0, 20.0) + rng.normal(0, 30.0, enc.shape)
    soft = np.clip(soft, 0, 255)
    if integer:
        soft = np.round(soft)
    return bits, soft.astype(np.float32).reshape(-1, 2)


# shapes K1's chunking (32 steps) and grouping (two lanes a warp, eight
# a block) touch: (label, seg, ovl, lanes, softs)
K1_CASES = (
    ("L=5 lanes", 1024, 128, 5, "coded"),
    ("erasure tail", 1024, 128, 4, "erasure"),
    ("uniform-noise integer softs", 1024, 128, 3, "uniform"),
    ("seg 512 / ovl 64", 512, 64, 6, "coded"),
    ("seg 1024 / ovl 200", 1024, 200, 3, "coded"),
)


def _k1_case_softs(rng, kind: str, T: int, seg: int) -> np.ndarray:
    if kind == "uniform":        # pure noise: ties everywhere
        return np.round(rng.uniform(0, 255, (T, 2))).astype(np.float32)
    _, soft = _viterbi_inputs(rng, T, integer=False)
    if kind == "erasure":        # the CADU chain pads chunks this way
        soft[T - seg:] = 128.0
    return soft


def _k1_check(x, seg: int, ovl: int, label: str):
    """K1 bit-identical to its plain version; returns K1's bits."""
    import torch
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.fec import convolutional as cc
    ref = cc.viterbi_decode_tiled_re(x, seg=seg, ovl=ovl)
    got = viterbi_re(x, seg=seg, ovl=ovl)
    torch.cuda.synchronize()
    ndiff = int((got != ref).sum())
    log(f"K1 {label} (T={x.shape[0]}, seg {seg}, ovl {ovl}): {ndiff} bits "
        f"differ from plain (tolerance: 0, bit-identical)")
    if ndiff:
        raise AssertionError(f"K1 {label} differs from its plain version "
                             f"in {ndiff} bits")
    return got


def phase_k1(rng):
    """K1 against viterbi_decode_tiled_re on the card, T = 2^20+1024, and
    at the shapes of K1_CASES."""
    import torch
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.fec import convolutional as cc
    _k1_sass()
    seg, ovl = 1024, 128
    T = (1 << 20) + 1024          # CaduChain.vit_pairs at chunk 2^20 pairs
    res = {}
    for integer in (True, False):
        bits, soft = _viterbi_inputs(rng, T, integer)
        x = torch.from_numpy(soft).cuda()
        kind = "integer" if integer else "non-integer"
        got = _k1_check(x, seg, ovl, f"{kind} softs")
        ber = float((got.cpu().numpy() != bits).mean())
        log(f"K1 {kind} softs: decoded BER vs sent {ber:.2e}")
        if integer:
            kern = lambda: viterbi_re(x, seg=seg, ovl=ovl)  # noqa: E731
            res["ms"] = kernel_ms(kern, "viterbi_re_kernel", 20)
            res["call_ms"] = call_ms(kern, 20)
            res["plain_ms"] = call_ms(
                lambda: cc.viterbi_decode_tiled_re(x, seg=seg, ovl=ovl), 3)
            L = T // seg
            steps = ovl + cc.RE_DELAY + seg
            # per lane-step: 4 branch metrics (2 ops each) + 64 states x
            # (2 candidate adds + 1 compare-select); survivors are integer;
            # none of these is an FMA
            ops = L * steps * (4 * 2 + 64 * 3)
            nbytes = T * 2 * 4 + T          # soft pairs in, bits out
            res["bound_ms"], res["bound_by"] = bound_ms(nbytes, ops,
                                                        H100_F32_OPS)
    for label, cseg, covl, lanes, kind in K1_CASES:
        soft = _k1_case_softs(rng, kind, lanes * cseg, cseg)
        _k1_check(torch.from_numpy(soft).cuda(), cseg, covl, label)
    res["max_abs_err"] = 0.0
    log(f"K1 times at T={T}: kernel {res['ms']:.4f} ms on the card "
        f"(profiler), "
        f"{res['call_ms']:.4f} ms per wrapper call (events), "
        f"plain {res['plain_ms']:.2f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']})")
    return res


K2_ATOL = 1e-4   # same branch picks; only the 8-term sum order differs
METOP_SPS = 6e6 / 2333333
METEOR_SPS = 35 / 9
# (label, n_ext, sps, skew, out_cap or None for psk_demod's)
K2_CASES = (
    ("n=2^18 skew 0", (1 << 18) + 7, METOP_SPS, 0.0, None),
    ("n=2^18 skew 0.005", (1 << 18) + 7, METOP_SPS, 0.005, None),
    ("n=2^21 skew 0", (1 << 21) + 7, METOP_SPS, 0.0, None),
    ("n=2^21 skew 0.005", (1 << 21) + 7, METOP_SPS, 0.005, None),
    ("METEOR sps 35/9 n=2^18 skew 0.005", (1 << 18) + 7, METEOR_SPS, 0.005,
     None),
    ("n_ext 8, out_cap 1", 8, METOP_SPS, 0.0, 1),
    ("n=2^18 skew 0.03", (1 << 18) + 7, METOP_SPS, 0.03, None),
)


def kernel_ms_cold(fn, kernel: str, reps: int) -> float:
    """As kernel_ms, with 64 MB written between launches, more than the
    card's 50 MB L2, so that each launch finds its inputs in device
    memory."""
    import torch
    flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda")

    def cold():
        flush.fill_(1.0)
        fn()
    return kernel_ms(cold, kernel, reps)


def phase_k2(rng):
    """K2 against its plain version on the card."""
    import torch
    from satdump_tpu_torch.ops.cuda.resample import (
        resample_arith_grid, resample_arith_grid_plain)
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    bank = torch.as_tensor(mm_interpolator_bank()).cuda()
    res = {"max_abs_err": 0.0}
    for label, n_ext, sps, skew, cap in K2_CASES:
        ext_np = (rng.standard_normal(n_ext)
                  + 1j * rng.standard_normal(n_ext)).astype(np.complex64)
        ext = torch.from_numpy(ext_np).cuda()
        start = torch.tensor(0.37, dtype=torch.float32, device="cuda")
        omega = torch.tensor(sps * (1 + skew), dtype=torch.float32,
                             device="cuda")
        if cap is None:
            cap = int(np.ceil((n_ext - 7) / (sps * 0.99))) + 2  # psk_demod's
        got = resample_arith_grid(ext, start, omega, bank, out_cap=cap)
        ref = resample_arith_grid_plain(ext, start, omega, bank, out_cap=cap)
        err = float((got - ref).abs().max())
        n_bad = int(((got - ref).abs() > K2_ATOL).sum())
        log(f"K2 {label}: max |err| {err:.3e} over {cap} symbols, {n_bad} "
            f"above {K2_ATOL}")
        if not np.isfinite(err) or err > K2_ATOL:
            raise AssertionError(f"K2 {label} differs from its plain "
                                 f"version: max |err| {err}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if label == "n=2^18 skew 0":          # the main path's block
            kern = lambda: resample_arith_grid(  # noqa: E731
                ext, start, omega, bank, out_cap=cap)
            res["ms"] = kernel_ms(kern, "resample_arith_kernel", 50)
            res["cold_ms"] = kernel_ms_cold(kern, "resample_arith_kernel",
                                            50)
            res["call_ms"] = call_ms(kern, 50)
            res["plain_ms"] = call_ms(lambda: resample_arith_grid_plain(
                ext, start, omega, bank, out_cap=cap), 20)
            nbytes = n_ext * 8 + bank.numel() * 4 + 8 + cap * 8
            # flops: 8 complex-by-real FMAs (2 each, 2 flops each) and
            # the position
            ops = cap * (8 * 4 + 6)
            res["bound_ms"], res["bound_by"] = bound_ms(nbytes, ops,
                                                        H100_F32_FLOPS)
            log(f"K2 times at n=2^18 (out_cap {cap}): kernel "
                f"{res['ms']:.4f} ms warm in L2, {res['cold_ms']:.4f} ms "
                f"after a 64 MB write (profiler), "
                f"{res['call_ms']:.4f} ms per wrapper call (events), "
                f"plain {res['plain_ms']:.4f} ms, bound "
                f"{res['bound_ms']:.5f} ms ({res['bound_by']})")
    return res


# (pipeline file, pipeline id, samples/symbol as up/down, user parameters)
METOP = ("MetOp.json", "metop_ahrpt", (18, 7), {})
# m2x_mode: the MSU-MR day from the packets, not from the wall clock
METEOR = ("Meteor-M.json", "meteor_m2_lrpt", (35, 9),
          {"samplerate": 280e3, "m2x_mode": True})
# the main path's pass: 26 AVHRR lines and 8 MHS lines between 4 idle
# frames make 399 CADUs, ~2^23 samples at sps 18/7 as in PRs 1-3
MAIN_AVHRR_LINES, MAIN_MHS_LINES, MAIN_IDLE = 26, 8, 2
# products at full width: 5 minutes of AVHRR/3 (6 lines/s) and MHS
FULL_AVHRR_LINES, FULL_MHS_LINES = 1800, 112
METOP_PRODUCTS = {"AVHRR": "avhrr_3", "MHS": "mhs"}
IDCT_BLOCKS = (1600 // 8) * (1568 // 8) * 3


def _pass(rng, cadus: np.ndarray, work: Path, sps):
    """`cadus` as QPSK downlink baseband at sps up/down
    (sim.ccsds_qpsk_baseband: SNR 18 dB, carrier offset and phase) written
    to work/pass.cf32; returns (cadus, path, samples)."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    bb = sim.ccsds_qpsk_baseband(cadus, rng, sps)
    work.mkdir(parents=True, exist_ok=True)
    path = work / "pass.cf32"
    write_baseband(path, "cf32", bb)
    return cadus, path, len(bb)


def _pipeline(fname: str, pipe_id: str, start: str = "baseband",
              stop: str = "cadu"):
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    pipe = parse_pipeline_file(ROOT / "resources" / "pipelines" /
                               fname)[pipe_id]
    pipe.steps = pipe.steps[pipe.level_index(start):
                            pipe.level_index(stop) + 1]
    return pipe


def _check_cadus(out: str, cadus: np.ndarray, label: str) -> np.ndarray:
    got = np.fromfile(out, dtype=np.uint8).reshape(-1, cadus.shape[1])
    sent = {c.tobytes() for c in cadus}
    bad = sum(g.tobytes() not in sent for g in got)
    log(f"{label}: {len(got)} CADUs decoded of {len(cadus)} sent, "
        f"{bad} not bit-exact")
    if bad or len(got) < len(cadus) - 2:
        raise AssertionError(f"{label}: {bad} corrupt CADUs, {len(got)} of "
                             f"{len(cadus)} decoded")
    return got


def autogen_composites(products: dict) -> list:
    """{product dir: instrument} -> the composite files that the
    instrument cfgs' autogen presets must give (the processor logs and
    skips a preset that fails, so a missing file is the sign of one)."""
    from satdump_tpu_torch.products.processor import load_instrument_cfg
    out = [f"{d}/{inst}_{name}.png" for d, inst in products.items()
           for name, preset in load_instrument_cfg(inst)["presets"].items()
           if preset.get("autogen")]
    if not out:
        raise AssertionError(f"no autogen preset for {products}")
    return out


def _same_images(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def phase_small_pass(rng, work: Path):
    """A 12-CADU MetOp pass to CADU and a METEOR pass of MSU-MR imagery to
    products, each through the port on the card and on the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    from satdump_tpu_torch.products.product import load_product
    meteor_cadus, truth = sim.msumr_lrpt_cadus(rng, 2)
    for (fname, pipe_id, sps, params), cadus, stop in (
            (METOP, sim.make_cadus(12, rng), "cadu"),
            (METEOR, meteor_cadus, "products")):
        cadus, path, n = _pass(rng, cadus, work / pipe_id, sps)
        outs = {}
        for dev in ("cuda", "cpu"):
            run_pipeline(_pipeline(fname, pipe_id, stop=stop), str(path),
                         str(work / pipe_id / dev),
                         user_params=dict(params, torch_device=dev))
            outs[dev] = str(work / pipe_id / dev / f"{pipe_id}.cadu")
        got = {d: _check_cadus(o, cadus, f"{pipe_id} small pass ({d}, "
                                         f"{n} samples)")
               for d, o in outs.items()}
        if not np.array_equal(got["cuda"], got["cpu"]):
            raise AssertionError(f"{pipe_id} small pass: .cadu differs "
                                 "between cuda and cpu")
        soft = {d: np.fromfile(Path(o).with_suffix(".soft"), np.int8)
                for d, o in outs.items()}
        dsoft = np.abs(soft["cuda"].astype(np.int16) - soft["cpu"])
        log(f"{pipe_id} small pass: .cadu byte-identical cuda vs cpu; "
            f".soft max |diff| {int(dsoft.max())} LSB, mean "
            f"{float(dsoft.mean()):.4f}")
    prods = {d: load_product(str(work / METEOR[1] / d / "MSU-MR"))
             for d in ("cuda", "cpu")}
    for ch in sorted(truth):
        imgs = [prods[d].get_channel(str(ch)).image for d in ("cuda", "cpu")]
        err = float(np.abs((imgs[0] >> 8).astype(int) - truth[ch]).mean())
        log(f"MSU-MR channel {ch} {imgs[0].shape}: identical on cuda and "
            f"cpu: {_same_images(*imgs)}; mean |error| against the image "
            f"sent {err:.3f} LSB (JPEG at QF 80)")
        if not _same_images(*imgs) or err > 8.0:
            raise AssertionError(f"MSU-MR channel {ch} differs between "
                                 f"devices or from the image sent ({err})")
    for c in autogen_composites({"MSU-MR": "msu_mr"}):
        comp = [load_img(work / METEOR[1] / d / c) for d in ("cuda", "cpu")]
        log(f"{c} {comp[0].shape} written on cuda and cpu, identical: "
            f"{_same_images(*comp)}")
        if not _same_images(*comp):
            raise AssertionError(f"{c} differs between devices")


def _check_avhrr_mhs(out_dir: Path, truth: dict, label: str) -> None:
    """The AVHRR/3 and MHS products in out_dir hold the lines sent, bit for
    bit (AVHRR slot 3 is channel 3a on 3a lines, 3b on the others), and
    every autogen composite of avhrr_3 and mhs is there."""
    from satdump_tpu_torch.products.product import load_product
    av = load_product(str(out_dir / "AVHRR"))
    sent, ch3a = truth["avhrr"], truth["ch3a"]
    ok = all(np.array_equal(av.get_channel(n).image >> 6, sent[:, :, s])
             for n, s in (("1", 0), ("2", 1), ("4", 3), ("5", 4)))
    ok &= np.array_equal(av.get_channel("3a").image[ch3a] >> 6,
                         sent[ch3a, :, 2])
    ok &= np.array_equal(av.get_channel("3b").image[~ch3a] >> 6,
                         sent[~ch3a, :, 2])
    mhs = load_product(str(out_dir / "MHS"))
    ok &= all(np.array_equal(mhs.get_channel(str(c + 1)).image,
                             truth["mhs"][:, :, c]) for c in range(5))
    want = autogen_composites(METOP_PRODUCTS)
    missing = [c for c in want if not (out_dir / c).exists()]
    log(f"{label}: AVHRR {av.get_channel('1').image.shape} x 6 and MHS "
        f"{mhs.get_channel('1').image.shape} x 5 equal to the lines sent: "
        f"{ok}; autogen composites {len(want) - len(missing)} of "
        f"{len(want)}")
    if not ok or missing:
        raise AssertionError(f"{label}: products differ from the lines sent "
                             f"or composites missing {missing}")


def phase_main(rng, work: Path):
    """The main path, baseband to products; returns the kernels' launches
    and the input file."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.cuda.probe import affine_probe
    from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    fname, pipe_id, (up, down), _ = METOP
    data, truth = sim.metop_instrument_cadus(rng, MAIN_AVHRR_LINES,
                                             MAIN_MHS_LINES)
    idle = sim.idle_cadus(MAIN_IDLE)
    cadus, path, n = _pass(rng, np.concatenate([idle, data, idle]),
                           work / "main", (up, down))
    out_dir = work / "main" / "out"
    path_kernels = (viterbi_re, resample_arith_grid)
    kernels = path_kernels + (affine_probe,)      # the probe is on no path
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = run_pipeline(_pipeline(fname, pipe_id), str(path), str(out_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    run_pipeline(_pipeline(fname, pipe_id, "cadu", "products"), out,
                 str(out_dir), start_level="cadu")
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t1
    launches = {k.__name__: k.launches for k in kernels}
    _check_cadus(out, cadus, f"main path ({n} samples)")
    log(f"main path: wall {wall:.3f} s, baseband->CADU "
        f"{n / wall / 1e6:.3f} Msamp/s on {torch.cuda.get_device_name(0)}; "
        f"CADU->products {pwall:.3f} s; launches {launches}")
    _check_avhrr_mhs(out_dir, truth, "main path products")
    for k in path_kernels:
        if launches[k.__name__] <= 0:
            raise AssertionError(f"main path never launched {k.__name__}")
    return launches, path


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals, microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def phase_profile(src: Path, work: Path, top: int = 8):
    """Each step of the main path run again on the main path's input (and
    the .soft it made): once timed by the host clock, ended by a
    synchronize, and once under torch.profiler, whose device trace gives
    the busy time (the union of kernel and copy intervals) and the idle
    share of the profiled wall. The profiler slows the host, so the
    profiled wall, and with it the idle share, is above the timed one."""
    import torch
    from torch.autograd import DeviceType
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    fname, pipe_id, _, _ = METOP
    for label, start, stop in (("psk_demod", "baseband", "soft"),
                               ("metop_ahrpt_decoder", "soft", "cadu")):
        pipe = _pipeline(fname, pipe_id, start, stop)

        def once(tag):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_pipeline(pipe, str(src), str(work / f"{label}-{tag}"),
                               start_level=start)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        out, wall = once("timed")
        with profiled() as prof:
            _, pwall = once("profiled")
        report_profile(f"profile {label}", prof, wall, pwall, top)
        src = Path(out)


def report_profile(label: str, prof, wall: float, pwall: float,
                   top: int = 8) -> dict:
    """Log the device busy time (the union of kernel and copy intervals),
    the idle share of the profiled wall, launches, copies and the top
    device kernels and host operators of a profiled run."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError(f"{label}: the profiler saw no device work")
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in dev) / 1e3
    by_name: dict = {}
    for e in dev:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us() / 1e3
    host = {a.key: a for a in prof.key_averages()}
    launches = sum(host[k].count for k in ("cudaLaunchKernel",
                                             "cuLaunchKernel")
                   if k in host)
    copies = sum(a.count for k, a in host.items()
                 if k.startswith("cudaMemcpy"))
    idle = 1 - busy / (pwall * 1e3)
    log(f"{label}: wall {wall * 1e3:.1f} ms, profiled "
        f"{pwall * 1e3:.1f} ms, device busy {busy:.2f} ms, idle share "
        f"{idle:.3f}, {launches} kernel launches, "
        f"{copies} cudaMemcpy* calls")
    for name, (c, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        log(f"   dev  {ms:9.3f} ms  x{c:<6d} {name[:80]}")
    for a in sorted(host.values(),
                    key=lambda a: -a.self_cpu_time_total)[:top]:
        log(f"   host {a.self_cpu_time_total / 1e3:9.3f} ms  "
            f"x{a.count:<6d} {a.key[:80]}")
    return {"busy_ms": busy, "idle_share": idle}


def phase_products(rng, work: Path) -> None:
    """Products at full width from the cadu level: metop_instruments once,
    then the processor on the card, on the CPU (composites must be
    pixel-identical) and on the card under torch.profiler, each on its own
    copy of the product directories (the processor skips presets it has
    already rendered in a directory)."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.models.metop import MetOpInstrumentsDecoderModule
    from satdump_tpu_torch.products.processor import process_path
    t0 = time.perf_counter()
    cadus, truth = sim.metop_instrument_cadus(rng, FULL_AVHRR_LINES,
                                              FULL_MHS_LINES)
    work.mkdir(parents=True, exist_ok=True)
    path = work / "full.cadu"
    cadus.tofile(path)
    t_sim = time.perf_counter() - t0
    base = work / "cuda"
    t1 = time.perf_counter()
    mod = MetOpInstrumentsDecoderModule(str(path), str(base / "metop_ahrpt"),
                                        {})
    mod.process()
    t_instr = time.perf_counter() - t1
    nbytes = sum(f.stat().st_size for f in (base / "AVHRR").glob("*.png"))
    log(f"products at full width: {len(cadus)} CADUs "
        f"({path.stat().st_size / 1e6:.1f} MB, made in {t_sim:.2f} s); "
        f"metop_instruments (host) {t_instr:.3f} s: {mod.stats['avhrr_lines']} "
        f"AVHRR lines, {mod.stats['mhs_lines']} MHS lines, AVHRR PNGs "
        f"{nbytes / 1e6:.1f} MB")
    for d in ("cpu", "profiled"):
        shutil.copytree(base, work / d)
    walls = {}
    for d in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        written = process_path(str(work / d / "dataset.json"),
                               device=d)
        torch.cuda.synchronize()
        walls[d] = time.perf_counter() - t
        log(f"products processor on {d}: {walls[d]:.3f} s, "
            f"{len(written)} composites")
    _check_avhrr_mhs(base, truth, "products at full width")
    same = {c: _same_images(load_img(base / c), load_img(work / "cpu" / c))
            for c in autogen_composites(METOP_PRODUCTS)}
    log(f"products at full width: composites identical on cuda and cpu: "
        f"{same}")
    if not all(same.values()):
        raise AssertionError(f"full-width composites differ: {same}")
    torch.cuda.synchronize()
    with profiled() as prof:
        t = time.perf_counter()
        process_path(str(work / "profiled" / "dataset.json"), device="cuda")
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t
    report_profile("profile products processor (cuda)", prof,
                   walls["cuda"], pwall)
    log(f"products at full width: phase {time.perf_counter() - t0:.1f} s")


def phase_idct(rng) -> None:
    """METEOR MSU-MR's dequantize + IDCT on 117,600 blocks: the card
    against the CPU, at most 1 LSB apart."""
    import torch
    from satdump_tpu_torch.image import jpeg
    n = IDCT_BLOCKS
    # quantized coefficients falling off with zig-zag index, as a coded
    # image's are, each block with its own quality factor's table
    scale = 40.0 / (1.0 + np.arange(64))
    zz = np.round(rng.laplace(0, 1, (n, 64)) * scale).astype(np.int32)
    q = np.stack([jpeg.quantization_table(float(f))
                  for f in rng.integers(50, 96, n)])
    log(f"IDCT: TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    got = jpeg.dequantize_idct(zz, q, device="cuda")
    ref = jpeg.dequantize_idct(zz, q, device="cpu")
    d = np.abs(got.astype(np.int16) - ref)
    log(f"IDCT {n} blocks: card against CPU max |diff| {int(d.max())} LSB, "
        f"{int((d > 0).sum())} of {d.size} pixels differ "
        f"({(d > 0).mean():.2e}); tolerance 1 LSB")
    if d.max() > 1:
        raise AssertionError(f"IDCT card and CPU differ by {d.max()} LSB")
    call = lambda: jpeg.dequantize_idct(zz, q, device="cuda")  # noqa: E731
    dev_ms = device_ms(call, 5)
    t = time.perf_counter()
    for _ in range(5):
        call()
    log(f"IDCT {n} blocks: device {dev_ms:.3f} ms a call (profiler, copies "
        f"included), {(time.perf_counter() - t) / 5 * 1e3:.1f} ms a call "
        f"on the host clock")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import satdump_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    rng = np.random.default_rng(SEED)
    probe = phase_probe(rng)
    k1 = phase_k1(rng)
    k2 = phase_k2(rng)
    work = ROOT / "satdump_tpu_torch" / "_build" / "smoke"
    try:
        phase_small_pass(rng, work)
        launches, main_input = phase_main(rng, work)
        phase_profile(main_input, work / "profile")
        phase_products(rng, work / "full")
        phase_idct(rng)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rows = []
    for name, src, rep, r in (
            ("viterbi_re", "satdump_tpu_torch/csrc/viterbi_re.cu",
             "satdump_tpu/ops/pallas/viterbi.py:136", k1),
            ("resample_arith_grid", "satdump_tpu_torch/csrc/resample_arith.cu",
             "satdump_tpu/ops/pallas/resample.py:103", k2),
            ("affine_probe", "satdump_tpu_torch/csrc/probe_affine.cu",
             "tools/pallas_smoke.py:10", probe)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "call_ms": r["call_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
