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
    at n_ext 8 / out_cap 1, at skew 0.03 (beyond the 2 % the TPU kernel's
    window allows) and at the resampled pipelines' default blocks
    (METEOR-M2 and METEOR-M2-x at 1 Msps, GOES HRIT at 6 Msps); the same
    numbers, the device time both with ext warm in L2 and after a 64 MB
    write, at the main path's block and at those three;
 4a. CaduChain's RS decode replayed from its CUDA graph, on its own
    generator (RS_SEED): two batches of 64 MetOp payloads (4 interleaved
    RS(255,223) codewords, dual basis) with 0-16 byte errors a codeword and
    17-20 in one of four, through one graph, equal to the direct decode
    and to the host codec; each one's time a call;
 4b. the classic chain's walkers (csrc/sample_walk.cu: the AGC, the PLL,
    the Costas loop at orders 2, 4 and 8; csrc/mm_clock.cu: M&M, complex at
    sps 4.5 and at INTEGRAL's sps 8 with its out_cap, and real): their SASS
    must hold no FFMA that rounds outside nvcc's own correctly rounded
    division and square root, and the AGC's and the PLL's kernels (and
    walk_math's) no float64 instruction; the AGC's and the PLL's float32
    sincos / atan2 / |x| (walk_math) must equal their plain versions bit
    for bit on 2^22 phases over [-2 pi, 2 pi], 2^22 (y, x) pairs over many
    decades with subnormals and signed zeros, and the special cases; each
    walker against its plain version on CPU copies of the same inputs, two
    blocks of 2^15 samples with the state carried (an M&M inc carried past
    a block end; the PLL also at max_offset 20, its walk for any phase),
    then one 2^18 block (the main path's): the AGC, the PLL and M&M equal,
    outputs and state; that block's device time, cycles a
    sample at the card's maximum SM clock, the plain version's time, and
    the latency bound: the loop-carried chain read off the SASS
    (tools/sass_chain.py, with the scoreboard latencies tools/op_latency.cu
    measures) times the steps. The Gardner walker (csrc/gardner_clock.cu),
    on its own generator (GARD_SEED), at the JAX test's sps 100/42 and at
    MetOp's 18/7: two blocks of 2^15 samples through the port's
    gardner_clock_recovery on the card (its launches counted there) and
    on the CPU, the state carried, then a 2^18 block through the wrapper,
    each equal to the plain version (symbols, valid mask and state), its
    SASS free of rounding FFMA, its time, cycles a symbol and latency
    bound as above;
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
 10. the resampled pipelines at their default rates, each pass on the card
    (timed, with the path kernels' counts set to 0 just before it and read
    just after: K1 and K2 must have launched) and on the CPU, whose .cadu
    must be byte-identical to the card's and hold the CADUs sent:
    METEOR-M2-x LRPT at 1 Msps (OQPSK, NRZ-M; one default psk_demod block
    of 125 * 2^18 samples, 36 strips of MSU-MR imagery) and METEOR-M2 LRPT
    at 1 Msps (2 strips), each then to products on the card and on the
    CPU from the card's .cadu (product images and the 321_false_color
    composite identical, channels within 8 LSB of the image sent); GOES-R
    HRIT at 6 Msps (BPSK, NRZ-M; ~2^23 samples) to CADU, its wall against
    the 6 Msamp/s live limit; METEOR-M2 with freq_shift, dc_block and a
    Doppler provider; NOAA APT at 1 Msps (40 lines) to products, the
    synced image, products and composite identical on both devices and
    the image following the lines sent. Then psk_demod's step profile on
    the METEOR-M2-x and GOES HRIT inputs (device busy/idle; launches, copies
    and H2D time a block) and the device time of the input resampler and
    of dc_block at the three pipelines' default blocks;
 11. the classic demod chain (pm_demod, fsk_demod, the simple PSK decoder):
    INTEGRAL S-band at 2.096 Msps (pm_demod -> ccsds_conv_concat_decoder,
    bpsk_90, RS(255,239) x 4; ~2^21 samples) on the card, every CADU sent
    decoded, K1 and the four walkers launched (counts set to 0 just before
    and read just after); NOAA HRPT's pm_demod at 3 Msps and Crew Dragon's
    fsk_demod at 6 Msps, ~2^23 samples each to .soft, each wall against its
    live rate and its softs against the bits sent; ELEKTRO-L GGAK (pm_demod
    -> simple PSK), SpaceTeamSat1 9k6 (fsk_demod resampled from 140 ksps ->
    simple PSK) and Saral (psk_demod -> conv-concat at rs_i 5) on the card
    and on the CPU, the .cadu byte-identical and holding the CADUs sent;
 12. the deep-space FEC (CCSDS 131.0-B turbo and LDPC): turbo_bcjr (the
    max-log BCJR) against its plain version on the card, bit-identical, at
    base 223 at rates 1/2, 1/3, 1/4 and 1/6 (both constituent codes) and
    at base 1115 with JUICE's 58-frame batch; its SASS must hold no FFMA
    that rounds and no float64 instruction; at base 1115 its device time,
    time a call, the plain version's time, the latency bound (the SASS
    chain of the longer recursion times the steps) and the bound; JUICE
    X-band at 2.105 Msps (pm_demod -> ccsds_turbo_decoder, rate 1/2, base
    1115, 5 iterations; 32 frames) on the card, every frame sent decoded
    with a valid CRC, the four walkers and turbo_bcjr launched; TGO from
    .soft (one 2^20-soft block of 58 frames, 50 iterations), every frame
    decoded, its wall against the signal's length and turbo_bcjr's
    launches; GOES-R raw sounder data at 2 Msps (psk_demod BPSK ->
    ccsds_ldpc_decoder, C2 with 8192-bit CADUs in the internal stream; 55
    CADUs in 64 LDPC frames) on the card (K2 launched) and on the CPU, the
    .cadu byte-identical and holding every CADU sent, and the C2 min-sum's
    device time and launches for a 32-frame batch; Orion from .soft
    (OQPSK with the Q rail a symbol late, AR4JA 1/2 k 1024, 64 frames) on
    both devices, the frames identical and equal to those sent;
 13. DVB-S2 and DVB-S: GOES-R GRB at full width (8,665,938 sym/s, QPSK
    9/10 = MODCOD 11, normal frames, at 2 sps = 17.33 Msps; ~4.36 M
    samples, 67 PLFRAMEs, 230 CADUs in the first 65) through the port's
    run_pipeline on
    the card (dvbs2_demod -> goes_grb_cadu_extractor), twice: every CADU
    decoded one that was sent, at most 2 missing, agc_walk launched (its
    count set to 0 just before each pass and read just after), each wall
    against the live 17.33 Msamp/s; one block's split (the front end's
    and demap + LDPC's device ms, the host PL layer's and BCH's ms, the
    copies, launches and idle share); the same pipeline on 9 PLFRAMEs on
    the card and the CPU, the .bbframe and .cadu byte-identical; the
    `dvbs2` pipeline (its file's MODCOD 4 and 1 Msym/s, short frames) on
    200 TS packets on the card, every packet out one sent (dvbs2_demod
    given no modcod raises); and
    dvbs_demod at rate 3/4 (found by its rate search) on the card and the
    CPU, the .ts byte-identical and holding packets sent, with the
    kernels it launched;
 14. FengYun-3 AHRPT, the NOAA and METEOR HRPT family and Inmarsat, each
    stage of each pass with the kernels' counts set to 0 just before it
    and read just after: FY-3D AHRPT at full rate (90 Msps, 30 Msym/s, sps
    3; ~2^23 samples) from baseband to CADU on the card, every CADU
    decoded one that was sent (at most 2 missing) and K1 launched, its
    wall against the live 90 Msamp/s, and one rail's lock search (wall,
    device kernels) and K1 call apart; FY-3A/B at 8.4 Msps carrying a VIRR
    line and the VCID-12 sounders, baseband to products on the card and
    the CPU: .cadu identical and equal to the CADUs sent, products
    identical; NOAA GAC (BPSK at 6 Msps, sps 2.254) to .frm and products on
    the card, K2 launched, every frame found and AVHRR equal to the lines
    sent, the products from the card's .frm on the CPU identical; NOAA
    HRPT and METEOR HRPT at 3 Msps (pm_demod: the four walkers launched),
    5 minor frames and 4 MSU-MR lines, every frame found and the imagery
    equal to the lines sent, the card's .soft decoded on the CPU to
    identical .frm / .cadu and products; NOAA DSB from softs on both;
    Inmarsat STD-C (48 ksps), Aero 10.5k (12 ksps, K2) and Aero 1.2k (48
    ksps, the walkers) from baseband to messages on the card, the card's
    .soft on the CPU to identical .frm and message files, and the block
    Viterbi's wall and device kernels a frame against the frame's air
    time;
 15. JPSS HRD, GOES HRIT's products level and the host decoders, each
    level of each pass on the card with every kernel's count set to 0 just
    before it and read just after, then on the CPU: the .cadu / .frm / JSON
    files and the PNGs byte-identical, the products equal. JPSS-2 HRD at
    its full 40 Msps (OQPSK at 25 Msym/s, sps 1.6; ~2^23 samples, ~500
    CADUs carrying six VIIRS bands, ATMS scans and an OMPS nadir frame)
    from baseband to products: every CADU sent decoded (at most 2
    missing), K2 launched by psk_demod and K1 by the decoder, the VIIRS,
    ATMS and OMPS products equal to what was sent, the wall against the
    live 40 Msamp/s; Suomi NPP HRD at 25 Msps (QPSK, sps 5/3) the same on
    a shorter pass; GOES-R HRIT at 6 Msps carrying a Rice-coded ABI image
    and an EMWIN file to products, the image and the file equal to those
    sent; Aqua DB at 15 Msps to MODIS (the strip path), GOES GVAR (K2) to
    the imager product, GOES-N sensor data (K2) to frames, M10 radiosondes
    at 96 ksps and Orbcomm STX at 48 ksps behind fsk_demod (the AGC and
    M&M walkers) to positions and ephemerides, each equal to what was
    sent; and dvbs2_test's network_server sending a .ts file's packets to
    a receiver on localhost;
 16. the xRIT image decoders and GOES-R GRB's products on the port's own
    codecs: ELEKTRO-L HRIT (K2 then K1) and GK-2A HRIT from baseband to
    their images (GK-2A's J2K channel a 32 x 2,200 12-bit scene encoded
    by the port's compress_j2k), GRB at 17.33 Msps to ABI and GLM products
    (its ABI blocks encoded by the port too), HimawariCast's decoder from
    a .cadu, every committed J2K fixture, the J2K encoder's host ms, and
    the islow IDCT, each on the card and the CPU, identical;
 17. the live path, on its own generator: MetOp AHRPT (6 Msps, sps 18/7;
    2^23 samples, 32 blocks) served unpaced by a RemoteIQServer thread at
    16 bits and decoded through the CLI's `live metop_ahrpt tcp://...`,
    /status polled mid-pass: every CADU sent decoded (at most 2 missing),
    K1 and K2 launched (counts set to 0 just before and read just after),
    the .soft and .cadu byte-identical to run_pipeline's on the same
    samples; its wall against the live 6 Msamp/s, host ms a block of
    decode_iq_pkt, the rebuffer, the FFT tap, psk_demod, the decoder and
    the .soft write, and a profiled run's idle share, launches and copies
    a block. Two METEOR LRPT VFOs of one 2.048 Msps stream (2^25 samples;
    METEOR-M2-x OQPSK at +400 kHz, METEOR-M2 QPSK at -400 kHz, 72 ksym/s,
    each VFO at 256 ksps) through `live --vfo` from a file: every CADU of
    each carrier decoded, K1 and K2 launched in each VFO, the first 8
    channelizer blocks on the card within 2e-5 of the CPU's, the
    channelizer's device ms and copies a block, the path's idle share.
    METEOR-M2 LRPT at 1 Msps carrying NOAA 19's predicted Doppler at
    137.1 MHz, live with set_doppler on the tracker, on the card and the
    CPU: every CADU decoded, the .cadu byte-identical;
 18. the projection level and first-party ingest, on its own generator
    (GEO_SEED): the AVHRR/3 product of a 1,800-line, 2048-column MetOp pass
    (made as phase 8 makes it) with a MetOp-B TLE an hour before it;
    compute_gcps (host), warp_to_equirect at 2048 columns with the spline
    on the card, twice (float64; its CUDA-event ms first and warm, its
    bound, points x GCPs and peak memory), 64 of its rows' spline on the
    CPU (coordinates within 1e-6 px, pixels within GEO_PIXEL_SHARE at 1
    LSB), the card's spline at its own GCPs, the JAX package's float32
    form of the spline on the card against it, the whole warp at 512
    columns on both devices, smart_warp_to_equirect at 8192 with tile 1024
    on the card and at 2048 / 512 on both; reproject_equirect to a
    stereographic and a geostationary target, a lat/lon grid, a GeoJSON
    map the phase writes, city labels, the GeoTIFF and its tags read back.
    `ingest --process` through the CLI on the card and on the CPU: a SEVIRI
    .nat at its 3,712 columns (464 lines, 12 channels with HRV) and two
    band-13 HSD segments at 5,500 columns (550 lines each), the products
    and composites equal. `bitview` through the CLI on the main path's
    .cadu (the period it finds; given 8192 bits, every row starts with the
    ASM) and on CADUs of random payload (the period found: 8192 bits);
 19. the scale-out, K3 and the bench, on its own generator (MC_SEED): the
    main path's signal (phase 6's ~2^23 MetOp samples) through psk_demod
    `multichip: true` on 4 ranks sharing the card (one process a rank,
    gloo between them; K2 and K3 launched in the ranks, counted there),
    then metop_ahrpt_decoder (K1, and K3 in its lock search): every CADU
    sent decoded, the .cadu byte-equal to phase 6's single-device one, the
    wall from spawn to .soft with the ranks' set-up and step apart, then
    Msamp/s to CADU; K3 (csrc/viterbi_block.cu) against its plain version,
    tolerance 0 (the plain version on CPU copies of the inputs), on 4 rows
    of 2^15 pairs of that pass's softs (renorm on) and on 8
    tiled-decoder lanes (renorm off), its SASS free of FFMA, its
    time there and at a full-width shard, a lock search's batch and an
    Aero 10.5k frame, its bound and the latency bound of its SASS chains;
    dryrun_multichip(8) on the card (its step, then 12 of 12 CADUs through
    the runner), its step's softs within 5 LSB of the CPU's; `bench` on
    the card at its default n, every category rated;
 20. one JSON line describing each kernel, then the card's line and the
    result line. No kernel of the port lies on the products level, on the
    projection level or on the FM path.

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


def call_ms(fn, reps: int, back_to_back: bool = False) -> float:
    """Time per call of fn(), after one warm-up call: the median over `reps`
    calls of CUDA events recorded around each single call (for a kernel's
    wrapper this includes the host's launch path wherever that takes
    longer than the kernel), or with `back_to_back` the time between two
    events around all `reps` calls, over reps (the device time of a call
    whose work outlasts the host's enqueueing of the next)."""
    import torch
    fn()
    torch.cuda.synchronize()
    if back_to_back:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
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
    """Every CUDA source of the port, and tools/op_latency.cu's program
    beside them (phase 4b's latencies), one nvcc each, all at once."""
    from satdump_tpu_torch.ops.cuda import _build
    from satdump_tpu_torch.tools import sass_chain
    t0 = time.perf_counter()
    latency = sass_chain.start_latency_build()
    secs = _build.build()
    sass_chain.finish_latency_build(latency)
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


def _sass(name: str) -> str:
    """`cuobjdump -sass` of csrc/<name>.cu's built library."""
    from satdump_tpu_torch.ops.cuda import _build
    from satdump_tpu_torch.tools.sass_chain import cuobjdump_sass
    return cuobjdump_sass(_build._target(name))


def _k1_sass():
    """Static instruction counts of each K1 kernel in its SASS; fails if
    any FFMA is there (the path-metric sums must be plain adds)."""
    sass = _sass("viterbi_re")
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
    # the resampled pipelines' default blocks after the input resampler
    # (psk_demod's block * interp / decim samples + 7 of history)
    ("METEOR-M2 1 Msps: 7/25 of 25*2^18, sps 35/9", 1835008 + 7,
     METEOR_SPS, 0.0, None),
    ("METEOR-M2-x 1 Msps: 21/125 of 125*2^18, sps 7/3", 5505024 + 7,
     7 / 3, 0.0, None),
    ("GOES HRIT 6 Msps: 3/5 of 5*2^18, sps 3.6e6/927e3", 786432 + 7,
     3.6e6 / 927e3, 0.0, None),
)
# the cases above that are timed: the main path's block, then the
# resampled pipelines' blocks
K2_TIMED = ("n=2^18 skew 0",) + tuple(c[0] for c in K2_CASES[-3:])


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


def _k2_case(rng, label: str, n_ext: int, sps: float, skew: float,
             cap, bank):
    """K2 against its plain version on random samples of one K2_CASES
    shape (cap None: psk_demod's out_cap); returns (max |err|, ext,
    start, omega, cap)."""
    import torch
    from satdump_tpu_torch.ops.cuda.resample import (
        resample_arith_grid, resample_arith_grid_plain)
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
    return err, ext, start, omega, cap


def phase_k2(rng):
    """K2 against its plain version on the card."""
    import torch
    from satdump_tpu_torch.ops.cuda.resample import (
        resample_arith_grid, resample_arith_grid_plain)
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    bank = torch.as_tensor(mm_interpolator_bank()).cuda()
    res = {"max_abs_err": 0.0}
    for label, n_ext, sps, skew, cap in K2_CASES:
        err, ext, start, omega, cap = _k2_case(rng, label, n_ext, sps, skew,
                                               cap, bank)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if label not in K2_TIMED:
            continue
        kern = lambda: resample_arith_grid(  # noqa: E731
            ext, start, omega, bank, out_cap=cap)
        t = {"ms": kernel_ms(kern, "resample_arith_kernel", 50),
             "cold_ms": kernel_ms_cold(kern, "resample_arith_kernel", 50),
             "call_ms": call_ms(kern, 50),
             "plain_ms": call_ms(lambda: resample_arith_grid_plain(
                 ext, start, omega, bank, out_cap=cap), 20)}
        nbytes = n_ext * 8 + bank.numel() * 4 + 8 + cap * 8
        # flops: 8 complex-by-real FMAs (2 each, 2 flops each) and the
        # position
        ops = cap * (8 * 4 + 6)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, ops, H100_F32_FLOPS)
        log(f"K2 times at {label} (n_ext {n_ext}, out_cap {cap}): kernel "
            f"{t['ms']:.4f} ms warm in L2, {t['cold_ms']:.4f} ms after a "
            f"64 MB write (profiler), {t['call_ms']:.4f} ms per wrapper "
            f"call (events), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
        if label == K2_TIMED[0]:                  # the main path's block
            res.update(t)
    return res


# CaduChain's RS decode replayed from its CUDA graph (phase 4a), on a
# generator of its own so that no later phase's inputs move
RS_SEED = SEED + 21
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


def phase_rs_graph(rng) -> dict:
    """The RS decode of `CaduChain` on the card, replayed from its CUDA
    graph, equal to the direct decode and to the host codec on two batches
    through one graph; and each one's time a call."""
    import torch
    from satdump_tpu_torch.ops.fec import cadu_chain
    chain = cadu_chain.CaduChain(cadu_bits=8192, chunk_pairs=1 << 14,
                                 rs_i=4, device="cuda")
    for batch in range(2):
        data, want, want_err = _rs_case(rng, RS_FRAMES)
        x = torch.as_tensor(data.astype(np.int32), device="cuda")
        got, got_err = chain._rs_decode(x)
        ref, ref_err = chain.rs.decode_interleaved(x, 4)
        for name, a, b in (("graph", got, want), ("graph", got_err, want_err),
                           ("direct", ref, want),
                           ("direct", ref_err, want_err)):
            if not np.array_equal(a.cpu().numpy(), b):
                raise AssertionError(f"RS decode {name} differs from the "
                                     f"host codec in batch {batch}")
    if not cadu_chain._RS_GRAPHS:
        raise AssertionError("CaduChain's RS decode was not graphed")
    t = {"graph_ms": call_ms(lambda: chain._rs_decode(x), 20),
         "direct_ms": call_ms(lambda: chain.rs.decode_interleaved(x, 4), 20),
         "failed_codewords": int((want_err < 0).sum())}
    log(f"RS decode of {RS_FRAMES} CADUs x 4 codewords: graph replay equal "
        f"to the direct decode and the host codec ({t['failed_codewords']} "
        f"codewords past correction), {t['graph_ms']:.3f} ms a call "
        f"replayed, {t['direct_ms']:.3f} ms direct (events)")
    return t


# the classic chain's walkers (phase 4b): two blocks of WALK_BLOCK samples
# with the state carried, then one block of WALK_TIMED (the classic demods'
# default block, the one the main path gives them), each held to its plain
# version on CPU copies of the same inputs; the WALK_TIMED block is timed
WALK_BLOCK, WALK_TIMED = 1 << 15, 1 << 18
# a walker launch takes 10-120 ms at WALK_TIMED, so CUDA events around
# single launches time it (the wrapper's host work is microseconds), and
# no profiler session can lose its records
WALK_REPS = 5
# the AGC and the PLL do only correctly rounded float32 operations, M&M
# float32 and correctly rounded float64 ones: equal (tolerance 0). The
# Costas loop forms e^{-j phase} with float64 sin / cos, where the card's
# and the CPU's libm may round an ulp of a double apart; about one sample in
# 2^28 then rounds otherwise in float32 and the loop carries that last-bit
# step on: within WALK_ATOL
WALK_ATOL = 1e-4
# the walkers' kernels that must hold no float64 instruction
FP32_WALKERS = ("sample_walk_kernelILi0E", "sample_walk_kernelILi1E",
                "walk_math_kernel")
# (label, mode: "agc" | "pll" | Costas order, loop bw, limit)
WALK_CASES = (
    ("agc", "agc", None, None),
    ("pll", "pll", 0.01, 0.5),
    ("costas order 2", 2, 0.005, 1.0),
    ("costas order 4", 4, 0.005, 1.0),
    ("costas order 8", 8, 0.005, 1.0),
    ("costas order 2, freq_limit 2e-4", 2, 0.02, 2e-4),
    ("pll, max_offset 20", "pll", 0.01, 20.0),
)
# held to their plain versions, not timed: Costas against its frequency
# limit, and the PLL on its walk for phases not known to stay in range
# (max_offset 20 puts a step's sum beyond the in-range wrap's reach)
WALK_UNTIMED = ("costas order 2, freq_limit 2e-4", "pll, max_offset 20")
# (label, sps, complex mode): NOAA HRPT's pm_demod, INTEGRAL's (the main
# path's: sps 8 and its out_cap) and a real-mode (fsk_demod) case
MM_CASES = (("mm complex, sps 4.5", 4.5, True),
            ("mm complex, sps 8", 8.0, True),
            ("mm real, sps 7.99", 7.99, False))


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
    """The wrapper and the plain version of one walker case, as
    f(x, state) -> (y, state')."""
    from satdump_tpu_torch.ops import costas
    from satdump_tpu_torch.ops.cuda import sample_walk as sw
    if mode == "agc":
        p = (1e-2, 1.0, 65536.0)      # rate, reference, ceiling
        return (lambda x, s: sw.agc_walk(x, s, *p),
                lambda x, s: sw.agc_walk_plain(x, s, *p))
    a, b = costas.costas_gains(bw)
    if mode == "pll":
        return (lambda x, s: sw.pll_walk(x, s, a, b, limit),
                lambda x, s: sw.pll_walk_plain(x, s, a, b, limit))
    return (lambda x, s: sw.costas_walk(x, s, a, b, mode, limit),
            lambda x, s: sw.costas_walk_plain(x, s, a, b, mode, limit))


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


def _mm_state0(sps: float):
    from satdump_tpu_torch.ops import clock_recovery
    return clock_recovery._pack(clock_recovery.mm_init(omega=sps,
                                                       device="cpu"))


def _max_err(a, b) -> float:
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        return float((a != b).sum())
    return float((a.to(torch.complex128) - b.to(torch.complex128)).abs().max()
                 ) if a.numel() else 0.0


def _held(what: str, dev: tuple, cpu: tuple, tol: float, note: str) -> float:
    """The largest difference between a walker's outputs and state on the
    card and its plain version's; raises beyond tol."""
    import torch
    torch.cuda.synchronize()
    err = max(_max_err(a, b) for a, b in zip(dev, cpu))
    log(f"{what}: max |err| {err:.3e} against plain, {note} "
        f"(tolerance {tol})")
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{what} differs from its plain version: {err}")
    return err


def _timed_plain(fn):
    """fn()'s result and its host milliseconds."""
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def _walker_sass() -> dict:
    """The walkers' SASS: no FFMA that rounds (an FMA that contracts the
    port's own products and sums would part the card from the plain
    versions) but with a zero factor or inside nvcc's correctly rounded
    division and square root (sass_chain.rounding_ffma); no float64
    instruction in FP32_WALKERS; then each walk loop's loop-carried chain
    read off it (tools/sass_chain.py), with the latencies of the
    instructions that wait on a scoreboard measured on this card
    (tools/op_latency.cu). Keyed by mode: "agc", "pll", the Costas order,
    "mm complex", "mm real"."""
    from satdump_tpu_torch.tools import sass_chain as sc
    measured, dropped = sc.measured_latencies()
    log(f"scoreboard latencies on the card, cycles (op_latency.cu): "
        f"{json.dumps(measured)}; dropped (its SASS lacks the instruction): "
        f"{json.dumps(dropped)}")
    funcs, fp32 = [], set()
    for src in ("sample_walk", "mm_clock", "gardner_clock"):
        for f in sc.parse_sass(_sass(src)):
            ffma = sum(x.mnemonic == "FFMA" for x in f.ins)
            rounding, inside = sc.rounding_ffma(f)
            fp64 = sc.fp64_instructions(f)
            seeds = sum(x.op in ("MUFU.RCP", "MUFU.RSQ") for x in f.ins)
            log(f"{src} SASS {f.name[-44:]}: {len(f.ins)} instructions, "
                f"FFMA {ffma} ({inside} in nvcc's division / square root, "
                f"{ffma - inside - len(rounding)} with a zero factor), "
                f"float64 {len(fp64)}, MUFU.RCP / RSQ {seeds}")
            if rounding:
                raise AssertionError(f"{src} SASS holds FFMA that rounds: "
                                     f"{[x.text for x in rounding[:4]]}")
            if any(k in f.name for k in FP32_WALKERS):
                fp32.add(next(k for k in FP32_WALKERS if k in f.name))
                if fp64:
                    raise AssertionError(
                        f"{f.name} holds float64 instructions: "
                        f"{[x.text for x in fp64[:6]]}")
            funcs.append(f)
    if fp32 != set(FP32_WALKERS):
        raise AssertionError(f"float32 walkers found: {sorted(fp32)}")
    fixed = sc.fixed_latencies(funcs)
    log(f"fixed latencies read off the walkers' stall counts, cycles: "
        f"{json.dumps(fixed, sort_keys=True)}")
    out = {}
    for f in funcs:
        m = re.search(r"sample_walk_kernelILi(\d)E|mm_clock_kernelILb(\d)E"
                      r"|(gardner_clock_kernel)", f.name)
        if m is None:
            continue
        mode = ({"0": "agc", "1": "pll"}.get(m.group(1), int(m.group(1)))
                if m.group(1) else "gardner" if m.group(3) else
                ("mm complex" if m.group(2) == "1" else "mm real"))
        lat = sc.Latency(fixed, measured)
        r = sc.chain(f, lat)
        log(f"SASS chain {mode}: {r['cycles_a_step']:.2f} cycles a step "
            f"({r['cycles_a_pass']:.0f} a pass of {r['steps_a_pass']} steps, "
            f"{r['instructions_a_pass']} instructions); the schedule's stall "
            f"counts {r['stall_cycles_a_step']:.1f} a step; chain opcodes "
            f"{json.dumps(r['chain_opcodes'])}; at the smallest latency "
            f"{json.dumps(r['unmeasured'])}")
        out[mode] = r
    if len(out) != 8:
        raise AssertionError(f"walk loops found for {sorted(map(str, out))}")
    return out


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


def _same_bits(a: np.ndarray, b: np.ndarray) -> int:
    """How many elements differ in their bits (two NaNs count as equal)."""
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) &
                                                    np.isnan(b))
    return int((~same).sum())


def _ulp_max(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest error of float32 `got` against float64 `ref`, in float32
    ulp of the reference, over the finite references."""
    ok = np.isfinite(ref) & np.isfinite(got)
    sp = np.spacing(np.abs(ref[ok]).astype(np.float32)).astype(np.float64)
    return float((np.abs(got[ok].astype(np.float64) - ref[ok]) / sp).max())


def phase_walk_math(rng) -> None:
    """The AGC's and the PLL's float32 functions on the card (walk_math)
    against their plain versions, bit for bit, on the grids of
    _walk_math_inputs; their largest error against float64 numpy is
    logged."""
    import torch
    from satdump_tpu_torch.ops.cuda.sample_walk import walk_math
    ph, y, x = _walk_math_inputs(rng)
    cases = (("sincos", (ph,), lambda: (np.sin(ph.astype(np.float64)),
                                        np.cos(ph.astype(np.float64)))),
             ("atan2", (y, x), lambda: (np.arctan2(y.astype(np.float64),
                                                   x.astype(np.float64)),)),
             ("abs", (y, x), lambda: (np.hypot(y.astype(np.float64),
                                               x.astype(np.float64)),)))
    for fn, args, ref in cases:
        dev = walk_math(fn, *(torch.from_numpy(a).cuda() for a in args))
        with np.errstate(all="ignore"):
            cpu = walk_math(fn, *(torch.from_numpy(a) for a in args))
            refs = ref()
        torch.cuda.synchronize()
        diff = sum(_same_bits(d.cpu().numpy(), c.numpy())
                   for d, c in zip(dev, cpu))
        # |x| unscaled: its squares stay normal for components in
        # [1e-18, 1e18]; atan2 and sincos: every finite input
        dom = np.ones(len(args[0]), bool) if fn != "abs" else \
            (np.abs(y) < 1e18) & (np.abs(x) < 1e18) & (
                (np.abs(y) > 1e-18) | (np.abs(x) > 1e-18))
        ulp = [_ulp_max(c.numpy()[dom], r[dom]) for c, r in zip(cpu, refs)]
        log(f"walk_math {fn} on {len(args[0])} points: {diff} outputs differ "
            f"from plain in their bits (tolerance 0); largest error against "
            f"float64 {', '.join(f'{u:.3f}' for u in ulp)} ulp")
        if diff:
            raise AssertionError(f"walk_math {fn} differs from its plain "
                                 f"version at {diff} points")


def phase_walkers(rng) -> dict:
    """The sample walkers and the M&M walker against their plain versions:
    two blocks of WALK_BLOCK samples with the state carried (the kernel's
    state tensor on the card, the plain version's on the CPU), then a
    WALK_TIMED block; that block's device time (CUDA events around single
    launches), in cycles a sample at the card's maximum SM clock, the plain
    version's time and the bounds."""
    import torch
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    mhz = sm_clock_mhz()
    chains = _walker_sass()
    phase_walk_math(rng)
    res = {}
    for label, mode, bw, limit in WALK_CASES:
        kern, plain = _walk_call(mode, bw, limit)
        tol = 0 if mode in ("agc", "pll") else WALK_ATOL
        s_dev = torch.tensor([1.0] if mode == "agc" else [0.0, 0.0],
                             dtype=torch.float32, device="cuda")
        s0, s_cpu = s_dev.clone(), s_dev.cpu()
        err = 0.0
        x = _walk_input(rng, 2 * WALK_BLOCK)
        for blk in range(2):
            xb = torch.from_numpy(x[blk * WALK_BLOCK:(blk + 1) * WALK_BLOCK])
            y_dev, s_dev = kern(xb.cuda(), s_dev)
            y_cpu, s_cpu = plain(xb, s_cpu)
            err = max(err, _held(
                f"walker {label} block {blk}", (y_dev, s_dev), (y_cpu, s_cpu),
                tol, f"{int((y_dev.cpu() == y_cpu).sum())} of {WALK_BLOCK} "
                f"outputs equal, state {s_dev.cpu().tolist()}"))
        if label in WALK_UNTIMED:
            res[label] = {"max_abs_err": err}
            continue
        xt = torch.from_numpy(_walk_input(rng, WALK_TIMED))
        xt_dev = xt.cuda()
        (y_cpu, s_cpu), plain_ms = _timed_plain(lambda: plain(xt, s0.cpu()))
        y_dev, s_dev = kern(xt_dev, s0)
        e = _held(f"walker {label} at {WALK_TIMED}", (y_dev, s_dev),
                  (y_cpu, s_cpu), tol,
                  f"{int((y_dev.cpu() == y_cpu).sum())} of {WALK_TIMED} "
                  f"outputs equal, state {s_dev.cpu().tolist()}")
        t = {"max_abs_err": max(err, e), "plain_ms": plain_ms,
             "ms": call_ms(lambda: kern(xt_dev, s0), WALK_REPS)}
        res[label] = _walk_timing(t, WALK_TIMED, WALK_TIMED,
                                  16 * WALK_TIMED, mhz, chains[mode], label)
    bank = torch.as_tensor(mm_interpolator_bank())
    bank_dev = bank.cuda()
    carried = []            # inc past each block end (sps 8 may carry none)
    for label, sps, cm in MM_CASES:
        kern, plain = _mm_call(sps, cm)

        def signal(n):
            x = _walk_input(rng, n, sps)
            return x if cm else x.real.astype(np.complex64)
        x = signal(2 * WALK_BLOCK)
        s_dev, s_cpu = _mm_state0(sps).cuda(), _mm_state0(sps)
        h = torch.zeros(7, dtype=torch.complex64)
        err = 0.0
        for blk in range(2):
            ext = torch.cat([h, torch.from_numpy(
                x[blk * WALK_BLOCK:(blk + 1) * WALK_BLOCK])])
            h = ext[WALK_BLOCK:]
            out_dev = kern(ext.cuda(), WALK_BLOCK, s_dev, bank_dev)
            out_cpu = plain(ext, WALK_BLOCK, s_cpu, bank)
            s_dev, s_cpu = out_dev[2], out_cpu[2]
            carried.append(int(s_cpu[2:3].view(torch.int32)))
            err = max(err, _held(
                f"walker {label} block {blk}", out_dev, out_cpu, 0,
                f"valid masks and state included, {int(out_cpu[1].sum())} "
                f"symbols, inc carried {carried[-1]}"))
        ext = torch.from_numpy(np.concatenate([np.zeros(7, np.complex64),
                                               signal(WALK_TIMED)]))
        ext_dev, s0 = ext.cuda(), _mm_state0(sps)
        s0_dev = s0.cuda()
        out_cpu, plain_ms = _timed_plain(
            lambda: plain(ext, WALK_TIMED, s0, bank))
        out_dev = kern(ext_dev, WALK_TIMED, s0_dev, bank_dev)
        nsyms = int(out_cpu[1].sum())
        e = _held(f"walker {label} at {WALK_TIMED}", out_dev, out_cpu, 0,
                  f"valid masks and state included, {nsyms} symbols of "
                  f"out_cap {len(out_cpu[1])}")
        t = {"max_abs_err": max(err, e), "plain_ms": plain_ms,
             "ms": call_ms(lambda: kern(ext_dev, WALK_TIMED, s0_dev,
                                        bank_dev), WALK_REPS)}
        res[label] = _walk_timing(
            t, WALK_TIMED, nsyms, (WALK_TIMED + 7) * 8 + len(out_cpu[1]) * 9
            + 128 * 8 * 4, mhz, chains["mm complex" if cm else "mm real"],
            label)
    if not any(carried):
        raise AssertionError(f"no M&M case carried an inc past a block end "
                             f"({carried})")
    res.update(_gardner_cases(np.random.default_rng(GARD_SEED), mhz,
                              chains["gardner"]))
    return res


# the Gardner walker (phase 4b), on a generator of its own so that no later
# phase's inputs move: (label, sps) at the JAX test's sps and at MetOp's,
# complex mode, the demods' loop defaults (clock alpha 8.7e-3, omega limit
# 0.005); neither package's pipelines call Gardner, so its launches come
# from gardner_clock_recovery driven here
GARD_SEED = SEED + 20
GARD_CASES = (("gardner, sps 100/42", 100 / 42), ("gardner, sps 18/7", 18 / 7))
GARD_ALPHA, GARD_LIMIT = 8.7e-3, 0.005


def _gardner_cases(rng, mhz: float, chain: dict) -> dict:
    """The Gardner walker against its plain version: for each GARD_CASES
    sps two blocks of WALK_BLOCK through the port's gardner_clock_recovery
    on the card (the launch count set to 0 just before and read just
    after) and on the CPU, the state carried, then a WALK_TIMED block
    through the wrapper: symbols, valid masks and state equal (tolerance
    0), the block's device time, cycles a symbol and latency bound."""
    import torch
    from satdump_tpu_torch.ops import clock_recovery as cr
    from satdump_tpu_torch.ops.cuda import gardner
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    bank = torch.as_tensor(mm_interpolator_bank())
    bank_dev = bank.cuda()
    res = {}
    for label, sps in GARD_CASES:
        kw = dict(omega_mid=sps, gain_omega=GARD_ALPHA ** 2 / 4,
                  gain_mu=GARD_ALPHA, omega_relative_limit=GARD_LIMIT)
        x = _walk_input(rng, 2 * WALK_BLOCK, sps)
        st = {d: cr.gardner_init(sps, device=d) for d in ("cuda", "cpu")}
        out = {"cuda": [], "cpu": []}
        torch.cuda.synchronize()
        gardner.gardner_walk.launches = 0
        for blk in range(2):
            xb = torch.from_numpy(x[blk * WALK_BLOCK:(blk + 1) * WALK_BLOCK])
            st["cuda"], y, v = cr.gardner_clock_recovery(st["cuda"],
                                                         xb.cuda(), **kw)
            out["cuda"].append((y, v, cr._gardner_pack(st["cuda"])))
        torch.cuda.synchronize()
        launches = gardner.gardner_walk.launches
        if launches != 2:
            raise AssertionError(f"{label}: gardner_clock_recovery launched "
                                 f"the walker {launches} times in 2 blocks")
        err, carried = 0.0, []
        for blk in range(2):
            xb = torch.from_numpy(x[blk * WALK_BLOCK:(blk + 1) * WALK_BLOCK])
            st["cpu"], y, v = cr.gardner_clock_recovery(st["cpu"], xb, **kw)
            carried.append(int(st["cpu"].inc))
            err = max(err, _held(
                f"walker {label} block {blk}", out["cuda"][blk],
                (y, v, cr._gardner_pack(st["cpu"])), 0,
                f"valid masks and state included, {int(v.sum())} symbols, "
                f"inc carried {carried[-1]}"))
        ext = torch.from_numpy(np.concatenate([np.zeros(7, np.complex64),
                                               _walk_input(rng, WALK_TIMED,
                                                           sps)]))
        s0 = cr._gardner_pack(cr.gardner_init(sps, device="cpu"))
        ext_dev, s0_dev = ext.cuda(), s0.cuda()
        cap = int(np.ceil(WALK_TIMED / (sps * (1 - GARD_LIMIT)))) + 2
        wk = dict(omega_mid=sps, gain_omega=GARD_ALPHA ** 2 / 4,
                  gain_mu=GARD_ALPHA, omega_limit=GARD_LIMIT * sps,
                  out_cap=cap)
        out_cpu, plain_ms = _timed_plain(lambda: gardner.gardner_walk_plain(
            ext, WALK_TIMED, s0, bank, **wk))
        out_dev = gardner.gardner_walk(ext_dev, WALK_TIMED, s0_dev, bank_dev,
                                       **wk)
        nsyms = int(out_cpu[1].sum())
        e = _held(f"walker {label} at {WALK_TIMED}", out_dev, out_cpu, 0,
                  f"valid masks and state included, {nsyms} symbols of "
                  f"out_cap {cap}")
        t = {"max_abs_err": max(err, e), "plain_ms": plain_ms,
             "launches": launches, "pipeline_launches": 0,
             "ms": call_ms(lambda: gardner.gardner_walk(
                 ext_dev, WALK_TIMED, s0_dev, bank_dev, **wk), WALK_REPS)}
        # ext in, symbols and valid bytes out, the bank in
        res[label] = _walk_timing(
            t, WALK_TIMED, nsyms, (WALK_TIMED + 7) * 8 + cap * 9
            + 128 * 8 * 4, mhz, chain, label)
    return res


def _walk_timing(t: dict, n: int, steps: int, nbytes: int, mhz: float,
                 chain: dict, label: str):
    """Cycles a sample and a step (a sample, or an M&M symbol) at the
    maximum SM clock; the contract's bound (the bytes in and out at the
    memory rate; the operations take less); and the latency bound: the
    loop-carried chain's cycles a step, read off the SASS, times the steps
    at the maximum SM clock. Raises if the kernel beat that bound."""
    cyc = mhz * 1e3                                  # cycles a millisecond
    t["cycles_per_sample"] = t["ms"] * cyc / n
    t["cycles_per_step"] = t["ms"] * cyc / steps
    t["chain_cycles_per_step"] = chain["cycles_a_step"]
    t["latency_bound_ms"] = chain["cycles_a_step"] * steps / cyc
    t["bound_ms"], t["bound_by"] = nbytes / H100_BYTES_PER_S * 1e3, "bytes"
    log(f"walker {label} at {n} samples ({steps} steps): kernel "
        f"{t['ms']:.4f} ms (events), {t['cycles_per_sample']:.1f} cycles "
        f"a sample, {t['cycles_per_step']:.1f} a step at {mhz:.0f} MHz, "
        f"{n / t['ms'] / 1e3:.2f} Msamp/s; latency bound (the SASS chain) "
        f"{t['latency_bound_ms']:.4f} ms, {t['chain_cycles_per_step']:.1f} "
        f"cycles a step; the stall counts {chain['stall_cycles_a_step']:.1f} "
        f"a step; plain {t['plain_ms']:.1f} ms; bound "
        f"{t['bound_ms']:.5f} ms (bytes)")
    if t["latency_bound_ms"] > t["ms"]:
        raise AssertionError(f"walker {label} ran faster than its SASS "
                             f"chain allows: the chain is no bound")
    return t


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
    """The main path, baseband to products; returns the kernels' launches,
    the input file and the CADUs sent."""
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
    # K3: the decoder's lock search
    path_kernels = (viterbi_re, resample_arith_grid) + _vb_kernels()
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
    return launches, path, cadus


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
    h2d = [e for e in dev if "HtoD" in e.name]
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
    return {"busy_ms": busy, "idle_share": idle, "launches": launches,
            "copies": copies, "h2d": len(h2d),
            "h2d_ms": sum(e.time_range.elapsed_us() for e in h2d) / 1e3}


# the resampled pipelines at their default rates (phase 10). METEOR-M2-x
# at 1 Msps: one default psk_demod block (125 * 2^18 samples) of MSU-MR
# imagery, 36 strips (~284 CADUs, ~32 s of downlink); METEOR-M2 at 1 Msps:
# 2 strips; GOES-R HRIT at 6 Msps: 79 CADUs (~2^23 samples); NOAA APT at
# 1 Msps: 40 lines (20 s)
M2X_STRIPS, M2_STRIPS, GOES_CADUS, OPTION_CADUS, APT_LINES = 36, 2, 79, 8, 40
# user parameters of every pass of phases 10 and 11 (a rehearsal on the
# CPU passes a small buffer_size)
PASS_PARAMS: dict = {}


def _path_kernels():
    from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    return (viterbi_re, resample_arith_grid)


def _classic_kernels():
    """The classic chain's walkers: the AGC, the PLL, the Costas loop and
    M&M."""
    from satdump_tpu_torch.ops.cuda.mm_clock import mm_walk
    from satdump_tpu_torch.ops.cuda.sample_walk import (agc_walk, costas_walk,
                                                        pll_walk)
    return (agc_walk, pll_walk, costas_walk, mm_walk)


def _run_counted(fn, label: str, need_kernels: bool = True, kernels=None):
    """fn() on the card with the count of each of `kernels` (default: the
    resampled paths' K1 and K2) set to 0 just before and read just after;
    returns (result, wall s, launches)."""
    import torch
    kernels = kernels or _path_kernels()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    if need_kernels and not all(launches.values()):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    return out, wall, launches


def _cadu_card_cpu(label, fname, pipe_id, cadus, bb, work: Path,
                   params: dict, kernels=None):
    """bb baseband -> CADU through `pipe_id` on the card (timed, the
    launches of `kernels` counted, default K1 and K2) and on the CPU: both
    .cadu files must hold the CADUs sent and be byte-identical. Returns the
    card's .cadu path and wall."""
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    work.mkdir(parents=True, exist_ok=True)
    src = work / "pass.cf32"
    write_baseband(src, "cf32", bb)
    params = dict(PASS_PARAMS, **params)

    def run(dev):
        return run_pipeline(_pipeline(fname, pipe_id), str(src),
                            str(work / dev),
                            user_params=dict(params, torch_device=dev))
    out, wall, launches = _run_counted(lambda: run("cuda"), label,
                                       kernels=kernels)
    t0 = time.perf_counter()
    cpu_out = run("cpu")
    cpu_wall = time.perf_counter() - t0
    got = {d: _check_cadus(o, cadus, f"{label} ({d}, {len(bb)} samples)")
           for d, o in (("cuda", out), ("cpu", cpu_out))}
    if not np.array_equal(got["cuda"], got["cpu"]):
        raise AssertionError(f"{label}: .cadu differs between cuda and cpu")
    log(f"{label}: baseband->CADU on the card {wall:.3f} s "
        f"({len(bb) / wall / 1e6:.3f} Msamp/s), on the CPU {cpu_wall:.3f} s;"
        f" .cadu byte-identical cuda vs cpu; launches {launches}")
    return out, wall


def _products_card_cpu(label, fname, pipe_id, cadu: str, work: Path,
                       products: dict, params: dict):
    """The card's .cadu -> products on the card (into work/cuda, beside
    it) and on the CPU (into work/cpu-products): every product image and
    every autogen composite of `products` ({dir: instrument}) must be
    identical. Returns the two product directories' parent paths."""
    import torch
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    from satdump_tpu_torch.products.product import load_product
    outs, walls = {}, {}
    for dev, d in (("cuda", work / "cuda"), ("cpu", work / "cpu-products")):
        t0 = time.perf_counter()
        run_pipeline(_pipeline(fname, pipe_id, "cadu", "products"), cadu,
                     str(d), user_params=dict(params, torch_device=dev),
                     start_level="cadu")
        torch.cuda.synchronize()
        walls[dev], outs[dev] = time.perf_counter() - t0, d
    same = True
    for prod in products:
        p = {dev: load_product(str(d / prod)) for dev, d in outs.items()}
        for img in p["cuda"].images:
            same &= _same_images(img.image,
                                 p["cpu"].get_channel(img.channel_name).image)
    comps = autogen_composites(products)
    same_c = {c: _same_images(load_img(outs["cuda"] / c),
                              load_img(outs["cpu"] / c)) for c in comps}
    log(f"{label}: CADU->products on the card {walls['cuda']:.3f} s, on the "
        f"CPU {walls['cpu']:.3f} s; product images identical: {same}; "
        f"composites identical: {same_c}")
    if not same or not all(same_c.values()):
        raise AssertionError(f"{label}: products differ between cuda and "
                             "cpu")
    return outs, walls["cuda"]


def _check_msumr(product_dir: Path, truth: dict, label: str) -> None:
    """MSU-MR channels within 8 LSB (mean) of the image sent (JPEG at QF
    80), as phase 5 checks them."""
    from satdump_tpu_torch.products.product import load_product
    prod = load_product(str(product_dir))
    for ch in sorted(truth):
        img = prod.get_channel(str(ch)).image
        err = float(np.abs((img >> 8).astype(int) - truth[ch]).mean())
        log(f"{label}: MSU-MR channel {ch} {img.shape}, mean |error| "
            f"against the image sent {err:.3f} LSB")
        if img.shape != truth[ch].shape or err > 8.0:
            raise AssertionError(f"{label}: MSU-MR channel {ch} differs "
                                 f"from the image sent ({err})")


def _option_pass(rng, work: Path):
    """METEOR-M2 LRPT at 1 Msps with a DC term, a carrier offset of -3 kHz
    and a Doppler ramp of 2-6 kHz: psk_demod with dc_block, freq_shift
    3000 and a Doppler provider, then meteor_lrpt_decoder, on the card and
    on the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.pipeline.module import (module_registry,
                                                   register_all_modules)
    cadus = sim.make_cadus(OPTION_CADUS, rng)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS,
                                freq_offset=-3e-3, dc=0.05 + 0.03j)
    dop = np.linspace(2e3, 6e3, len(bb))
    bb = (bb * np.exp(2j * np.pi * np.cumsum(dop) / 1e6)).astype(np.complex64)
    dop = dop.astype(np.float32)
    work.mkdir(parents=True, exist_ok=True)
    src = work / "pass.cf32"
    write_baseband(src, "cf32", bb)

    def provider(pos, n):
        d = dop[pos: pos + n]
        return np.concatenate([d, np.full(n - len(d), dop[-1], np.float32)])

    register_all_modules()
    pipe = _pipeline("Meteor-M.json", "meteor_m2_lrpt")
    demod_p = pipe.prepare_parameters(pipe.steps[1], dict(
        PASS_PARAMS, freq_shift=3000.0, dc_block=True))
    dec_p = pipe.prepare_parameters(pipe.steps[2], PASS_PARAMS)

    def run(dev):
        demod = module_registry.get("psk_demod")(
            str(src), str(work / dev / "m"), dict(demod_p, torch_device=dev))
        demod.doppler_provider = provider
        (work / dev).mkdir(parents=True, exist_ok=True)
        demod.process()
        dec = module_registry.get("meteor_lrpt_decoder")(
            demod.d_output_file, str(work / dev / "m"),
            dict(dec_p, torch_device=dev))
        dec.process()
        return dec.d_output_file
    out, wall, launches = _run_counted(lambda: run("cuda"),
                                       "freq_shift + dc_block + Doppler")
    got = {d: _check_cadus(o, cadus, f"freq_shift + dc_block + Doppler "
                                     f"({d}, {len(bb)} samples)")
           for d, o in (("cuda", out), ("cpu", run("cpu")))}
    if not np.array_equal(got["cuda"], got["cpu"]):
        raise AssertionError("option pass: .cadu differs between devices")
    log(f"freq_shift + dc_block + Doppler (METEOR-M2 1 Msps): card "
        f"{wall:.3f} s; .cadu byte-identical cuda vs cpu; launches "
        f"{launches}")
    return wall


def _apt_pass(rng, work: Path):
    """NOAA APT at 1 Msps, APT_LINES lines, baseband -> products on the card
    and on the CPU: the synced image, the product channels and the
    raw_sync composite identical; the image holds sync A at every line
    start and follows the lines sent (tests/test_torch_sim.py's test)."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.models.noaa_apt import SYNC_A
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    audio, lines = sim.apt_audio(APT_LINES, 50e3, rng)
    bb = sim.fm_modulate(audio, 50e3, 1e6, 12.5e3, rng=rng)
    work.mkdir(parents=True, exist_ok=True)
    src = work / "pass.cf32"
    write_baseband(src, "cf32", bb)

    def run(dev):
        return run_pipeline(_pipeline("NOAA.json", "noaa_apt",
                                      stop="products"),
                            str(src), str(work / dev),
                            user_params=dict(PASS_PARAMS,
                                             torch_device=dev))
    _, wall, launches = _run_counted(lambda: run("cuda"), "noaa_apt",
                                     need_kernels=False)
    t0 = time.perf_counter()
    run("cpu")
    cpu_wall = time.perf_counter() - t0
    imgs = {d: load_img(work / d / "AVHRR" / "raw_sync.png")
            for d in ("cuda", "cpu")}
    same = _same_images(*imgs.values())
    for f in ("raw_unsync.png", "avhrr_apt-APT.png", "avhrr_apt-A.png",
              "avhrr_apt-B.png", "avhrr_apt_raw_sync.png"):
        same &= _same_images(load_img(work / "cuda" / "AVHRR" / f),
                             load_img(work / "cpu" / "AVHRR" / f))
    img = imgs["cuda"].astype(float)
    body = img[1:-1]
    pat = SYNC_A - SYNC_A.mean()
    sync = (body[:, :len(SYNC_A)] @ pat).min()
    data = np.abs(body[:, 500:500 + len(SYNC_A)] @ pat).max()
    corr = min(np.corrcoef(g[100:1900], t[100:1900])[0, 1]
               for g, t in zip(body, lines[1:-1]))
    log(f"noaa_apt ({len(bb)} samples, {APT_LINES} lines): baseband->products"
        f" on the card {wall:.3f} s, on the CPU {cpu_wall:.3f} s; image "
        f"{img.shape}, identical on cuda and cpu (and its products and "
        f"composite): {same}; sync A score min {sync:.0f} against data max "
        f"{data:.0f}; least line correlation with the lines sent "
        f"{corr:.3f}; launches {launches}")
    if not same or img.shape != (APT_LINES, 2080) or sync <= 2 * data \
            or corr <= 0.5:
        raise AssertionError("noaa_apt: image differs between devices or "
                             "from the lines sent")
    return wall


def _stage_device_ms(rng):
    """Device time of the input resampler and of dc_block at the resampled
    pipelines' default blocks."""
    import torch
    from satdump_tpu_torch.ops import firdes, resamp, stages
    for label, block, (interp, decim) in (
            ("METEOR-M2-x 1 Msps", 125 << 18, (21, 125)),
            ("METEOR-M2 1 Msps", 25 << 18, (7, 25)),
            ("GOES HRIT 6 Msps", 5 << 18, (3, 5))):
        x = torch.from_numpy((rng.standard_normal(block) + 1j
                              * rng.standard_normal(block)
                              ).astype(np.complex64)).cuda()
        bank = torch.as_tensor(firdes.polyphase_bank(
            resamp.design_resampler_taps(interp, decim), interp)).cuda()
        rs = resamp.rational_resampler_init(interp, device="cuda")
        out_n = block * interp // decim
        r_ms = device_ms(lambda: resamp.rational_resampler(
            rs, x, bank, interp, decim, out_cap=out_n), 5)
        dc = stages.dc_block_init(device="cuda")
        d_ms = device_ms(lambda: stages.dc_block(dc, x), 5)
        log(f"stages at {label}'s block ({block} samples in, {out_n} out): "
            f"rational_resampler {r_ms:.3f} ms, dc_block {d_ms:.3f} ms of "
            f"device time a block (profiler)")


def phase_resampled(rng, work: Path) -> dict:
    """The resampled pipelines at their default rates on the card against
    the CPU, each pass with the kernels' counts set to 0 just before and
    read just after (phase 10); then psk_demod's step profile on the
    METEOR-M2-x and GOES HRIT inputs, and the stages' device times.
    Returns the walls."""
    from satdump_tpu_torch import sim
    t_phase = time.perf_counter()
    walls = {}
    # METEOR-M2-x LRPT at 1 Msps (OQPSK, NRZ-M), baseband -> products
    t0 = time.perf_counter()
    cadus, truth = sim.msumr_lrpt_cadus(rng, M2X_STRIPS)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS, "oqpsk",
                                nrzm=True)
    log(f"meteor_m2x_lrpt 1 Msps: {M2X_STRIPS} strips, {len(cadus)} CADUs, "
        f"{len(bb)} samples ({len(bb) / 1e6:.1f} s), made in "
        f"{time.perf_counter() - t0:.1f} s")
    m2x = ("Meteor-M.json", "meteor_m2x_lrpt")
    cadu, walls["m2x_cadu"] = _cadu_card_cpu(
        "meteor_m2x_lrpt 1 Msps", *m2x, cadus, bb, work / "m2x", {})
    m2x_src = work / "m2x" / "pass.cf32"
    outs, walls["m2x_products"] = _products_card_cpu(
        "meteor_m2x_lrpt 1 Msps", *m2x, cadu, work / "m2x",
        {"MSU-MR": "msu_mr"}, PASS_PARAMS)
    _check_msumr(outs["cuda"] / "MSU-MR", truth, "meteor_m2x_lrpt 1 Msps")
    # METEOR-M2 LRPT at 1 Msps (QPSK), a small pass to products
    cadus, truth = sim.msumr_lrpt_cadus(rng, M2_STRIPS)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.METEOR_1M_SPS)
    m2 = ("Meteor-M.json", "meteor_m2_lrpt")
    params = {"m2x_mode": True}
    cadu, walls["m2_cadu"] = _cadu_card_cpu(
        "meteor_m2_lrpt 1 Msps", *m2, cadus, bb, work / "m2", params)
    outs, walls["m2_products"] = _products_card_cpu(
        "meteor_m2_lrpt 1 Msps", *m2, cadu, work / "m2",
        {"MSU-MR": "msu_mr"}, dict(PASS_PARAMS, **params))
    _check_msumr(outs["cuda"] / "MSU-MR", truth, "meteor_m2_lrpt 1 Msps")
    # GOES-R HRIT at 6 Msps (BPSK, NRZ-M), baseband -> CADU
    cadus = sim.make_cadus(GOES_CADUS, rng)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.GOES_HRIT_SPS, "bpsk",
                                nrzm=True)
    _, walls["goes_cadu"] = _cadu_card_cpu(
        "goes_hrit 6 Msps", "GOES.json", "goes_hrit", cadus, bb,
        work / "goes", {})
    goes_src = work / "goes" / "pass.cf32"
    log(f"goes_hrit 6 Msps: {len(bb)} samples baseband->CADU in "
        f"{walls['goes_cadu']:.3f} s = {len(bb) / walls['goes_cadu'] / 1e6:.3f}"
        f" Msamp/s on the card (live limit 6 Msamp/s)")
    walls["options_cadu"] = _option_pass(rng, work / "options")
    walls["apt_products"] = _apt_pass(rng, work / "apt")
    for label, fname, pipe_id, src in (
            ("meteor_m2x_lrpt", *m2x, m2x_src),
            ("goes_hrit", "GOES.json", "goes_hrit", goes_src)):
        _profile_psk(label, fname, pipe_id, src, work / "profile" / label)
    _stage_device_ms(rng)
    log(f"resampled passes: phase {time.perf_counter() - t_phase:.1f} s")
    return walls


def _profile_psk(label, fname, pipe_id, src: Path, work: Path):
    """psk_demod alone on `src`, once timed and once under torch.profiler:
    device busy/idle, and per block the launches, copies and H2D time."""
    import torch
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    pipe = _pipeline(fname, pipe_id, "baseband", "soft")

    def once(tag):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_pipeline(pipe, str(src), str(work / tag),
                     user_params=dict(PASS_PARAMS))
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    wall = once("timed")
    with profiled() as prof:
        pwall = once("profiled")
    r = report_profile(f"profile psk_demod {label}", prof, wall, pwall)
    step = pipe.steps[-1]
    from satdump_tpu_torch.pipeline.module import module_registry
    m = module_registry.get(step.module_id)(str(src), str(work / "m"), dict(
        pipe.prepare_parameters(step, PASS_PARAMS), torch_device="cuda"))
    m.compute_rates()
    block = m.choose_block_size(m.block_base)
    nblk = -(-(src.stat().st_size // 8) // block)
    log(f"profile psk_demod {label}: {nblk} blocks of {block} samples; a "
        f"block: {r['launches'] / nblk:.0f} launches, {r['copies'] / nblk:.1f}"
        f" cudaMemcpy* calls, {r['h2d'] / nblk:.1f} H2D copies of "
        f"{r['h2d_ms'] / nblk:.3f} ms device time")


# the classic demod chain's passes (phase 11): INTEGRAL at 2.096 Msps (sps
# 8, no resampler), 15 r=1/2 CADUs, ~2^21 samples; NOAA HRPT's pm_demod at
# 3 Msps and Crew Dragon's fsk_demod at 6 Msps, ~2^23 samples each to
# .soft; short ELEKTRO-L GGAK, SpaceTeamSat1 and Saral passes on the card
# and on the CPU
INTEGRAL_CADUS, CLASSIC_SAMPLES = 15, 1 << 23
ELEKTRO_CADUS, STS1_CADUS, SARAL_CADUS = 6, 6, 8


def _ber(soft: np.ndarray, bits: np.ndarray) -> tuple:
    """(BER, lag) of hard decisions against the bits sent (polarity free:
    the loops lock either way), over the soft stream's middle half, at the
    best lag within 64 symbols."""
    s = soft > 0
    a, b = len(s) // 4, 3 * len(s) // 4
    best = (1.0, 0)
    for lag in range(-64, 65):
        if a - lag < 0 or b - lag > len(bits):
            continue
        e = float(np.mean(s[a:b] != bits[a - lag: b - lag]))
        best = min(best, (min(e, 1 - e), lag))
    return best


def _soft_pass(label, fname, pipe_id, bb, bits, samplerate, live_msps,
               work: Path, kernels, ber_limit: float):
    """bb -> .soft through the pipeline's demod alone on the card (timed,
    the launches of `kernels` counted): the softs must follow `bits`, the
    channel bits from the start of bb (BER below ber_limit); logs the wall
    against the live rate."""
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    work.mkdir(parents=True, exist_ok=True)
    src = work / "pass.cf32"
    write_baseband(src, "cf32", bb)
    pipe = _pipeline(fname, pipe_id, "baseband", "soft")
    out, wall, launches = _run_counted(lambda: run_pipeline(
        pipe, str(src), str(work / "cuda"), user_params=dict(
            PASS_PARAMS, samplerate=samplerate)), label, kernels=kernels)
    soft = np.fromfile(out, np.int8)
    ber, lag = _ber(soft, bits)
    rate = len(bb) / wall / 1e6
    log(f"{label}: {len(bb)} samples -> {len(soft)} softs in {wall:.3f} s "
        f"on the card = {rate:.3f} Msamp/s (live rate {live_msps} Msamp/s: "
        f"{'met' if rate >= live_msps else 'not met'}); BER against the "
        f"bits sent {ber:.2e} at lag {lag}; launches {launches}")
    if ber > ber_limit:
        raise AssertionError(f"{label}: BER {ber} above {ber_limit}")
    return wall


def phase_classic(rng, work: Path) -> tuple:
    """The classic chain on the card (phase 11); returns the launches of
    its main path (INTEGRAL, pm_demod -> ccsds_conv_concat_decoder) and
    the walls."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.ops.cuda.mm_clock import mm_walk
    from satdump_tpu_torch.ops.cuda.sample_walk import agc_walk
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    t_phase = time.perf_counter()
    walls = {}
    # INTEGRAL S-band at 2.096 Msps: pm_demod -> ccsds_conv_concat_decoder
    # (bpsk_90: the second symbol of each pair sent inverted, as CCSDS
    # sends it; RS(255,239) x 4)
    cadus = sim.make_cadus(INTEGRAL_CADUS, rng, rs=ReedSolomon(k=239))
    bits = sim.encode_cadu_stream(cadus)
    bits[1::2] ^= 1
    bb = sim.pm_bpsk_baseband(bits, 8, rng)
    w = work / "integral"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    kernels = (viterbi_re,) + _classic_kernels()
    out, wall, launches = _run_counted(lambda: run_pipeline(
        _pipeline("Integral.json", "integral_s_link"), str(w / "pass.cf32"),
        str(w / "cuda"), user_params=dict(PASS_PARAMS, samplerate=2.096e6)),
        "integral_s_link", kernels=kernels)
    _check_cadus(out, cadus, f"integral_s_link 2.096 Msps ({len(bb)} samples)")
    walls["integral_cadu"] = wall
    log(f"integral_s_link 2.096 Msps: baseband->CADU on the card {wall:.3f} s"
        f" = {len(bb) / wall / 1e6:.3f} Msamp/s (live rate 2.096); launches "
        f"{launches}")
    # NOAA HRPT's pm_demod at 3 Msps (665.4 ksym/s, sps 4.51) and Crew
    # Dragon's fsk_demod at 6 Msps (2.35 Msym/s, sps 2.55), to .soft
    lead = 1024
    nbits = int(CLASSIC_SAMPLES / (3e6 / 665.4e3)) - lead - 2048
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    bb = sim.pm_bpsk_baseband(bits, 3e6 / 665.4e3, rng, lead_bits=lead)
    walls["noaa_hrpt_soft"] = _soft_pass(
        "noaa_hrpt pm_demod 3 Msps", "NOAA.json", "noaa_hrpt", bb,
        np.concatenate([np.zeros(lead, np.uint8), bits]), 3e6, 3.0,
        work / "hrpt", _classic_kernels(), 1e-3)
    lead = 512
    nbits = int(CLASSIC_SAMPLES / (6e6 / 2.35e6)) - lead - 512
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    bb = sim.fsk_baseband(bits, 6e6, 2.35e6, rng, 2.35e6 / 4,
                          lead_bits=lead)
    walls["crew_dragon_soft"] = _soft_pass(
        "crew_dragon_tlm fsk_demod 6 Msps", "SpaceX.json", "crew_dragon_tlm",
        bb, np.concatenate([np.zeros(lead, np.uint8), bits]), 6e6, 6.0,
        work / "dragon", (agc_walk, mm_walk), 1e-2)
    # card against CPU: ELEKTRO-L GGAK (pm_demod -> simple PSK, 5 ksym/s at
    # 40 ksps), SpaceTeamSat1 9k6 (fsk_demod resampled from 140 ksps ->
    # simple PSK, rs_i 1) and Saral (psk_demod -> conv-concat, rs_i 5)
    asm = np.tile(np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8),
                  (ELEKTRO_CADUS, 1))
    cadus = np.concatenate([asm, rng.integers(0, 256, (ELEKTRO_CADUS, 220)
                                              ).astype(np.uint8)], 1)
    bb = sim.pm_bpsk_baseband(sim.encode_cadu_stream_uncoded(
        cadus, randomize=False), 8, rng, tail_bits=1024)
    _, walls["elektro_cadu"] = _cadu_card_cpu(
        "elektro_ggak 40 ksps", "Elektro_Arktika.json", "elektro_ggak",
        cadus, bb, work / "elektro", {"samplerate": 40e3},
        kernels=_classic_kernels())
    cadus = sim.make_cadus(STS1_CADUS, rng, cadu_bytes=259, rs_i=1)
    bb = sim.fsk_baseband(sim.encode_cadu_stream_uncoded(cadus), 140e3,
                          9600, rng, 2400.0)
    _, walls["sts1_cadu"] = _cadu_card_cpu(
        "sts1_9k6 140 ksps", "spaceteamsat1.json", "sts1_9k6", cadus, bb,
        work / "sts1", {}, kernels=(agc_walk, mm_walk))
    cadus = sim.make_cadus(SARAL_CADUS, rng, cadu_bytes=1279, rs_i=5)
    bb = sim.ccsds_psk_baseband(cadus, rng, (5, 2))
    _, walls["saral_cadu"] = _cadu_card_cpu(
        "saral_dump rs_i 5, 40 Msps", "Saral.json", "saral_dump", cadus, bb,
        work / "saral", {"samplerate": 40e6})
    log(f"classic passes: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, walls


# phase 12: the deep-space FEC (turbo and LDPC). turbo_bcjr is held to its
# plain version on the card at base 223 at each rate (both constituent
# codes) and at base 1115, rate 1/2, JUICE's 58-frame batch (timed there)
BCJR_CASES = tuple((223, r, 4) for r in ("1/2", "1/3", "1/4", "1/6")) + \
    ((1115, "1/2", 58),)
BCJR_REPS = 5
# JUICE X-band (pm_demod at 526,316 sym/s recorded at sps 4, turbo 1/2 base
# 1115, 5 iterations): 32 frames, ~2.3 M samples; TGO from .soft (50
# iterations): one 2^20-soft block of 58 frames; GOES-R raw sounder data
# (psk_demod BPSK at 928 ksym/s at 2 Msps, C2 LDPC, 8192-bit CADUs in the
# internal stream): 55 CADUs in 64 LDPC frames; Orion from .soft (OQPSK,
# AR4JA 1/2, k 1024): 64 frames
JUICE_FRAMES, TGO_FRAMES, SOUNDER_CADUS, ORION_FRAMES = 32, 58, 55, 64
JUICE_RATE, TGO_SYMRATE, GOES_SPS = 2_105_264, 52_765, (125, 58)
# the decoders' correlation thresholds on demodulated softs: both modules
# (as in the JAX package) normalize the correlation to softs at full scale
# (127), and hold it to 0.5 by default; pm_demod's softs sit near +-19 at
# a modulation index of 1 rad (0.15 of full scale) and psk_demod's near
# +-55 (0.43), so at the defaults neither locks behind its demod
# (ROADMAP.md, queue item 18). The baseband passes set the threshold
# below their demod's scale and above the best match that noise of that
# scale reaches over a block.
JUICE_CORR_THRESHOLD, GOES_CORR_THRESHOLD = 0.1, 0.3


def _bcjr_sass() -> dict:
    """turbo_bcjr's SASS: no FFMA that rounds and no float64 instruction in
    any of its functions (every add, max and scaling by 0.5 is its own
    correctly rounded instruction: __fadd_rn / __fmul_rn, which nvcc never
    contracts); then the loop-carried chain of each step loop (the forward
    and the backward recursion) of the rate-1/2 upper code's walk
    (tools/sass_chain.py; a step is its 16 state-metric stores)."""
    from satdump_tpu_torch.tools import sass_chain as sc
    funcs = sc.parse_sass(_sass("turbo_bcjr"))
    for f in funcs:
        rounding, _ = sc.rounding_ffma(f)
        fp64 = sc.fp64_instructions(f)
        ffma = sum(x.mnemonic == "FFMA" for x in f.ins)
        log(f"turbo_bcjr SASS {f.name[-48:]}: {len(f.ins)} instructions, "
            f"FFMA {ffma}, float64 {len(fp64)}")
        if rounding or fp64:
            raise AssertionError(f"{f.name}: FFMA that rounds "
                                 f"{[x.text for x in rounding[:4]]} or "
                                 f"float64 {[x.text for x in fp64[:4]]}")
    walk = next(f for f in funcs if "bcjr_walk_kernelILi2ELi4E" in f.name)
    measured, _ = sc.measured_latencies()
    lat = sc.Latency(sc.fixed_latencies(funcs), measured)
    # the forward and the backward step loops (more if nvcc versions one)
    loops = sc.step_loops(walk, "STG.E")
    if len(loops) < 2:
        raise AssertionError(f"turbo_bcjr walk: {len(loops)} step loops")
    out = {}
    for name, loop in zip(map(str, range(len(loops))), loops):
        r = sc.chain(walk, lat, loop=loop, step_store="STG.E",
                     stores_a_step=16)
        log(f"turbo_bcjr SASS chain, loop {name} at {hex(walk.ins[loop[0]].addr)}"
            f": {r['cycles_a_step']:.2f} cycles a"
            f" step ({r['instructions_a_pass']} instructions a pass of "
            f"{r['steps_a_pass']:g} steps); the schedule's stall counts "
            f"{r['stall_cycles_a_step']:.1f} a step; chain opcodes "
            f"{json.dumps(r['chain_opcodes'])}; at the smallest latency "
            f"{json.dumps(r['unmeasured'])}")
        out[name] = r
    return out


def _bcjr_bound(B: int, S: int, C: int):
    """The least time of one call: its bytes (Lch and La in, the APP out)
    and its operations, each counted once a step and frame: the branch
    metrics as the function needs them (the 2^C signed sums of the C
    components, C - 1 adds and a scaling each; 0.5 La; one add for each of
    the 2^(C+1) distinct values of g), the forward step (32 adds, 32 maxes
    with the floor, 15 for the max, 16 subtractions), the backward step
    (32, 16, 15, 16) and the APP (64 adds, 32 maxes, a subtraction)."""
    K = S - 4
    nbytes = (B * S * C + 2 * B * K) * 4
    branch = (1 << C) * C + 1 + (1 << (C + 1))
    ops = B * S * (branch + 95 + 79) + B * K * 97
    return bound_ms(nbytes, ops, H100_F32_OPS)


def phase_bcjr(rng) -> dict:
    """12.1: turbo_bcjr against its plain version on the card (the same
    torch ops as on the CPU), tolerance 0, at every case of BCJR_CASES and
    both constituent codes; the last case timed (device time a call from
    CUDA events around BCJR_REPS calls back to back, since on an H100 the
    profiler's session held no device record of these calls after phase
    11; a wrapper call from events around single calls; the plain
    version's on the card) beside its bounds: bytes / operations, and the
    latency bound, the SASS chain a step times S at the maximum SM
    clock."""
    import torch
    from satdump_tpu_torch.ops.cuda.turbo_bcjr import (turbo_bcjr,
                                                       turbo_bcjr_plain)
    from satdump_tpu_torch.ops.fec.turbo import _RATES
    from satdump_tpu_torch.ops.fec.turbo_trellis import MEMORY
    chains = _bcjr_sass()
    mhz = sm_clock_mhz()
    err, res = 0.0, {}
    for base, rate, B in BCJR_CASES:
        for comps in map(tuple, _RATES[rate]):
            K = 8 * base
            S, C = K + MEMORY, len(comps)
            L = torch.from_numpy(rng.normal(0, 3, (B, S, C)).astype(
                np.float32)).cuda()
            La = torch.from_numpy(rng.normal(0, 4, (B, K)).astype(
                np.float32)).cuda()
            got = turbo_bcjr(L, La, comps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = turbo_bcjr_plain(L, La, comps)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            e = float((got - ref).abs().max())
            same = torch.equal(got, ref)
            log(f"turbo_bcjr base {base} rate {rate} {comps} B {B}: max |err|"
                f" {e:.3e} against plain (tolerance 0), bit-identical "
                f"{same}")
            if not same:
                raise AssertionError(f"turbo_bcjr differs from its plain "
                                     f"version at {base} {rate} {comps}")
            err = max(err, e)
            if base == 1115 and comps == ("sys", "p1"):
                call = lambda: turbo_bcjr(L, La, comps)  # noqa: E731
                res = {"ms": call_ms(call, BCJR_REPS, back_to_back=True),
                       "call_ms": call_ms(call, BCJR_REPS),
                       "plain_ms": plain_ms}
                res["bound_ms"], res["bound_by"] = _bcjr_bound(B, S, C)
                cyc = max(c["cycles_a_step"] for c in chains.values())
                res["latency_bound_ms"] = cyc * S / (mhz * 1e3)
                res["chain_cycles_per_step"] = cyc
                res["cycles_per_step"] = res["ms"] * mhz * 1e3 / S
                log(f"turbo_bcjr at base 1115, {B} frames ({S} steps): "
                    f"device {res['ms']:.4f} ms a call (events over "
                    f"{BCJR_REPS} calls: both kernels), "
                    f"{res['call_ms']:.4f} ms a wrapper call "
                    f"(events), {res['cycles_per_step']:.1f} cycles a step "
                    f"at {mhz:.0f} MHz; latency bound (the SASS chain, the "
                    f"longer recursion) {res['latency_bound_ms']:.4f} ms, "
                    f"{cyc:.1f} cycles a step; bound {res['bound_ms']:.5f} "
                    f"ms ({res['bound_by']}); plain on the card "
                    f"{plain_ms:.1f} ms")
    res["max_abs_err"] = err
    return res


def _frm_check(out: str, frames: np.ndarray, label: str) -> None:
    """The .frm holds every frame sent, in order, bit-exact behind the
    ASM, each with a valid CRC-16."""
    from satdump_tpu_torch.ops.fec.crc import crc_ccitt
    got = np.fromfile(out, np.uint8).reshape(-1, 4 + frames.shape[1])
    ok = sum(crc_ccitt.compute(g[4:-2]) == (int(g[-2]) << 8 | int(g[-1]))
             for g in got)
    log(f"{label}: {len(got)} frames decoded of {len(frames)} sent, "
        f"{ok} with a valid CRC")
    if len(got) != len(frames) or not np.array_equal(got[:, 4:], frames) \
            or ok != len(frames):
        raise AssertionError(f"{label}: frames differ from those sent")


def _minsum_profile(rng, frames: int = 32):
    """The C2 min-sum (10 iterations) on `frames` noisy frames on the card:
    its time a call (CUDA events over three calls back to back), and its
    device time and kernel launches a call from torch.profiler (None
    where the profiler records no device work)."""
    import torch
    from torch.autograd import DeviceType
    from satdump_tpu_torch.ops.fec.ldpc_ccsds import CCSDSLDPC
    dec = CCSDSLDPC("7/8", iters=10).dec
    y = 1.0 + 0.5 * rng.standard_normal((frames, dec.code.n))
    llr = torch.from_numpy((4.0 * y).astype(np.float32)).cuda()
    dec.decode_tensor(llr)
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(3):
            dec.decode_tensor(llr)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 3 / 1e3 \
        if ev else None
    return (call_ms(lambda: dec.decode_tensor(llr), 3,
                    back_to_back=True), busy,
            len(ev) / 3 if ev else None)


def _first_use_split(work: str) -> None:
    """Phase 12.6, run in a process of its own: the GOES-R raw sounder pass
    (12.4) twice, then Orion's from .soft (12.5) twice, on the card, each
    pass's wall split into its correlator calls (`correlate` and
    `earliest`) and its min-sum calls, each timed between two
    synchronizations, the first call apart; the rest is the demod and the
    host's work, where cProfile names the functions of most self time.
    Prints the split as one JSON object."""
    import cProfile
    import pstats
    import torch
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out: dict = {"cuda_init_s": time.perf_counter() - t0}
    from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric
    from satdump_tpu_torch.ops.fec.ldpc import MinSumDecoder
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    calls: dict = {}

    def timed(cls, name, key):
        f = getattr(cls, name)

        def g(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = f(*a, **k)
            torch.cuda.synchronize()
            calls.setdefault(key, []).append(time.perf_counter() - t)
            return r
        setattr(cls, name, g)
    timed(CorrelatorGeneric, "correlate", "correlator")
    timed(CorrelatorGeneric, "earliest", "correlator")
    timed(MinSumDecoder, "decode", "minsum")
    w = Path(work)
    passes = [("goes_raw_sounder_data", lambda d: run_pipeline(
        _pipeline("GOES.json", "goes_raw_sounder_data"),
        str(w / "goes" / "pass.cf32"), str(w / "split" / d),
        user_params=dict(PASS_PARAMS, samplerate=2e6,
                         corr_threshold=GOES_CORR_THRESHOLD)))] * 2 + \
        [("orion_link", lambda d: run_pipeline(
            _pipeline("Orion.json", "orion_link", "soft", "cadu"),
            str(w / "orion" / "pass.soft"), str(w / "split" / d),
            user_params=dict(PASS_PARAMS), start_level="soft"))] * 2
    for i, (name, run) in enumerate(passes):
        calls.clear()
        prof = cProfile.Profile()
        t = time.perf_counter()
        prof.runcall(run, f"{name}-{i}")
        torch.cuda.synchronize()
        r = {"wall_s": time.perf_counter() - t}
        st = pstats.Stats(prof).sort_stats("tottime")
        r["self_time_s"] = [
            [f"{Path(f).name}:{line}:{fn}", st.stats[(f, line, fn)][1],
             st.stats[(f, line, fn)][2]]
            for f, line, fn in st.fcn_list[:8]]
        for key, ts in calls.items():
            r[key] = {"calls": len(ts), "first_s": ts[0],
                      "rest_s": sum(ts[1:])}
        r["rest_s"] = r["wall_s"] - sum(sum(ts) for ts in calls.values())
        out[f"{name} {i % 2 + 1}"] = r
    print(json.dumps(out))


def phase_deep_space(rng, work: Path) -> tuple:
    """The deep-space FEC on the card (phase 12); returns turbo_bcjr's row
    (12.1, with its launches on JUICE's pass) and the walls."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.ops.cuda.resample import resample_arith_grid
    from satdump_tpu_torch.ops.cuda.turbo_bcjr import turbo_bcjr
    from satdump_tpu_torch.ops.fec.ldpc_ccsds import CCSDSLDPC
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    t_phase = time.perf_counter()
    row = phase_bcjr(rng)
    walls = {}
    # 12.2 JUICE X-band: baseband -> frames on the card
    frames = sim.crc_frames(JUICE_FRAMES, rng, 1115)
    # JUICE's narrow loops (PLL 0.002, Costas 0.001) lock in a few thousand
    # symbols: 8192 random bits go ahead of the first marker
    bb = sim.pm_bpsk_baseband(sim.turbo_stream_bits(frames, 1115, "1/2"), 4,
                              rng, lead_bits=8192)
    w = work / "juice"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    out, wall, launches = _run_counted(lambda: run_pipeline(
        _pipeline("Juice.json", "juice_x_link"), str(w / "pass.cf32"),
        str(w / "cuda"), user_params=dict(
            PASS_PARAMS, samplerate=JUICE_RATE,
            correlator_threshold=JUICE_CORR_THRESHOLD)),
        "juice_x_link", kernels=_classic_kernels() + (turbo_bcjr,))
    _frm_check(out, frames, f"juice_x_link ({len(bb)} samples)")
    row["launches"] = launches["turbo_bcjr"]
    walls["juice_frm"] = wall
    log(f"juice_x_link 2.105 Msps: baseband->frames on the card {wall:.3f} s"
        f" = {len(bb) / wall / 1e6:.3f} Msamp/s (live rate 2.105); launches "
        f"{launches}")
    # 12.3 TGO from .soft: one 2^20-soft block, 50 iterations
    frames = sim.crc_frames(TGO_FRAMES, rng, 1115)
    soft = sim.soft_stream(sim.turbo_stream_bits(frames, 1115, "1/2"), rng)
    w = work / "tgo"
    w.mkdir(parents=True, exist_ok=True)
    soft.tofile(w / "pass.soft")
    out, wall, launches = _run_counted(lambda: run_pipeline(
        _pipeline("TGO.json", "tgo_link", "soft", "cadu"), str(w /
                                                              "pass.soft"),
        str(w / "cuda"), user_params=dict(PASS_PARAMS), start_level="soft"),
        "tgo_link", kernels=(turbo_bcjr,))
    _frm_check(out, frames, f"tgo_link ({len(soft)} softs)")
    walls["tgo_frm"] = wall
    log(f"tgo_link from .soft: {len(soft)} softs ({len(soft) / TGO_SYMRATE:.2f}"
        f" s of signal at 52,765 sym/s) decoded on the card in {wall:.3f} s;"
        f" turbo_bcjr launches {launches['turbo_bcjr']} (2 x 50 + 1 a "
        f"block)")
    # 12.4 GOES-R raw sounder data: baseband -> CADU, card and CPU
    cadus = sim.make_cadus(SOUNDER_CADUS, rng)
    ld = CCSDSLDPC("7/8")
    bits = sim.ldpc_stream_bits(sim.ldpc_internal_frames(cadus, ld, rng),
                                0x1ACFFC1D, 32)
    chan = np.concatenate([rng.integers(0, 2, 4096).astype(np.uint8), bits,
                           rng.integers(0, 2, 2048).astype(np.uint8)])
    bb = sim.psk_baseband(chan, rng, GOES_SPS, "bpsk")
    out, wall = _cadu_card_cpu(
        "goes_raw_sounder_data 2 Msps", "GOES.json", "goes_raw_sounder_data",
        cadus, bb, work / "goes", {"samplerate": 2e6,
                                   "corr_threshold": GOES_CORR_THRESHOLD},
        kernels=(resample_arith_grid,))
    if len(np.fromfile(out, np.uint8)) != cadus.size:
        raise AssertionError("goes_raw_sounder_data: a CADU sent is missing")
    # the same pass again on the card: the first one pays the process's
    # first use of the min-sum's kernels and the correlator's FFT plans
    again, wall2, _ = _run_counted(lambda: run_pipeline(
        _pipeline("GOES.json", "goes_raw_sounder_data"),
        str(work / "goes" / "pass.cf32"), str(work / "goes" / "cuda-again"),
        user_params=dict(PASS_PARAMS, samplerate=2e6,
                         corr_threshold=GOES_CORR_THRESHOLD)),
        "goes_raw_sounder_data again", kernels=(resample_arith_grid,))
    if not np.array_equal(np.fromfile(again, np.uint8),
                          np.fromfile(out, np.uint8)):
        raise AssertionError("goes_raw_sounder_data: the second card pass "
                             "differs from the first")
    walls["goes_raw_sounder_cadu"] = wall
    walls["goes_raw_sounder_cadu_again"] = wall2
    log(f"goes_raw_sounder_data: {len(bb)} samples in {wall:.3f} s = "
        f"{len(bb) / wall / 1e6:.3f} Msamp/s, again {wall2:.3f} s = "
        f"{len(bb) / wall2 / 1e6:.3f} Msamp/s (live rate 2.0)")
    ms, busy, n = _minsum_profile(rng)
    log(f"C2 min-sum, 10 iterations, 32 frames: {ms:.3f} ms a call (events),"
        f" device busy {busy if busy is None else round(busy, 4)} ms and "
        f"{n} kernel launches a call (profiler; None: not measured)")
    walls["minsum_c2_32_ms"] = ms
    # 12.5 Orion from .soft: OQPSK with the Q rail a symbol late and both
    # rails negated (the correlator's swap path), card and CPU
    ld = CCSDSLDPC("1/2", 1024)
    frames = ld.encode_frames(ld.encoder(), rng.integers(
        0, 2, (ORION_FRAMES, ld.data_bits)).astype(np.uint8))
    soft = sim.oqpsk_q_late(sim.soft_stream(
        sim.ldpc_stream_bits(frames, 0x034776C7272895B0, 64), rng, mag=100,
        sigma=20.0, prefix=778))
    w = work / "orion"
    w.mkdir(parents=True, exist_ok=True)
    soft.tofile(w / "pass.soft")
    sent = np.concatenate([np.tile(np.frombuffer(
        (0x034776C7272895B0).to_bytes(8, "big"), np.uint8),
        (ORION_FRAMES, 1)), np.packbits(frames, axis=-1)], axis=1)
    got = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = run_pipeline(_pipeline("Orion.json", "orion_link", "soft",
                                     "cadu"), str(w / "pass.soft"),
                           str(w / dev), user_params=dict(
                               PASS_PARAMS, torch_device=dev),
                           start_level="soft")
        torch.cuda.synchronize()
        got[dev] = np.fromfile(out, np.uint8)
        log(f"orion_link from .soft on {dev}: {time.perf_counter() - t0:.3f}"
            f" s, {got[dev].size // sent.shape[1]} frames")
    if not (np.array_equal(got["cuda"], got["cpu"])
            and np.array_equal(got["cuda"], sent.reshape(-1))):
        raise AssertionError("orion_link: frames differ between the devices "
                             "or from those sent")
    log(f"orion_link: {ORION_FRAMES} frames identical on cuda and cpu and to"
        f" those sent")
    # 12.6 where the LDPC passes' first card pass goes, in a fresh process
    split = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r}); import chip_smoke; "
         f"chip_smoke._first_use_split({str(work)!r})"],
        capture_output=True, text=True, timeout=300)
    if split.returncode:
        raise AssertionError(f"first-use split failed: {split.stderr[-2000:]}")
    log(f"LDPC passes in a fresh process, s (first call apart): "
        f"{split.stdout.strip().splitlines()[-1]}")
    for line in (split.stdout + split.stderr).splitlines():
        if " done in " in line:
            log(f"  fresh process: {line.strip()[:160]}")
    log(f"deep-space phase {time.perf_counter() - t_phase:.1f} s")
    return row, walls


# phase 13: DVB-S2 and DVB-S. GOES-R GRB (GOES.json goes_grb: 8,665,938
# sym/s, QPSK 9/10 = MODCOD 11, normal frames, no pilots, rrc_alpha 0.25)
# at 2 sps: 67 PLFRAMEs of 2048-byte CADUs (237, 230 in the first 65)
# behind 1000 lead symbols, 4,355,660 samples (> 2^22, 0.251 s); the
# same pipeline on 9 PLFRAMEs (7 of CADUs) on the card and the CPU; the
# `dvbs2` pipeline (1 Msym/s at 2 Msps, MODCOD 4 short) on 200 TS packets;
# dvbs_demod at 3/4 (tests/test_dvbs_legacy.py's 100 ksym/s at 220 ksps)
# on 128 TS packets, card and CPU
GRB_FRAMES, GRB_SHORT_FRAMES, S2_TS_PACKETS, DVBS_TS_PACKETS = 65, 7, 200, 128
GRB_LIVE_MSPS = 2 * 8_665_938 / 1e6
DVBS_PUNCTURED = "3/4"


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


def _check_grb(out: str, cadus: np.ndarray, n: int, label: str) -> None:
    """Every CADU out one that was sent, bit for bit, and at least the `n`
    that the data frames hold less 2 at the edges."""
    got = np.fromfile(out, dtype=np.uint8).reshape(-1, 2048)
    sent = {c.tobytes() for c in cadus}
    bad = sum(g.tobytes() not in sent for g in got)
    log(f"{label}: {len(got)} CADUs decoded, {n} in the data frames, "
        f"{bad} not bit-exact")
    if bad or len(got) < n - 2:
        raise AssertionError(f"{label}: {bad} corrupt CADUs, {len(got)} of "
                             f"{n} decoded")


def _grb_block_split(bb: np.ndarray, pipe, params: dict) -> dict:
    """One 2^18-sample block of the GRB input through dvbs2_demod's layers
    on the card (blocks 0-1 first, so the PL layer holds its carry): each
    layer timed on its own (the front end by CUDA events, the demap +
    LDPC by CUDA events and the host clock, the copies and the host layers
    by the host clock between synchronizations), then the next block's
    whole work under torch.profiler for its launches, copies and idle
    share, and the timed block's demap + LDPC again for theirs."""
    import torch
    from satdump_tpu_torch.ops.dvbs2.rx import DVBS2Demod
    from satdump_tpu_torch.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule
    step = next(s for s in pipe.steps if s.module_id == "dvbs2_demod")
    mod = DVBS2DemodModule("", "", pipe.prepare_parameters(
        step, dict(params, torch_device="cuda")))
    mod._build()
    n = mod.block_size
    dem = DVBS2Demod(mod.modcod, mod.shortframes, mod.pilots,
                     ldpc_iters=mod.ldpc_iters, device="cuda")

    def block(i):
        x = mod.to_device(bb[i * n: (i + 1) * n])
        syms, valid = mod.front_end(x)
        payloads, nv = dem.pl_layer(mod.keep_valid(syms, valid, None,
                                                   False).cpu().numpy())
        if payloads is not None:
            dem.bch_layer(dem.fec_layer(payloads, nv))

    block(0)
    block(1)
    torch.cuda.synchronize()
    split = {}
    t0 = time.perf_counter()
    x = mod.to_device(bb[2 * n: 3 * n])
    torch.cuda.synchronize()
    split["h2d_samples_ms"] = (time.perf_counter() - t0) * 1e3
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    syms, valid = mod.front_end(x)
    b.record()
    b.synchronize()
    split["front_end_ms"] = a.elapsed_time(b)
    t0 = time.perf_counter()
    s = mod.keep_valid(syms, valid, None, False).cpu().numpy()
    split["d2h_symbols_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    payloads, nv = dem.pl_layer(s)
    split["pl_host_ms"] = (time.perf_counter() - t0) * 1e3
    if payloads is None:
        raise AssertionError("GRB block split: no whole PLFRAME in the block")
    split["frames"] = len(payloads)
    a.record()
    t0 = time.perf_counter()
    bits = dem.fec_layer(payloads, nv)
    b.record()
    b.synchronize()
    split["demap_ldpc_wall_ms"] = (time.perf_counter() - t0) * 1e3
    split["demap_ldpc_events_ms"] = a.elapsed_time(b)
    t0 = time.perf_counter()
    frames = dem.bch_layer(bits)
    split["bch_host_ms"] = (time.perf_counter() - t0) * 1e3
    if len(frames) != len(payloads):
        raise AssertionError(f"GRB block split: {len(frames)} of "
                             f"{len(payloads)} frames passed BCH")
    with profiled() as prof:
        t0 = time.perf_counter()
        block(3)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    r = report_profile("GRB block (dvbs2_demod, the next block)", prof,
                       pwall, pwall)
    with profiled() as prof:
        dem.fec_layer(payloads, nv)
        torch.cuda.synchronize()
    f = report_profile("GRB demap + LDPC of the timed block", prof,
                       pwall, pwall, top=4)
    split.update(block_busy_ms=r["busy_ms"], block_launches=r["launches"],
                 block_copies=r["copies"], demap_ldpc_busy_ms=f["busy_ms"],
                 demap_ldpc_launches=f["launches"],
                 payload_bytes=payloads.nbytes, symbols_bytes=s.nbytes)
    return split


def phase_dvb(rng, work: Path) -> dict:
    """DVB-S2 and DVB-S on the card (phase 13); returns the walls and
    agc_walk's launches on the GRB pass."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.core.exceptions import PipelineError
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.ops.cuda.sample_walk import agc_walk
    from satdump_tpu_torch.ops.dvbs2 import tx
    from satdump_tpu_torch.pipeline.modules.dvbs2.demod import \
        DVBS2DemodModule
    from satdump_tpu_torch.pipeline.modules.dvbs2.dvbs import DVBSDemodModule
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    t_phase = time.perf_counter()
    walls = {}
    # 13.1 GOES-R GRB at full width: baseband -> BBFrames -> CADUs
    grb_rate = 2 * sim.GRB_SYMBOLRATE
    cadus, n_cadus, bb = _grb_input(rng, GRB_FRAMES)
    w = work / "grb"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    pipe = _pipeline("GOES.json", "goes_grb")
    params = dict(PASS_PARAMS, samplerate=grb_rate)
    for tag in ("first", "again"):
        out, wall, launches = _run_counted(lambda: run_pipeline(
            pipe, str(w / "pass.cf32"), str(w / tag), user_params=params),
            f"goes_grb ({tag} pass)", kernels=(agc_walk,))
        _check_grb(out, cadus, n_cadus, f"goes_grb 17.33 Msps ({len(bb)} "
                   f"samples, {tag} pass)")
        walls[f"grb_cadu_{tag}"] = wall
        rate = len(bb) / wall / 1e6
        log(f"goes_grb 8,665,938 sym/s at 2 sps, {tag} pass in the process:"
            f" baseband->CADU on the card {wall:.3f} s = {rate:.3f} Msamp/s"
            f" (live rate {GRB_LIVE_MSPS:.3f}: "
            f"{'met' if rate >= GRB_LIVE_MSPS else 'not met'}); "
            f"{len(bb) / grb_rate:.3f} s of signal; launches {launches}")
        walls[f"grb_agc_launches_{tag}"] = launches["agc_walk"]
    split = _grb_block_split(bb, pipe, params)
    walls["grb_block_split"] = split
    log(f"GRB one 2^18-sample block's split (ms; card: front end and "
        f"demap + LDPC; host: PL layer and BCH): {json.dumps(split)}")
    # 13.2 the same pipeline on a short input, card against CPU
    cadus, n_cadus, bb = _grb_input(rng, GRB_SHORT_FRAMES)
    w = work / "grb_short"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    files = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = run_pipeline(pipe, str(w / "pass.cf32"), str(w / dev),
                           user_params=dict(params, torch_device=dev))
        torch.cuda.synchronize()
        walls[f"grb_short_{dev}"] = time.perf_counter() - t0
        _check_grb(out, cadus, n_cadus, f"goes_grb short ({dev})")
        files[dev] = [np.fromfile(w / dev / f"goes_grb.{ext}", np.uint8)
                      for ext in ("bbframe", "cadu")]
    for k, ext in enumerate(("bbframe", "cadu")):
        if not np.array_equal(files["cuda"][k], files["cpu"][k]):
            raise AssertionError(f"goes_grb short: .{ext} differs between "
                                 f"cuda and cpu")
    log(f"goes_grb short ({len(bb)} samples): .bbframe and .cadu "
        f"byte-identical cuda vs cpu; card {walls['grb_short_cuda']:.3f} s, "
        f"CPU {walls['grb_short_cpu']:.3f} s")
    # 13.3 the `dvbs2` pipeline: MODCOD 4 short -> TS packets, on the card
    ts = rng.integers(0, 256, (S2_TS_PACKETS, 188)).astype(np.uint8)
    ts[:, 0] = 0x47
    bb = sim.dvbs2_baseband(tx.ts_to_symbols(ts, 4, True, False), rng)
    w = work / "dvbs2"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    # its modcod (4), symbolrate and rrc_alpha come from the pipeline
    # file's parameters block; a module given none raises, as in the JAX
    # package
    try:
        DVBS2DemodModule("", "", {"samplerate": 2e6, "symbolrate": 1e6,
                                  "rrc_alpha": 0.25, "torch_device": "cuda"})
        raise AssertionError("dvbs2_demod without modcod did not raise")
    except PipelineError as e:
        log(f"dvbs2_demod without modcod raises, as in the JAX package: {e}")
    s2 = _pipeline("DVB-S2.json", "dvbs2", "baseband", "ts")
    out, wall, launches = _run_counted(lambda: run_pipeline(
        s2, str(w / "pass.cf32"), str(w / "cuda"), user_params=dict(
            PASS_PARAMS, samplerate=2e6, shortframes=True)), "dvbs2",
        kernels=(agc_walk,))
    got = np.fromfile(out, np.uint8).reshape(-1, 188)
    sent = {r.tobytes() for r in ts}
    bad = sum(g.tobytes() not in sent for g in got)
    if bad or len(got) < S2_TS_PACKETS * 9 // 10:
        raise AssertionError(f"dvbs2: {bad} TS packets not sent, {len(got)}"
                             f" of {S2_TS_PACKETS} out")
    walls["dvbs2_ts"] = wall
    log(f"dvbs2 1 Msym/s, MODCOD 4 short: {len(got)} of {S2_TS_PACKETS} TS "
        f"packets, every one sent, on the card in {wall:.3f} s "
        f"({len(bb) / wall / 1e6:.3f} Msamp/s); launches {launches}")
    # 13.4 dvbs_demod at a punctured rate, card against CPU
    ts = rng.integers(0, 256, (DVBS_TS_PACKETS, 188)).astype(np.uint8)
    ts[:, 0] = 0x47
    bb = sim.ChannelModel(snr_db=17.0, freq_offset=1e-4, phase=0.3,
                          seed=int(rng.integers(1 << 30))).apply(
        sim.qpsk_modulate(sim.dvbs_symbols(ts, DVBS_PUNCTURED), sps=2.2,
                          rrc_alpha=0.35))
    w = work / "dvbs"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    got, stats = {}, {}
    for dev in ("cuda", "cpu"):
        mod = DVBSDemodModule(str(w / "pass.cf32"), str(w / dev), dict(
            PASS_PARAMS, samplerate=220e3, symbolrate=100e3,
            conv_rate="auto", torch_device=dev))
        if dev == "cuda":
            _, wall, launches = _run_counted(
                mod.process, "dvbs_demod", need_kernels=False,
                kernels=_path_kernels() + _classic_kernels())
        else:
            mod.process()
        got[dev] = np.fromfile(mod.d_output_file, np.uint8)
        stats[dev] = mod.stats
    pk = got["cuda"].reshape(-1, 188)
    bad = sum(g.tobytes() not in {r.tobytes() for r in ts} for g in pk)
    if not np.array_equal(got["cuda"], got["cpu"]) or bad or \
            len(pk) < DVBS_TS_PACKETS // 2 or \
            stats["cuda"]["viterbi_rate"] != DVBS_PUNCTURED:
        raise AssertionError(f"dvbs_demod: .ts differs between the devices "
                             f"or from the packets sent ({len(pk)} packets,"
                             f" {bad} not sent; {stats})")
    walls["dvbs_ts"] = wall
    log(f"dvbs_demod rate {DVBS_PUNCTURED} (auto): {len(pk)} of "
        f"{DVBS_TS_PACKETS} TS packets, every one sent, .ts byte-identical "
        f"cuda vs cpu; card {wall:.3f} s; kernels launched {launches}")
    log(f"DVB phase {time.perf_counter() - t_phase:.1f} s")
    return walls


# phase 14: FengYun-3 AHRPT, the NOAA and METEOR HRPT family, Inmarsat.
# FY-3D AHRPT (FengYun-3.json fengyun3_d_ahrpt: QPSK at 30 Msym/s recorded
# at 90 Msps, sps 3, each rail its own r=1/2 k=7 code behind the FengYun
# differential code, RS(255,223) x4) on 342 CADUs (8,417,286 samples >
# 2^23, 0.094 s of signal); FY-3A/B at 8.4 Msps on a VIRR line and the
# VCID-12 sounders (54 CADUs) on the card and the CPU; NOAA GAC (NOAA.json
# noaa_gac: BPSK at 2.6616 Msym/s, 6 Msps, sps 2.254: K2) on 24 frames;
# NOAA HRPT and METEOR HRPT (665.4 kbit/s PM at 3 Msps) on 5 minor frames
# and 4 MSU-MR lines (51 CADUs); NOAA DSB from 330 TIP frames of softs;
# Inmarsat STD-C (1200 sym/s BPSK at 48 ksps, 3 frames), Aero 10.5k
# (OQPSK at 12 ksps, sps 2.29: K2) and Aero 1.2k (SDPSK at 48 ksps,
# the walkers), 6 frames each. The samplerates are the builder's: the
# Inmarsat pipeline files set none (at 48 ksps the JAX package's and the
# port's resampled OQPSK path loses lock on Aero 10.5k).
FY3_CADUS, FY3_LIVE_MSPS, FY3_AB_RATE, FY3_D_RATE = 342, 90.0, 8.4e6, 90e6
HRPT_GAC_FRAMES, HRPT_NOAA_FRAMES, HRPT_METEOR_LINES, HRPT_DSB_TIPS = \
    24, 5, 4, 330
HRPT_RATE, HRPT_BITRATE, HRPT_GAC_RATE, HRPT_GAC_SPS = \
    3e6, 665.4e3, 6e6, (2500, 1109)
HRPT_YEAR = 2024   # year_override of METEOR, GAC, DSB: no wall-clock year
HRPT_LEAD = 16384
INM_FRAMES, INM_STDC_RATE, INM_AERO_R_RATE, INM_AERO_P_RATE = \
    6, 48e3, 12e3, 48e3
INM_START = 86400.0 * 20000   # the parsers' start_timestamp
INM_AERO_R = ("inmarsat_aero_105", dict(oqpsk=True, dummy_bits=178,
                                        inter_cols=78, inter_blocks=1), 5250)
INM_AERO_P = ("inmarsat_aero_12", dict(oqpsk=False, dummy_bits=0,
                                       inter_cols=9, inter_blocks=2), 1200)


def _all_kernels():
    return _path_kernels() + _classic_kernels() + _vb_kernels()


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
    if (b / "dataset.json").read_text() != ds:
        raise AssertionError(f"{label}: dataset.json differs")
    products = json.loads(ds)["products"]
    for rel in products:
        for f in ("product.json", "product.cbor"):
            if (a / rel / f).read_bytes() != (b / rel / f).read_bytes():
                raise AssertionError(f"{label}: {rel}/{f} differs")
        pa, pb = load_product(str(a / rel)), load_product(str(b / rel))
        for x, y in zip(getattr(pa, "images", []), getattr(pb, "images", [])):
            if not _same_images(x.image, y.image):
                raise AssertionError(f"{label}: {rel} channel "
                                     f"{x.channel_name} differs")
        for png in sorted((a / rel).glob("*.png")):
            c = png.relative_to(a)
            if not _same_images(load_img(a / c), load_img(b / c)):
                raise AssertionError(f"{label}: image {c} differs")
    return products


def _staged(fname, pipe_id, src, work: Path, params: dict, levels,
            kernels=None):
    """src through `pipe_id` on the card one level at a time (levels: the
    pipeline's level names, the first the input's), each stage timed with
    the kernels' launches counted (counts set to 0 just before it, read
    just after). Returns ({level: output}, {level: wall s}, {level:
    launches})."""
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    outs, walls, launches = {}, {}, {}
    cur = str(src)
    for lo, hi in zip(levels[:-1], levels[1:]):
        out, walls[hi], launches[hi] = _run_counted(
            lambda: run_pipeline(_pipeline(fname, pipe_id, lo, hi), cur,
                                 str(work), user_params=dict(params),
                                 start_level=lo),
            f"{pipe_id} {lo}->{hi}", need_kernels=False,
            kernels=kernels or _all_kernels())
        outs[hi] = cur = out
    return outs, walls, launches


def _launched(launches: dict) -> dict:
    """{stage: {kernel: launches}} without the kernels never launched."""
    return {st: {k: n for k, n in ln.items() if n}
            for st, ln in launches.items()}


def _need(launches: dict, names, label: str) -> None:
    missing = [k for k in names if not launches.get(k)]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: {launches}")


def _ops_dispatched(fn) -> int:
    """The torch operators that fn() dispatches (a TorchDispatchMode
    counting them): for a loop of small ops on the card, one kernel launch
    or more each. Cheap where a profiler session is not: reading the trace
    of 10^5 launches takes tens of seconds."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _fy3_lock_search(soft_path: str) -> dict:
    """The FY-3D decoder's two steps on rail 0 of the card's .soft, on the
    card, apart: the lock search (Viterbi12Sync.search_stream, the block
    decoder K3) and the stream decode (K1); wall ms of each (host clock
    around a synchronized call), and the torch ops and K3 launches the
    search makes."""
    import torch
    from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
    from satdump_tpu_torch.ops.fec import convolutional as cc
    from satdump_tpu_torch.ops.fec.rotation import PHASE_0, PHASE_180
    from satdump_tpu_torch.pipeline.modules.ccsds.viterbi_sync import (
        HALO, SEG, Viterbi12Sync)
    rail = np.fromfile(soft_path, np.int8)[0::2]

    def search():
        v = Viterbi12Sync(0.30, 10, phases=[PHASE_0, PHASE_180],
                          device="cuda")
        return v.search_stream(rail)
    search()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    off = search()
    search_ms = (time.perf_counter() - t0) * 1e3
    acs = _vb_kernels()[0]
    acs.launches = 0
    n_ops = _ops_dispatched(search)
    k3 = acs.launches
    n = len(rail) // 2
    pairs = np.full((-(-n // SEG) * SEG, 2), 128.0, np.float32)
    pairs[:n] = cc.soft_int8_to_u8(rail[: 2 * n]).reshape(-1, 2)
    x = torch.from_numpy(pairs).cuda()
    k1_ms = call_ms(lambda: viterbi_re(x, seg=SEG, ovl=HALO), 5)
    return {"lock_offset": off, "search_ms": search_ms,
            "search_ops": n_ops, "search_k3": k3, "k1_ms": k1_ms,
            "rail_pairs": n}


def _fy3_pass(rng, work: Path) -> dict:
    """14.1: FY-3D at 90 Msps on the card, then FY-3A/B to products on the
    card and the CPU."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    out = {}
    cadus = sim.make_cadus(FY3_CADUS, rng)
    bb = sim.fy3_ahrpt_baseband(cadus, rng)
    w = work / "fy3d"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    outs, walls, launches = _staged(
        "FengYun-3.json", "fengyun3_d_ahrpt", w / "pass.cf32", w / "cuda",
        dict(PASS_PARAMS, samplerate=FY3_D_RATE),
        ("baseband", "soft", "cadu"))
    _need(launches["cadu"], ("viterbi_re",), "fengyun3_d_ahrpt decoder")
    _check_cadus(outs["cadu"], cadus, f"fengyun3_d_ahrpt 90 Msps "
                 f"({len(bb)} samples)")
    wall = walls["soft"] + walls["cadu"]
    rate = len(bb) / wall / 1e6
    split = _fy3_lock_search(outs["soft"])
    log(f"fengyun3_d_ahrpt 30 Msym/s at 90 Msps: baseband->CADU on the card "
        f"{wall:.3f} s = {rate:.3f} Msamp/s (live rate {FY3_LIVE_MSPS}: "
        f"{'met' if rate >= FY3_LIVE_MSPS else 'not met'}); psk_demod "
        f"{walls['soft']:.3f} s, decoder {walls['cadu']:.3f} s; launches "
        f"{_launched(launches)}; "
        f"{len(bb) / FY3_D_RATE:.4f} s of signal")
    log(f"fengyun3_d_ahrpt one rail ({split['rail_pairs']} pairs): lock "
        f"search {split['search_ms']:.1f} ms wall, {split['search_ops']} "
        f"torch ops, {split['search_k3']} K3 decodes, locked at soft "
        f"{split['lock_offset']}; K1 "
        f"{split['k1_ms']:.3f} ms a call (CUDA events); the decoder runs "
        f"one of each a rail")
    out.update(fy3d_soft_s=walls["soft"], fy3d_cadu_s=walls["cadu"],
               fy3d_msamp_s=rate, fy3d_k1_launches=launches["cadu"][
                   "viterbi_re"], fy3d_search_ms=split["search_ms"],
               fy3d_search_ops=split["search_ops"],
               fy3d_search_k3=split["search_k3"],
               fy3d_k1_ms=split["k1_ms"])
    # FY-3A/B at 8.4 Msps, a VIRR line and the VCID-12 sounders, baseband
    # -> products on the card and the CPU
    cadus, lines = sim.fy3_instrument_cadus(rng, 1, 3, 2)
    bb = sim.fy3_ahrpt_baseband(cadus, rng)
    w = work / "fy3ab"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        run_pipeline(_pipeline("FengYun-3.json", "fengyun3_ab_ahrpt",
                               stop="products"), str(w / "pass.cf32"),
                     str(w / dev), user_params=dict(
                         PASS_PARAMS, samplerate=FY3_AB_RATE,
                         torch_device=dev))
        torch.cuda.synchronize()
        out[f"fy3ab_{dev}_s"] = time.perf_counter() - t0
    c = {d: (w / d / "fengyun3_ab_ahrpt.cadu").read_bytes()
         for d in ("cuda", "cpu")}
    if c["cuda"] != c["cpu"] or c["cuda"] != cadus.tobytes():
        raise AssertionError("fengyun3_ab_ahrpt: .cadu differs between "
                             "cuda and cpu or from the CADUs sent")
    products = _same_products(w / "cuda", w / "cpu", "fengyun3_ab_ahrpt")
    from satdump_tpu_torch.products.product import load_product
    virr = load_product(str(w / "cuda" / "VIRR")).get_channel("1").image
    if not np.array_equal(virr // 64, lines[:, :, 0]):
        raise AssertionError("fengyun3_ab_ahrpt: VIRR differs from the line "
                             "sent")
    log(f"fengyun3_ab_ahrpt 8.4 Msps ({len(bb)} samples, {len(cadus)} "
        f"CADUs): baseband->products on the card {out['fy3ab_cuda_s']:.3f} s,"
        f" on the CPU {out['fy3ab_cpu_s']:.3f} s; .cadu identical and equal "
        f"to the CADUs sent, products {products} identical (VIRR = the line "
        f"sent)")
    return out


def _from_card_soft(fname, pipe_id, soft: str, work: Path, params: dict,
                    files, label: str) -> dict:
    """The card's .soft -> the pipeline's last level on the CPU, into
    work/cpu: `files` (glob patterns) must be byte-identical to the card's
    (work/cuda) and products equal. Returns {pattern: files matched}."""
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    t0 = time.perf_counter()
    run_pipeline(_pipeline(fname, pipe_id, "soft",
                           _last_level(fname, pipe_id)), soft,
                 str(work / "cpu"), user_params=dict(params,
                                                     torch_device="cpu"),
                 start_level="soft")
    cpu_s = time.perf_counter() - t0
    got = {}
    for pat in files:
        a, b = _tree(work / "cuda", pat), _tree(work / "cpu", pat)
        if a != b:
            raise AssertionError(f"{label}: {pat} differs between cuda and "
                                 f"cpu ({sorted(a)} / {sorted(b)})")
        got[pat] = len(a)
    if not any(got.values()):
        raise AssertionError(f"{label}: no {files} written")
    if (work / "cuda" / "dataset.json").exists():
        _same_products(work / "cuda", work / "cpu", label)
    log(f"{label}: the card's .soft on the CPU in {cpu_s:.3f} s: "
        f"{got} identical to the card's")
    return got


def _last_level(fname: str, pipe_id: str) -> str:
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    return parse_pipeline_file(ROOT / "resources" / "pipelines" /
                               fname)[pipe_id].steps[-1].level


def _hrpt_passes(rng, work: Path) -> dict:
    """14.2 NOAA GAC and 14.3 NOAA HRPT, METEOR HRPT and NOAA DSB."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.products.product import load_product
    out = {}
    # 14.2 NOAA GAC: BPSK at 6 Msps (sps 2.254, K2) -> .frm -> products
    bits, lines = sim.noaa_gac_frames(rng, HRPT_GAC_FRAMES)
    bits = np.concatenate([rng.integers(0, 2, 4096).astype(np.uint8), bits,
                           rng.integers(0, 2, 4096).astype(np.uint8)])
    bb = sim.psk_baseband(bits, rng, HRPT_GAC_SPS, "bpsk")
    w = work / "gac"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    params = dict(PASS_PARAMS, samplerate=HRPT_GAC_RATE,
                  year_override=HRPT_YEAR)
    outs, walls, launches = _staged(
        "NOAA.json", "noaa_gac", w / "pass.cf32", w / "cuda", params,
        ("baseband", "soft", "frm", "products"))
    _need(launches["soft"], ("resample_arith_grid",), "noaa_gac psk_demod")
    n_frm = Path(outs["frm"]).stat().st_size // 4159
    img = load_product(str(w / "cuda" / "AVHRR")).get_channel("1").image
    if n_frm != HRPT_GAC_FRAMES or not np.array_equal(img >> 6,
                                                      lines[:, :, 0]):
        raise AssertionError(f"noaa_gac: {n_frm} of {HRPT_GAC_FRAMES} "
                             f"frames, AVHRR equal to the lines sent: "
                             f"{np.array_equal(img >> 6, lines[:, :, 0])}")
    rate = len(bb) / (walls["soft"] + walls["frm"]) / 1e6
    log(f"noaa_gac 6 Msps ({len(bb)} samples): every frame of "
        f"{HRPT_GAC_FRAMES}, AVHRR = the lines sent; baseband->frm on the "
        f"card {walls['soft'] + walls['frm']:.3f} s = {rate:.3f} Msamp/s "
        f"(live rate 6.0: {'met' if rate >= 6.0 else 'not met'}), products "
        f"{walls['products']:.3f} s; launches {_launched(launches)}")
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    t0 = time.perf_counter()
    run_pipeline(_pipeline("NOAA.json", "noaa_gac", "frm", "products"),
                 outs["frm"], str(w / "cpu"),
                 user_params=dict(params, torch_device="cpu"),
                 start_level="frm")
    _same_products(w / "cuda", w / "cpu", "noaa_gac")
    log(f"noaa_gac: the card's .frm -> products on the CPU "
        f"{time.perf_counter() - t0:.3f} s, identical to the card's")
    out.update(gac_msamp_s=rate, gac_k2_launches=launches["soft"][
        "resample_arith_grid"])
    # 14.3 NOAA HRPT and METEOR HRPT: PM at 3 Msps (pm_demod's walkers).
    # pm_bpsk_baseband sends a 1 as -1 and pm_demod returns a +1 as a
    # positive soft, so the bits go out inverted to come back as sent; the
    # loops get HRPT_LEAD bits to settle (neither format carries a code
    # that would absorb their first slips)
    sps = HRPT_RATE / HRPT_BITRATE
    words, lines = sim.noaa_hrpt_frames(rng, HRPT_NOAA_FRAMES)
    meteor, imgs = sim.meteor_hrpt_cadus(rng, HRPT_METEOR_LINES)
    for pipe_id, fname, chan, p in (
            ("noaa_hrpt", "NOAA.json", sim.words_to_bits(words), {}),
            ("meteor_hrpt", "Meteor-M.json",
             np.unpackbits(meteor.reshape(-1)),
             {"year_override": HRPT_YEAR})):
        bb = sim.pm_bpsk_baseband(1 - chan, sps, rng, lead_bits=HRPT_LEAD)
        w = work / pipe_id
        w.mkdir(parents=True, exist_ok=True)
        write_baseband(w / "pass.cf32", "cf32", bb)
        params = dict(PASS_PARAMS, samplerate=HRPT_RATE, **p)
        levels = ("baseband", "soft") + tuple(
            s.level for s in _pipeline(fname, pipe_id, "soft",
                                       "products").steps[1:])
        outs, walls, launches = _staged(fname, pipe_id, w / "pass.cf32",
                                        w / "cuda", params, levels)
        _need(launches["soft"], ("agc_walk", "pll_walk", "costas_walk",
                                 "mm_walk"), f"{pipe_id} pm_demod")
        frm = outs[levels[2]]
        if pipe_id == "noaa_hrpt":
            got = np.fromfile(frm, "<u2").reshape(-1, 11090)
            ok = len(got) == HRPT_NOAA_FRAMES and np.array_equal(
                got[:, 6:], words[:, 6:])
            img = load_product(str(w / "cuda" / "AVHRR")).get_channel(
                "2").image
            ok &= np.array_equal(img >> 6, lines[:, :, 1])
        else:
            ok = Path(frm).read_bytes() == meteor.tobytes()
            img = load_product(str(w / "cuda" / "MSU-MR")).get_channel(
                "1").image
            ok &= np.array_equal(img >> 6, imgs[:, 0])
        if not ok:
            raise AssertionError(f"{pipe_id}: the frames or the imagery "
                                 f"differ from those sent")
        rate = len(bb) / walls["soft"] / 1e6
        log(f"{pipe_id} 3 Msps ({len(bb)} samples, "
            f"{len(bb) / HRPT_RATE:.3f} s): every frame sent found, imagery "
            f"= the lines sent; pm_demod on the card {walls['soft']:.3f} s = "
            f"{rate:.3f} Msamp/s (live rate 3.0: "
            f"{'met' if rate >= 3.0 else 'not met'}), then "
            + ", ".join(f"{lv} {walls[lv]:.3f} s" for lv in levels[2:])
            + f"; launches {_launched(launches)}")
        _from_card_soft(fname, pipe_id, outs["soft"], w, params,
                        ("*.frm", "*.cadu"), pipe_id)
        out[f"{pipe_id}_pm_msamp_s"] = rate
        out[f"{pipe_id}_walker_launches"] = launches["soft"]
    # NOAA DSB from softs of TIP frames, on both devices
    tips = sim.tip_frames(rng, HRPT_DSB_TIPS)
    w = work / "noaa_dsb"
    w.mkdir(parents=True, exist_ok=True)
    sim.soft_stream(np.unpackbits(tips.reshape(-1)), rng).tofile(
        w / "x.soft")
    params = dict(PASS_PARAMS, year_override=HRPT_YEAR)
    run_pipeline(_pipeline("NOAA.json", "noaa_dsb", "soft", "products"),
                 str(w / "x.soft"), str(w / "cuda"),
                 user_params=dict(params, torch_device="cuda"),
                 start_level="soft")
    if (w / "cuda" / "noaa_dsb.tip").read_bytes() != tips.tobytes():
        raise AssertionError("noaa_dsb: the TIP frames differ from those "
                             "sent")
    _from_card_soft("NOAA.json", "noaa_dsb", str(w / "x.soft"), w, params,
                    ("*.tip",), "noaa_dsb")
    return out


def _inmarsat_passes(rng, work: Path) -> dict:
    """14.4: STD-C, Aero 10.5k and Aero 1.2k from baseband to messages on
    the card; the card's .soft on the CPU; the block Viterbi's time and
    launches a frame."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.ops import inmarsat_aero as aero
    from satdump_tpu_torch.ops import inmarsat_stdc as stdc
    from satdump_tpu_torch.ops.fec.convolutional import viterbi_decode_block
    out = {}

    def noise(n):
        return rng.integers(0, 2, n).astype(np.uint8)

    stdc_frames = sim.stdc_frames()
    text = {"inmarsat_std_c": "THE QUICK BROWN FOX JUMPS OVER"}
    passes = [("inmarsat_std_c", INM_STDC_RATE, 1200, 10368, 640,
               sim.psk_baseband(
        np.concatenate([noise(2000)] + [stdc.encode_frame(f)
                                        for f in stdc_frames]
                       + [noise(2000)]), rng, (40, 1), "bpsk", snr_db=15.0,
        freq_offset=2e-4), len(stdc_frames))]
    for pipe_id, cfg, symrate in (INM_AERO_R, INM_AERO_P):
        n = aero.frame_geometry(**cfg)["info"] // 16
        # an ACARS message in 6 signal units: one 72-byte 1.2k frame
        text[pipe_id] = f"POS {symrate} BD"
        sus = sim.acars_signal_units("B-6543", "H1", text[pipe_id])
        frame = np.frombuffer(sus.ljust(n, b"\0")[:n], np.uint8)
        bits = np.concatenate([aero.encode_frame(frame, **cfg, rng=rng)
                               for _ in range(INM_FRAMES)])
        total = aero.frame_geometry(**cfg)["total"]
        if cfg["oqpsk"]:
            # the symbols a quarter turn on, (I, Q) -> (-Q, I): the softs
            # leave psk_demod at +90 degrees, as tests/test_inmarsat_aero.py
            # presents them. The correlator's OQPSK replicas (90, 270, and
            # 0 / 180 with the Q rail a symbol late) hold none for softs at
            # 0 degrees, in either package
            chan = np.concatenate([noise(2000), bits, noise(2000)])
            turned = np.empty_like(chan)
            turned[0::2], turned[1::2] = 1 - chan[1::2], chan[0::2]
            bb = sim.psk_baseband(turned, rng, (16, 7), "oqpsk",
                                  snr_db=15.0, freq_offset=2e-4)
            rate = INM_AERO_R_RATE
        else:
            bb = sim.fsk_baseband(bits, INM_AERO_P_RATE, symrate, rng,
                                  symrate / 4, snr_db=15.0, lead_bits=1000)
            rate = INM_AERO_P_RATE
        passes.append((pipe_id, rate, symrate * (2 if cfg["oqpsk"] else 1),
                       total, n, bb, INM_FRAMES))
    for pipe_id, rate, bitrate, frame_bits, frame_bytes, bb, sent in passes:
        w = work / pipe_id
        shutil.rmtree(w, ignore_errors=True)     # the parsers add files
        w.mkdir(parents=True)
        write_baseband(w / "pass.cf32", "cf32", bb)
        params = dict(PASS_PARAMS, samplerate=rate,
                      start_timestamp=INM_START)
        outs, walls, launches = _staged(
            "Inmarsat.json", pipe_id, w / "pass.cf32", w / "cuda", params,
            ("baseband", "soft", "frm", "msg"))
        n_frm = len(Path(outs["frm"]).read_bytes()) // frame_bytes
        msgs = _tree(w / "cuda", "*.json")
        # STD-C decodes every frame; the Aero decoder takes the best sync
        # of a two-frame window, so with noise it passes some over (in both
        # packages). Every message out must be the one sent
        texts = {json.loads(v).get("message") for k, v in msgs.items()
                 if k.startswith(("ACARS", "Full Message"))}
        need = sent if pipe_id == "inmarsat_std_c" else 2
        if n_frm < need or texts != {text[pipe_id]}:
            raise AssertionError(f"{pipe_id}: {n_frm} frames of {sent}, "
                                 f"messages {texts}")
        air = frame_bits / bitrate
        log(f"{pipe_id} at {rate:.0f} sps ({len(bb)} samples, "
            f"{len(bb) / rate:.2f} s of signal, {sent} frames of {air:.3f} s "
            f"sent): {len(msgs)} message files; on the card "
            + ", ".join(f"{lv} {walls[lv]:.3f} s" for lv in walls)
            + f"; {n_frm} frames out; launches {_launched(launches)}")
        _from_card_soft("Inmarsat.json", pipe_id, outs["soft"], w, params,
                        ("*.frm", "*.json"), pipe_id)
        out[f"{pipe_id}_s"] = sum(walls.values())
        out[f"{pipe_id}_launches"] = launches
    # the block Viterbi: STD-C's frames of a chunk batched in one call
    # (5,120 trellis steps), Aero a frame a call (10.5k: 2,496 steps)
    rows = np.stack([sim.soft_stream(stdc.encode_frame(f), rng, prefix=0)
                     for f in stdc_frames])
    for label, fn, frames, air in (
            ("STD-C", lambda: stdc.decode_frames(rows, "cuda"), 3, 8.64),
            ("Aero 10.5k", lambda: viterbi_decode_block(
                torch.full((1, 2496, 2), 200.0).cuda()), 1, 0.5)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        acs = _vb_kernels()[0]
        acs.launches = 0
        ops = _ops_dispatched(fn)
        log(f"block Viterbi on the card, {label}: a call of {frames} "
            f"frame(s) {ms:.1f} ms wall, {ms / frames:.1f} ms a frame against"
            f" {air} s of air time a frame; {ops} torch ops and "
            f"{acs.launches} K3 decodes a call")
        out[f"viterbi_{label}_k3_a_call"] = acs.launches
        out[f"viterbi_{label}_ms_a_frame"] = ms / frames
        out[f"viterbi_{label}_ops_a_call"] = ops
    return out


def phase_hrpt_inmarsat(rng, work: Path) -> dict:
    """FengYun-3 AHRPT, the HRPT family and Inmarsat on the card (phase
    14); returns the walls, rates and launches."""
    t_phase = time.perf_counter()
    out = _fy3_pass(rng, work)
    out.update(_hrpt_passes(rng, work))
    out.update(_inmarsat_passes(rng, work))
    log(f"HRPT / Inmarsat phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 15: JPSS HRD, GOES HRIT's products level and the host decoders.
# JPSS-2 HRD (JPSS.json jpss_hrd: OQPSK at 25 Msym/s recorded at 40 Msps,
# sps 1.6, RRC 0.5, k=7 r=1/2, NRZ-M, 1279-byte CADUs, RS(255,223) x5) on
# ~500 CADUs (~2^23 samples, 0.21 s of signal) carrying one segment of each
# VIIRS band in JPSS_BANDS, ATMS scans and an OMPS nadir frame; psk_demod
# takes 2^16-sample blocks there and on Aqua DB (at its default 2^18 the
# OQPSK rails slip half a symbol after ~3 blocks on JPSS, and Aqua DB's
# carrier a quarter turn at a seam, in both packages: ROADMAP.md section
# 3, S5). Suomi NPP HRD (npp_hrd: QPSK at 15 Msym/s, 25 Msps, sps 5/3,
# RS x4) on one VIIRS band and an ATMS scan. GOES-R HRIT (GOES.json goes_hrit, 6 Msps) carrying a Rice-coded ABI
# image in XRIT_SEGMENTS segments and an EMWIN text file. Short passes of
# Aqua DB (EOS.json aqua_db: OQPSK 7.5 Msym/s at 15 Msps, sps 2, the strip
# path), GOES GVAR (BPSK 2.11 Msym/s at 6 Msps: K2), GOES-N sensor data
# (BPSK 2.621 Msym/s at 6 Msps: K2), M10 radiosondes (FSK 9600 Bd at 96
# ksps) and Orbcomm STX (FSK 4800 Bd at 48 ksps): the walkers; and
# dvbs2_test's network_server on localhost.
JPSS_RATE, JPSS_BLOCK = 40e6, 1 << 16
JPSS_BANDS = ("M4", "M6", "M7", "M9", "M10", "M12")
JPSS_ATMS_SCANS, JPSS_OMPS_FRAMES, JPSS_IDLE = 4, 1, 6
JPSS_NPP_BANDS, JPSS_NPP_RATE = ("M6",), 25e6
XRIT_SEGMENTS, XRIT_WIDTH, XRIT_LINES = 4, 400, 20
XRIT_EMWIN = b"ZCZC TEST EMWIN BULLETIN\r\n" * 40
EOS_POSITIONS, EOS_RATE = 24, 15e6
GVAR_VIS_BLOCKS, GVAR_RATE = 2, 6e6
HOST_SD_FRAMES, HOST_M10_FRAMES, HOST_ORBCOMM_FRAMES = 400, 3, 3
HOST_TS_PACKETS = 70
# phase 15 draws from a generator of its own, so that it alone (c.HOST_SEED
# in the README's command) sees the inputs of the whole script's run
HOST_SEED = SEED + 15


def _card_cpu_levels(label, fname, pipe_id, src: Path, work: Path, stages,
                     files, need=()) -> dict:
    """src through `pipe_id` on the card one level at a time (stages:
    (from level, to level, user params)), each stage timed with every
    kernel's launches counted (`_staged`; `need` must have launched), then
    the same stages on the CPU: the files matching `files` (glob patterns)
    must be byte-identical on both and the products equal. Returns
    {"cuda": {level: output}, "walls": {level: s}, "cpu_walls": ...,
    "launches": {level: ...}}."""
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    res = {"walls": {}, "cpu_walls": {}, "launches": {}, "cuda": {}}
    cur = str(src)
    for lo, hi, params in stages:
        o, w, ln = _staged(fname, pipe_id, cur, work / "cuda", params,
                           (lo, hi))
        cur = res["cuda"][hi] = o[hi]
        res["walls"][hi], res["launches"][hi] = w[hi], ln[hi]
    cur = str(src)
    for lo, hi, params in stages:
        t0 = time.perf_counter()
        cur = run_pipeline(_pipeline(fname, pipe_id, lo, hi), cur,
                           str(work / "cpu"), user_params=dict(
                               params, torch_device="cpu"), start_level=lo)
        res["cpu_walls"][hi] = time.perf_counter() - t0
    _need({k: sum(ln[k] for ln in res["launches"].values())
           for k in res["launches"][stages[0][1]]}, need, label)
    got = {}
    for pat in files:
        a, b = _tree(work / "cuda", pat), _tree(work / "cpu", pat)
        if a != b or not a:
            raise AssertionError(f"{label}: {pat} differs between cuda and "
                                 f"cpu or is missing ({sorted(a)} / "
                                 f"{sorted(b)})")
        got[pat] = len(a)
    products = []
    if (work / "cuda" / "dataset.json").exists():
        products = _same_products(work / "cuda", work / "cpu", label)
    log(f"{label}: card {json.dumps(res['walls'])} s, CPU "
        f"{json.dumps(res['cpu_walls'])} s; {got} and products {products} "
        f"identical on both; launches {_launched(res['launches'])}")
    return res


def _jpss_truth(out: Path, truth: dict, label: str) -> None:
    """VIIRS, ATMS and OMPS products under `out` hold what
    sim.jpss_instrument_cadus sent."""
    from satdump_tpu_torch.image.geometry import correct_generic_bowtie
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.models.jpss import VIIRS_CHANNELS
    from satdump_tpu_torch.products.product import load_product
    vp = load_product(str(out / "VIIRS"))
    for band, rows in truth["viirs"].items():
        h = VIIRS_CHANNELS[band].zone_height
        want = correct_generic_bowtie(rows, h, 1.0 / 1.9, 0.52333)
        if not np.array_equal(vp.get_channel(band.lower()).image[:h], want):
            raise AssertionError(f"{label}: VIIRS {band} differs from the "
                                 "segment sent")
    ap = load_product(str(out / "ATMS"))
    for c in range(22):
        if not np.array_equal(ap.get_channel(str(c + 1)).image,
                              truth["atms"][:, c, :96][:, ::-1]):
            raise AssertionError(f"{label}: ATMS channel {c + 1} differs "
                                 "from the scans sent")
    if len(truth["omps"]):
        omps = load_img(out / "OMPS" / "Nadir" / "OMPS-Nadir-1.png")
        if not np.array_equal(omps, truth["omps"][:, 0]):
            raise AssertionError(f"{label}: OMPS nadir differs from the "
                                 "frames sent")


def _jpss_passes(rng, work: Path) -> dict:
    """15.1 JPSS-2 HRD at 40 Msps and 15.2 Suomi NPP HRD at 25 Msps,
    baseband -> CADU -> products on the card and the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    out = {}
    for key, pipe_id, bands, npp, rate, sps, cons, block in (
            ("jpss", "jpss_hrd", JPSS_BANDS, False, JPSS_RATE,
             sim.JPSS_HRD_SPS, "oqpsk", JPSS_BLOCK),
            ("npp", "npp_hrd", JPSS_NPP_BANDS, True, JPSS_NPP_RATE,
             sim.NPP_HRD_SPS, "qpsk", None)):
        t0 = time.perf_counter()
        cadus, truth = sim.jpss_instrument_cadus(
            rng, bands, JPSS_ATMS_SCANS if not npp else 1,
            JPSS_OMPS_FRAMES if not npp else 0, npp=npp, idle=JPSS_IDLE)
        bb = sim.ccsds_psk_baseband(cadus, rng, sps, cons, nrzm=True)
        w = work / pipe_id
        w.mkdir(parents=True, exist_ok=True)
        write_baseband(w / "pass.cf32", "cf32", bb)
        label = f"{pipe_id} {rate / 1e6:g} Msps"
        log(f"{label}: {len(cadus)} CADUs ({', '.join(bands)}, "
            f"{len(truth['atms'])} ATMS scans, {len(truth['omps'])} OMPS "
            f"frames), {len(bb)} samples ({len(bb) / rate:.4f} s), made in "
            f"{time.perf_counter() - t0:.1f} s")
        soft = dict(PASS_PARAMS, samplerate=rate)
        if block:
            soft["buffer_size"] = block
        res = _card_cpu_levels(
            label, "JPSS.json", pipe_id, w / "pass.cf32", w,
            (("baseband", "soft", soft), ("soft", "cadu", dict(PASS_PARAMS)),
             ("cadu", "products", {})),
            (f"{pipe_id}.cadu", "*.png"),
            need=("viterbi_re", "resample_arith_grid"))
        _check_cadus(res["cuda"]["cadu"], cadus, f"{label} (cuda)")
        _jpss_truth(w / "cuda", truth, label)
        walls = res["walls"]
        wall = walls["soft"] + walls["cadu"]
        msps = len(bb) / wall / 1e6
        log(f"{label}: baseband->CADU on the card {wall:.3f} s = {msps:.3f} "
            f"Msamp/s (live rate {rate / 1e6:g}: "
            f"{'met' if msps >= rate / 1e6 else 'not met'}); psk_demod "
            f"{walls['soft']:.3f} s, decoder {walls['cadu']:.3f} s, "
            f"jpss_instruments {walls['products']:.3f} s; VIIRS, ATMS and "
            f"OMPS equal to what was sent")
        out.update({f"{key}_soft_s": walls["soft"],
                    f"{key}_cadu_s": walls["cadu"],
                    f"{key}_products_s": walls["products"],
                    f"{key}_msamp_s": msps, f"{key}_samples": len(bb),
                    f"{key}_cadus": len(cadus),
                    f"{key}_cpu_s": sum(res["cpu_walls"].values()),
                    f"{key}_k1_launches": res["launches"]["cadu"][
                        "viterbi_re"],
                    f"{key}_k2_launches": res["launches"]["soft"][
                        "resample_arith_grid"]})
    return out


def _xrit_pass(rng, work: Path) -> dict:
    """15.3 GOES-R HRIT at 6 Msps carrying a Rice-coded ABI image and an
    EMWIN file, baseband -> products on the card and the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.io import write_baseband
    cadus, full = sim.goes_hrit_xrit_cadus(rng, XRIT_SEGMENTS, XRIT_WIDTH,
                                           XRIT_LINES, XRIT_EMWIN)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.GOES_HRIT_SPS, "bpsk",
                                nrzm=True)
    w = work / "goes_hrit"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    label = "goes_hrit xRIT 6 Msps"
    res = _card_cpu_levels(
        label, "GOES.json", "goes_hrit", w / "pass.cf32", w,
        (("baseband", "soft", dict(PASS_PARAMS, samplerate=6e6)),
         ("soft", "cadu", dict(PASS_PARAMS)), ("cadu", "products", {})),
        ("goes_hrit.cadu", "IMAGES/*.png", "EMWIN/*"),
        need=("viterbi_re", "resample_arith_grid"))
    _check_cadus(res["cuda"]["cadu"], cadus, f"{label} (cuda)")
    img = load_img(w / "cuda" / "IMAGES" / "GOES-16_13_7.png")
    emwin = (w / "cuda" / "EMWIN" / "A_EMWIN_TEST.txt").read_bytes()
    if not np.array_equal(img, full) or emwin != XRIT_EMWIN:
        raise AssertionError(f"{label}: the ABI image or the EMWIN file "
                             "differs from what was sent")
    log(f"{label}: {len(cadus)} CADUs, {len(bb)} samples; the ABI image "
        f"({full.shape[0]} x {full.shape[1]}, {XRIT_SEGMENTS} Rice-coded "
        f"segments) and the EMWIN file equal to what was sent")
    return {"xrit_" + k + "_s": v for k, v in res["walls"].items()}


def _host_passes(rng, work: Path) -> dict:
    """15.4 Aqua DB, GOES GVAR, GOES-N sensor data, M10 and Orbcomm, one
    short pass each from baseband on the card and the CPU; dvbs2_test's
    network_server on localhost."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.products.product import load_product
    out = {}

    def bb_pass(key, label, fname, pipe_id, bb, rate, levels, files, need,
                soft=None):
        w = work / pipe_id
        w.mkdir(parents=True, exist_ok=True)
        write_baseband(w / "pass.cf32", "cf32", bb)
        stages = [(levels[0], levels[1],
                   dict(PASS_PARAMS, samplerate=rate, **(soft or {})))]
        stages += [(lo, hi, dict(PASS_PARAMS))
                   for lo, hi in zip(levels[1:-1], levels[2:])]
        res = _card_cpu_levels(label, fname, pipe_id, w / "pass.cf32", w,
                               stages, files, need)
        wall = sum(res["walls"].values())
        out[f"{key}_s"] = wall
        out[f"{key}_launches"] = _launched(res["launches"])
        log(f"{label}: {len(bb)} samples ({len(bb) / rate:.4f} s) to "
            f"{levels[-1]} on the card in {wall:.3f} s")
        return w / "cuda", res

    # Aqua DB at 15 Msps (sps 2: the strip resampler, no K2) -> MODIS
    cadus, _ = sim.aqua_modis_cadus(rng, EOS_POSITIONS)
    d, res = bb_pass("aqua", "aqua_db 15 Msps", "EOS.json", "aqua_db",
                     sim.aqua_db_baseband(cadus, rng), EOS_RATE,
                     ("baseband", "soft", "cadu", "products"),
                     ("aqua_db.cadu",), (), {"buffer_size": JPSS_BLOCK})
    _check_cadus(res["cuda"]["cadu"], cadus, "aqua_db 15 Msps (cuda)")
    modis = load_product(str(d / "MODIS"))
    if modis.get_channel("1").image.shape[1] != 1354 * 4:
        raise AssertionError("aqua_db: MODIS channel 1 has the wrong width")
    # GOES GVAR at 6 Msps (sps 2.84: K2) -> frames -> the imager product
    frames, _, vis = sim.gvar_imager_frames(rng, 3, GVAR_VIS_BLOCKS)
    d, res = bb_pass("gvar", "goes_gvar 6 Msps", "GOES.json", "goes_gvar",
                     sim.gvar_baseband(frames, rng), GVAR_RATE,
                     ("baseband", "soft", "gvar", "products"),
                     ("goes_gvar.gvar",), ("resample_arith_grid",))
    img = load_product(str(d / "IMAGER")).images[0].image
    if not all(np.array_equal(img[3 * 8 + k] >> 6, vis[k])
               for k in range(GVAR_VIS_BLOCKS)):
        raise AssertionError("goes_gvar: VIS lines differ from those sent")
    # GOES-N sensor data at 6 Msps (sps 2.29: K2) -> frames
    bits, payloads = sim.goesn_sd_bits(rng, HOST_SD_FRAMES)
    d, res = bb_pass("sd", "goesn_sd 6 Msps", "GOES.json", "goesn_sd",
                     sim.goesn_sd_baseband(bits, rng), 6e6,
                     ("baseband", "soft", "frm"), ("goesn_sd.frm",),
                     ("resample_arith_grid",))
    # a 14-bit marker with no check on the frame: the random bits around
    # the frames may hold one, as on the air, so count the frames sent
    got = {g.tobytes() for g in
           np.fromfile(d / "goesn_sd.frm", np.uint8).reshape(-1, 60)}
    found = sum(p.tobytes() in got for p in payloads)
    log(f"goesn_sd: {found} of {HOST_SD_FRAMES} frames sent found, "
        f"{len(got) - found} frames from the noise around them")
    if found < HOST_SD_FRAMES - 2:
        raise AssertionError(f"goesn_sd: {found} of {HOST_SD_FRAMES} "
                             "frames sent found")
    # M10 radiosonde (96 ksps) and Orbcomm STX (48 ksps): fsk_demod's
    # walkers, then the host decoders
    d, res = bb_pass("m10", "radiosonde_m10 96 ksps", "Radiosonde.json",
                     "radiosonde_m10", sim.fsk_baseband(
                         sim.m10_channel_bits(rng, HOST_M10_FRAMES), 96e3,
                         9600, rng, 4800.0), 96e3,
                     ("baseband", "soft", "frames"),
                     ("radiosonde_m10.frm", "m10_track.json"),
                     ("agc_walk", "mm_walk"))
    if len(json.loads((d / "m10_track.json").read_text())) != \
            HOST_M10_FRAMES:
        raise AssertionError("radiosonde_m10: positions missing")
    d, res = bb_pass("orbcomm", "orbcomm_stx 48 ksps", "Orbcomm.json",
                     "orbcomm_stx", sim.fsk_baseband(
                         sim.orbcomm_channel_bits(rng, HOST_ORBCOMM_FRAMES),
                         48e3, 4800, rng, 2400.0), 48e3,
                     ("baseband", "soft", "frm", "packets"),
                     ("orbcomm_stx.frm", "orbcomm.json"),
                     ("agc_walk", "mm_walk"))
    eph = [p["scid"] for p in json.loads((d / "orbcomm.json").read_text())
           if p["type"] == "ephemeris"]
    if eph != list(range(105, 105 + HOST_ORBCOMM_FRAMES)):
        raise AssertionError(f"orbcomm_stx: ephemerides of {eph}")
    out["net_s"] = _network_pass(rng, work / "net")
    return out


def _network_pass(rng, work: Path) -> float:
    """dvbs2_test's last level: a .ts file's packets out of network_server
    (udp_send) to a receiver on localhost, every byte back."""
    from satdump_tpu_torch.io.net import UDPFrameReceiver
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    ts = rng.integers(0, 256, (HOST_TS_PACKETS, 188), dtype=np.uint8)
    ts[:, 0] = 0x47
    work.mkdir(parents=True, exist_ok=True)
    ts.tofile(work / "pass.ts")
    rx = UDPFrameReceiver(0, timeout=5.0)
    try:
        t0 = time.perf_counter()
        run_pipeline(_pipeline("DVB_Test.json", "dvbs2_test", "ts", "net"),
                     str(work / "pass.ts"), str(work),
                     user_params={"server_port": rx.port}, start_level="ts")
        got = b"".join(rx.recv(1316) or b""
                       for _ in range(HOST_TS_PACKETS // 7))
        wall = time.perf_counter() - t0
    finally:
        rx.close()
    if got != ts.tobytes():
        raise AssertionError("dvbs2_test: the packets received differ from "
                             "the .ts sent")
    log(f"dvbs2_test network_server (udp_send, localhost): "
        f"{HOST_TS_PACKETS} TS packets in {HOST_TS_PACKETS // 7} datagrams, "
        f"every byte received, {wall:.3f} s")
    return wall


def phase_host_decoders(rng, work: Path) -> dict:
    """JPSS HRD, GOES HRIT to products and the host decoders on the card
    (phase 15); returns the walls, rates and launches."""
    t_phase = time.perf_counter()
    out = _jpss_passes(rng, work)
    out.update(_xrit_pass(rng, work))
    out.update(_host_passes(rng, work))
    log(f"JPSS / xRIT / host decoders phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# phase 16: the xRIT image decoders and GOES-R GRB's products on the port's
# own codecs. ELEKTRO-L HRIT at 3 Msps (its file's rate: 1.157 Msym/s QPSK,
# sps 2.593, so psk_demod picks symbols with K2) and GK-2A HRIT at 6 Msps
# (its file's: 3 Msym/s QPSK, sps 2, the strip path), both through K1, then
# their data decoders; GOES-R GRB at 17,331,876 sps (2 sps) to ABI and GLM;
# HimawariCast's decoder from a .cadu (its pipeline feeds it BBFrames, which
# it reads as CADUs: ROADMAP S6); every committed J2K fixture; the port's
# J2K encoder; the islow IDCT on the card and the host. Segments are cut
# in lines only: 32 lines at MSU-GS's full-disk 2,784 columns (ELEKTRO) and
# at GK-2A LRIT's full-disk 2,200 (every GK-2A channel, its J2K channel a
# 12-bit scene encoded by the port's compress_j2k); GRB's ABI blocks are
# 32 rows of MESO's 500, cut from one 12-bit scene and encoded by the port.
XRIT2_RATE, XRIT2_SEGMENTS, XRIT2_WIDTH, XRIT2_LINES = 3e6, 4, 2784, 32
XRIT2_GK2A_RATE, XRIT2_GK2A_WIDTH, XRIT2_GK2A_LINES = 6e6, 2200, 32
XRIT2_HIMAWARI_WIDTH, XRIT2_HIMAWARI_LINES = 1100, 11
GRB2_RATE, GRB2_BLOCKS, GRB2_FLASHES = 2 * 8_665_938, 8, 5
J2K_REPS = 5
# the scenes the port's J2K encoder encodes (GRB's ABI blocks here, GK-2A's
# SW038 in sim.gk2a_xrit_files) come from generators of their own, so phase
# 16's other inputs stay as they were; the encoder is timed on a 32 x 2,200
# 12-bit segment
J2KE_SEED = SEED + 21
J2KE_SHAPE = (32, 2200)
# an 8-bit JPEG segment at a full-disk product's size for the IDCT's times
XRIT2_IDCT_SHAPE = (464, 2784)
XRIT2_SEED = SEED + 16


def _xrit2_elektro(rng, work: Path) -> dict:
    """16.1 ELEKTRO-L HRIT at 3 Msps: 8-bit JPEG and 10-bit wavelet
    segments, baseband -> products on the card and the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.image.jpeg import decode_jpeg_gray
    from satdump_tpu_torch.io import write_baseband
    files, truth = sim.elektro_xrit_files(rng, XRIT2_SEGMENTS, XRIT2_WIDTH,
                                          XRIT2_LINES)
    cadus = sim.xrit_geo_cadus(files)
    bb = sim.ccsds_psk_baseband(cadus, rng, sim.ELEKTRO_HRIT_SPS, "qpsk")
    w = work / "elektro_hrit"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    label = "elektro_hrit 3 Msps"
    res = _card_cpu_levels(
        label, "Elektro_Arktika.json", "elektro_hrit", w / "pass.cf32", w,
        (("baseband", "soft", dict(PASS_PARAMS, samplerate=XRIT2_RATE)),
         ("soft", "cadu", dict(PASS_PARAMS)), ("cadu", "products", {})),
        ("elektro_hrit.cadu", "*.png"),
        need=("viterbi_re", "resample_arith_grid"))
    _check_cadus(res["cuda"]["cadu"], cadus, f"{label} (cuda)")
    d = w / "cuda" / "IMAGES" / "MSU-GS"
    jpeg = np.concatenate([decode_jpeg_gray(j, "cpu") for j in truth["jpeg"]])
    if not (np.array_equal(load_img(d / "MSU-GS_GOMS3_ch9_202601010000.png"),
                           truth["wt"])
            and np.array_equal(load_img(d / "MSU-GS_GOMS3_ch5_202601010000"
                                        ".png"), jpeg)):
        raise AssertionError(f"{label}: an image differs from what was sent "
                             "(wavelet) or from the CPU's decode (JPEG)")
    log(f"{label}: {len(cadus)} CADUs, {len(bb)} samples; {2 * XRIT2_SEGMENTS}"
        f" segments of {XRIT2_LINES} x {XRIT2_WIDTH}: the wavelet image "
        f"equals what was sent, the JPEG image the CPU's decode")
    return res


def _xrit2_gk2a(rng, work: Path) -> dict:
    """16.2 GK-2A HRIT at 6 Msps: encrypted, 8- and 12-bit JPEG and J2K
    segments (one behind the UHRIT preamble), baseband -> products on the
    card and the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.image.j2k import decompress_j2k
    from satdump_tpu_torch.image.jpeg12 import decompress_jpeg12
    from satdump_tpu_torch.io import write_baseband
    files, keyfile, truth = sim.gk2a_xrit_files(rng, XRIT2_GK2A_WIDTH,
                                                XRIT2_GK2A_LINES)
    cadus = sim.xrit_geo_cadus(files)
    bb = sim.ccsds_psk_baseband(cadus, rng, (2, 1), "qpsk")
    w = work / "gk2a_hrit"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    (w / "keys.bin").write_bytes(keyfile)
    label = "gk2a_hrit 6 Msps"
    res = _card_cpu_levels(
        label, "GK2A.json", "gk2a_hrit", w / "pass.cf32", w,
        (("baseband", "soft", dict(PASS_PARAMS, samplerate=XRIT2_GK2A_RATE)),
         ("soft", "cadu", dict(PASS_PARAMS)),
         ("cadu", "products", {"gk2a_keys": str(w / "keys.bin")})),
        ("gk2a_hrit.cadu", "*.png", "ADD/*"), need=("viterbi_re",))
    _check_cadus(res["cuda"]["cadu"], cadus, f"{label} (cuda)")
    d = w / "cuda" / "IMAGES" / "AMI"
    # SW038: the 12-bit scene sent, at the decoder's 16-bit scale
    if not np.array_equal(np.concatenate([decompress_j2k(c)
                                          for c in truth["j2k"]]),
                          truth["sw038"]):
        raise AssertionError(f"{label}: SW038's codestreams do not decode "
                             "to the scene")
    want = {"WV069": truth["wv069"], "SW038": truth["sw038"] << 4,
            "VI006": np.concatenate([decompress_jpeg12(j)
                                     for j in truth["jpeg8"]]),
            "IR105": np.concatenate([decompress_jpeg12(j)
                                     for j in truth["jpeg12"]])}
    for ch, img in want.items():
        if not np.array_equal(load_img(d / f"AMI_{ch}_20260101000000.png"),
                              img):
            raise AssertionError(f"{label}: {ch} differs from what was sent")
    log(f"{label}: {len(cadus)} CADUs, {len(bb)} samples; 8 segments of "
        f"{XRIT2_GK2A_LINES} x {XRIT2_GK2A_WIDTH} (DES-encrypted raw, 8- and "
        f"12-bit JPEG, 12-bit J2K by the port's encoder with and without the "
        f"UHRIT preamble, {sum(map(len, truth['j2k']))} bytes) and the "
        f"additional-data file decoded; the encrypted and J2K images equal "
        f"what was sent, the JPEG images the CPU's decode")
    return res


def _xrit2_himawari(rng, work: Path) -> float:
    """16.3 himawaricast_data_decoder from a .cadu of ten 16-bit segments,
    on the card's default device and the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.xrit.geo import HimawariCastDataDecoderModule
    files, img = sim.himawari_xrit_files(rng, XRIT2_HIMAWARI_WIDTH,
                                         XRIT2_HIMAWARI_LINES)
    w = work / "himawaricast"
    w.mkdir(parents=True, exist_ok=True)
    sim.xrit_geo_cadus(files).tofile(w / "h.cadu")
    walls = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        HimawariCastDataDecoderModule(str(w / "h.cadu"), str(w / dev / "x"),
                                      {"torch_device": dev}).process()
        walls[dev] = time.perf_counter() - t0
    got = [load_img(w / dev / "IMAGES" / "AHI" / "AHI_3_202601010000.png")
           for dev in ("cuda", "cpu")]
    if not (np.array_equal(got[0], img << 6)
            and np.array_equal(got[1], got[0])):
        raise AssertionError("himawaricast: the image differs from what was "
                             "sent")
    log(f"himawaricast_data_decoder (.cadu, 10 segments of "
        f"{XRIT2_HIMAWARI_LINES} x {XRIT2_HIMAWARI_WIDTH}): card "
        f"{walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s, the image equal "
        f"to what was sent on both")
    return walls["cuda"]


def _grb2_pass(rng, work: Path) -> dict:
    """16.4 GOES-R GRB at 2 sps: ABI MESO-1 channel 13 in J2K blocks of 32
    rows at 500 columns (GRB2_BLOCKS blocks of one 12-bit scene, encoded
    by the port's compress_j2k) and a GLM flash frame, baseband ->
    products on the card and the CPU."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    from satdump_tpu_torch.image.j2k import compress_j2k, decompress_j2k
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.models.goes_grb import (ABI_CHANNEL_PARAMS,
                                                   GLM_FLASH,
                                                   parse_glm_frame)
    from satdump_tpu_torch.ops.dvbs2 import tx
    depth = ABI_CHANNEL_PARAMS[13][1]
    scene = sim.smooth_scene(np.random.default_rng(J2KE_SEED),
                             32 * GRB2_BLOCKS, 500, depth)
    blocks = []
    for k in range(GRB2_BLOCKS):
        rows = scene[32 * k: 32 * (k + 1)]
        cs = compress_j2k(rows)
        if not np.array_equal(decompress_j2k(cs), rows):
            raise AssertionError(f"GRB block {k}: the port's J2K stream "
                                 "does not decode to its rows")
        blocks.append((cs, rows))
    cadus, truth = sim.grb_abi_cadus(rng, blocks, glm_flashes=GRB2_FLASHES)
    # fill behind the data: the extractor's look-ahead ends two BBFrames
    # before the stream does
    fill = sim.grb_cadus([], 5, idle=12)
    syms = tx.bbframes_to_symbols(sim.grb_bbframes(
        np.concatenate([cadus, fill])), 11, False, False).ravel()
    bb = sim.dvbs2_baseband(syms, rng)
    w = work / "goes_grb"
    w.mkdir(parents=True, exist_ok=True)
    write_baseband(w / "pass.cf32", "cf32", bb)
    label = "goes_grb products 17.33 Msps"
    res = _card_cpu_levels(
        label, "GOES.json", "goes_grb", w / "pass.cf32", w,
        (("baseband", "bbframe", dict(PASS_PARAMS, samplerate=GRB2_RATE)),
         ("bbframe", "cadu", {}), ("cadu", "products", {})),
        ("goes_grb.cadu", "*.png", "*.json"))
    png = next((w / "cuda" / "ABI" / "MESO1").rglob("ABI_MESO1_13_*.png"))
    img = load_img(png)
    n = len(truth["image"])
    glm = json.loads(next((w / "cuda" / "GLM" / "Flash").glob("*.json"))
                     .read_text())
    want_glm = json.loads(json.dumps(parse_glm_frame(truth["glm"],
                                                     GLM_FLASH)))
    if not (np.array_equal(img[:n], truth["image"] << (16 - depth))
            and not img[n:].any() and glm == want_glm):
        raise AssertionError(f"{label}: the ABI image or the GLM records "
                             "differ from what was sent")
    log(f"{label}: {len(cadus)} data CADUs, {len(bb)} samples; "
        f"{GRB2_BLOCKS} ABI J2K blocks of one {depth}-bit scene ({n} x 500, "
        f"encoded by the port) and {GRB2_FLASHES} GLM flashes equal to what "
        f"was sent")
    return res


def _j2k_fixtures() -> dict:
    """16.5 every committed J2K codestream decoded, its SHA-256 and its
    decode's against MANIFEST.json; tier-2, tier-1 and the inverse DWT
    timed apart on a GRB block (500 x 32, 16-bit, 5/3)."""
    import hashlib
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image import j2k
    manifest = json.loads((sim.J2K_TESTDATA / "MANIFEST.json").read_text())
    for name, m in manifest.items():
        data = (sim.J2K_TESTDATA / name).read_bytes()
        img = j2k.decompress_j2k(data)
        if (hashlib.sha256(data).hexdigest() != m["sha256"]
                or hashlib.sha256(img.tobytes()).hexdigest()
                != m["decoded_sha256"]):
            raise AssertionError(f"J2K fixture {name}: its bytes or its "
                                 "decode differ from MANIFEST.json")
    block = sim.j2k_fixture("grb_abi_c13_0.jp2")
    split = {"tier2": 0.0, "tier1": 0.0, "idwt": 0.0}
    t0 = time.perf_counter()
    for _ in range(J2K_REPS):
        times = j2k.decompress_j2k_timed(block)[1]
        for k in split:
            split[k] += times[k]
    total = (time.perf_counter() - t0) / J2K_REPS * 1e3
    split = {k: v / J2K_REPS * 1e3 for k, v in split.items()}
    log(f"J2K: all {len(manifest)} committed codestreams match "
        f"MANIFEST.json; a GRB block (500 x 32, 16-bit, 5/3, "
        f"{len(block)} bytes): {total:.3f} ms a decode, tier-2 "
        f"{split['tier2']:.3f} ms, tier-1 {split['tier1']:.3f} ms, inverse "
        f"DWT {split['idwt']:.3f} ms (host, mean of {J2K_REPS})")
    return dict(split, total=total, fixtures=len(manifest))


def _j2k_encoder() -> dict:
    """16.5b the port's J2K encoder on the host: a J2KE_SHAPE 12-bit
    segment (GK-2A's SW038 at full width) encoded lossless (5/3) and 9/7,
    each the mean of J2K_REPS, its bytes, and its decode: exact (5/3),
    within the quantization (9/7)."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image import j2k
    img = sim.smooth_scene(np.random.default_rng(J2KE_SEED + 1),
                           *J2KE_SHAPE, 12)
    out = {}
    for name, lossless in (("53", True), ("97", False)):
        t0 = time.perf_counter()
        for _ in range(J2K_REPS):
            data = j2k.compress_j2k(img, lossless=lossless)
        ms = (time.perf_counter() - t0) / J2K_REPS * 1e3
        err = int(np.abs(j2k.decompress_j2k(data).astype(np.int64)
                         - img).max())
        if err > (0 if lossless else 4):
            raise AssertionError(f"J2K encoder {name}: its decode is {err} "
                                 "levels off")
        out[f"{name}_ms"], out[f"{name}_bytes"] = ms, len(data)
        out[f"{name}_max_err"] = err
    log(f"J2K encoder (host), a {J2KE_SHAPE[0]} x {J2KE_SHAPE[1]} 12-bit "
        f"segment: 5/3 {out['53_ms']:.2f} ms ({out['53_bytes']} bytes, "
        f"exact), 9/7 {out['97_ms']:.2f} ms ({out['97_bytes']} bytes, within "
        f"{out['97_max_err']} levels); mean of {J2K_REPS}")
    return out


def _xrit2_idct(rng) -> dict:
    """16.6 the 8-bit JPEG decoder's islow IDCT on a segment at a
    full-disk product's size, on the card and on the host: the same
    pixels, each timed (copies included)."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image import jpeg
    from satdump_tpu_torch.image.jpeg12 import compress_jpeg12
    img = sim.smooth_scene(rng, *XRIT2_IDCT_SHAPE, 8)
    data = compress_jpeg12(img, 8, quality_div=4)
    t0 = time.perf_counter()
    hdr = jpeg.parse_jfif_gray(data)
    zz = jpeg.huffman_decode_gray(hdr, data)
    entropy = time.perf_counter() - t0
    out = {"blocks": len(zz), "entropy_ms": entropy * 1e3}
    ref = None
    for dev in ("cuda", "cpu"):
        got = jpeg.idct_islow(zz, hdr["q"], dev)         # warm
        if ref is not None and not np.array_equal(got, ref):
            raise AssertionError("islow IDCT: the card and the host differ")
        ref = got
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(J2K_REPS):
            jpeg.idct_islow(zz, hdr["q"], dev)
        torch.cuda.synchronize()
        out[f"{dev}_ms"] = (time.perf_counter() - t0) / J2K_REPS * 1e3
    log(f"islow IDCT, {len(zz)} blocks ({XRIT2_IDCT_SHAPE[0]} x "
        f"{XRIT2_IDCT_SHAPE[1]}): card {out['cuda_ms']:.3f} ms, host "
        f"{out['cpu_ms']:.3f} ms a call (copies included), pixels equal; "
        f"the host's entropy decoding {out['entropy_ms']:.1f} ms")
    return out


def _xrit2_launches(res: dict, kernel: str) -> dict:
    """{pass: launches of `kernel`} over the xRIT passes of phase 16."""
    return {k: sum(ln.get(kernel, 0) for ln in res[f"{k}_launches"].values())
            for k in ("elektro", "gk2a")}


def phase_xrit_grb(rng, work: Path) -> dict:
    """The xRIT image decoders, GOES-R GRB's products and the port's own
    codecs on the card (phase 16); returns walls, launches and codec
    times."""
    t_phase = time.perf_counter()
    out = {}
    for key, fn in (("elektro", _xrit2_elektro), ("gk2a", _xrit2_gk2a),
                    ("grb", _grb2_pass)):
        res = fn(rng, work)
        out[f"{key}_walls"] = res["walls"]
        out[f"{key}_cpu_walls"] = res["cpu_walls"]
        out[f"{key}_launches"] = _launched(res["launches"])
    out["himawari_s"] = _xrit2_himawari(rng, work)
    out["j2k_ms"] = _j2k_fixtures()
    out["j2k_encoder"] = _j2k_encoder()
    out["idct"] = _xrit2_idct(rng)
    log(f"xRIT / GRB products phase {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 17: the live path (pipeline/live.py, pipeline/multivfo.py, the
# CLI's `live`), on its own generator. 17.1: MetOp AHRPT (its file's 6 Msps,
# QPSK at 2,333,333 sym/s, sps 18/7: K2 then K1), 2^23 samples (32 blocks:
# the stream ends on a block boundary) served unpaced by a RemoteIQServer
# thread at 16 bits, decoded through `live metop_ahrpt tcp://...`, /status
# polled mid-pass, the .soft and .cadu held to run_pipeline's on the same
# samples. 17.2: one RTL-SDR class capture of the 137 MHz band, 2.048 Msps
# centred at 137.5 MHz, 2^25 samples (16.4 s), carrying METEOR-M2-x (OQPSK,
# NRZ-M) at +400 kHz and METEOR-M2 (QPSK) at -400 kHz, Meteor-M.json's
# 137.9 and 137.1 MHz, both 72 ksym/s, through `live --vfo`: the default
# VFO rate (2.4 x 72k) snaps the decimation from 12 to 8, so each VFO runs
# at 256 ksps (sps 3.556; METEOR-M2-x resampled to 168 ksps, sps 2.333),
# both on K2, which is then held to its plain version at each VFO demod's
# shape. 17.3: METEOR-M2 LRPT at its file's 1 Msps carrying NOAA 19's
# predicted Doppler at 137.1 MHz around its highest point, over two block
# seams, corrected by set_doppler on the tracker, on the card and the CPU,
# with a control pass without the correction that must lose CADUs.
LIVE_SEED = SEED + 17
LIVE_METOP_SAMPLES = 1 << 23
LIVE_CHUNK = 1 << 16           # samples a remote-IQ packet
LIVE_BIT_DEPTH = 16
LIVE_PROFILE_BLOCKS = 4        # blocks of a profiled live run
# 2.5 of psk_demod's blocks (6,553,600 samples at METEOR-M2's 1 Msps)
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
VFO_FS = 2.048e6
VFO_SAMPLES = 1 << 25
VFO_BLOCK = 1 << 18
VFO_UP = 8                     # each carrier made at 256 ksps, then x8
VFO_NOISE = 0.02               # the wideband noise floor, each component
VFO_CARRIERS = (("a", 400e3, "meteor_m2x_lrpt", "oqpsk", True),
                ("b", -400e3, "meteor_m2_lrpt", "qpsk", False))
VFO_CPU_BLOCKS = 8
# tests/test_torch_vfo.py's tolerance for the FFT forms (cuFFT against
# pocketfft here, XLA's FFT there)
VFO_ATOL = 2e-5


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_json(argv) -> dict:
    """The port's CLI in this process; its last stdout line as JSON."""
    import io
    from satdump_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _per_block_ms(stats: dict, extra: dict) -> dict:
    """A live run's host seconds by part as ms a block."""
    parts = dict(stats["host_s"], **extra)
    return {k: round(v / stats["blocks"] * 1e3, 3) for k, v in parts.items()}


def _live_metop(rng, work: Path) -> dict:
    """17.1: MetOp AHRPT over the remote-IQ protocol through `live`."""
    import threading
    import urllib.request
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.io import net, write_baseband
    from satdump_tpu_torch.pipeline.live import LivePipeline
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    t0 = time.perf_counter()
    up, down = sim.METOP_SPS
    n_cadus = (LIVE_METOP_SAMPLES - 2048 * up // down) // (8192 * up // down)
    cadus = sim.make_cadus(n_cadus, rng)
    bb = sim.ccsds_qpsk_baseband(cadus, rng, sim.METOP_SPS)
    pad = LIVE_METOP_SAMPLES - len(bb)
    bb = np.concatenate([bb, (0.05 * (rng.standard_normal(pad) + 1j *
                                      rng.standard_normal(pad)))
                         .astype(np.complex64)])
    # the packets, made before the server starts so that its thread only
    # sends bytes; what the client decodes off them is run_pipeline's input
    pkts = [net.encode_iq_pkt(bb[o: o + LIVE_CHUNK], LIVE_BIT_DEPTH)
            for o in range(0, len(bb), LIVE_CHUNK)]
    wire = np.concatenate([net.decode_iq_pkt(pk) for pk in pkts])
    work.mkdir(parents=True, exist_ok=True)
    write_baseband(work / "wire.cf32", "cf32", wire)
    log(f"live MetOp: {n_cadus} CADUs in {len(bb)} samples "
        f"({len(bb) / 6e6:.3f} s of air), {-(-len(bb) // LIVE_CHUNK)} "
        f"packets of {LIVE_CHUNK} samples at {LIVE_BIT_DEPTH} bits, made "
        f"in {time.perf_counter() - t0:.1f} s")

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
        res, wall, launches = _run_counted(lambda: _cli_json([
            "live", "metop_ahrpt", f"tcp://127.0.0.1:{srv.port}",
            str(work / "live"), "--http-port", str(http_port)]),
            "live MetOp")
    finally:
        server.join(timeout=60)
        srv.close()
    if server.is_alive() or not polled.get("samples"):
        raise AssertionError(f"live MetOp: /status not answered mid-pass "
                             f"({polled})")
    soft, cadu = res["outputs"][:2]
    got = _check_cadus(cadu, cadus, "live MetOp (cuda, tcp)")
    stats = res["stats"]
    blocks = stats["blocks"]
    decode_s = stats["source"]["decode_s"]
    host_ms = _per_block_ms(stats, {"decode_iq_pkt": decode_s})
    # the CLI's wall holds the registry load, the modules' set-up, the
    # socket's waits and the mid-pass /status poll besides the pipeline's
    # own time (LivePipeline.push) and the client's packet decode
    push_s = sum(stats["host_s"].values())
    log(f"live MetOp: {len(bb)} samples in {wall:.3f} s = "
        f"{len(bb) / wall / 1e6:.3f} Msamp/s on the card through the CLI "
        f"(live limit 6 Msamp/s); in LivePipeline.push {push_s:.3f} s = "
        f"{len(bb) / push_s / 1e6:.3f} Msamp/s, decode_iq_pkt "
        f"{decode_s:.3f} s, the rest {wall - push_s - decode_s:.3f} s; "
        f"{blocks} blocks; launches {launches} "
        f"({ {k: v / blocks for k, v in launches.items()} } a block); "
        f"/status mid-pass: {polled['samples']} samples, "
        f"{polled['blocks']} blocks; host ms a block {host_ms}")
    # offline on the same samples: the same blocks into stream_work
    torch.cuda.synchronize()
    t = time.perf_counter()
    off = run_pipeline(_pipeline("MetOp.json", "metop_ahrpt"),
                       str(work / "wire.cf32"), str(work / "offline"))
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t
    same = {ext: Path(o).read_bytes() == Path(p).read_bytes()
            for ext, o, p in (("soft", soft, work / "offline" /
                                                 "metop_ahrpt.soft"),
                              ("cadu", cadu, off))}
    log(f"live MetOp against run_pipeline on the card ({off_wall:.3f} s): "
        f"byte-identical {same}")
    if not all(same.values()):
        raise AssertionError(f"live MetOp differs from offline: {same}")
    # the steady state: LIVE_PROFILE_BLOCKS blocks to lock, then as many
    # timed, then as many under the profiler (idle share, launches, copies)
    lp = LivePipeline(_pipeline("MetOp.json", "metop_ahrpt"),
                      str(work / "profiled"))
    lp.start()
    n = LIVE_PROFILE_BLOCKS << 18
    parts = [wire[i * n: (i + 1) * n] for i in range(3)]

    def push(x):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for o in range(0, len(x), LIVE_CHUNK):
            lp.push(x[o: o + LIVE_CHUNK])
        torch.cuda.synchronize()
        return time.perf_counter() - t

    push(parts[0])
    timed = push(parts[1])
    with profiled() as prof:
        pwall = push(parts[2])
    lp.stop()
    prof_res = report_profile(
        f"profile live MetOp ({LIVE_PROFILE_BLOCKS} blocks after "
        f"{2 * LIVE_PROFILE_BLOCKS})", prof, timed, pwall)
    per_block = {k: prof_res[k] / LIVE_PROFILE_BLOCKS
                 for k in ("launches", "copies", "h2d")}
    log(f"live MetOp profiled: idle share {prof_res['idle_share']:.3f}, a "
        f"block {per_block}")
    return {"wall_s": wall, "msamp_s": len(bb) / wall, "blocks": blocks,
            "push_s": push_s, "decode_s": decode_s,
            "cadus": len(got), "launches": launches, "host_ms": host_ms,
            "offline_s": off_wall, "idle_share": prof_res["idle_share"],
            "per_block": per_block}


def _vfo_wideband(rng):
    """The two METEOR carriers of VFO_CARRIERS, each made at 256 ksps
    (sim.ccsds_psk_baseband: RRC 0.5, 18 dB, a carrier offset), then on
    the card interpolated by VFO_UP (zero-stuffed, a 53 dB low-pass),
    mixed to its offset and summed over a noise floor of VFO_NOISE; returns
    (2.048 Msps complex64 samples, {name: CADUs sent})."""
    import torch
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops import fir, firdes
    from satdump_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
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


def _live_vfos(rng, work: Path) -> dict:
    """17.2: two METEOR LRPT VFOs of one 2.048 Msps stream through
    `live --vfo` from a file; the channelizer against the CPU's, its
    device time and copies, the idle share of the two-VFO path, and K2
    against its plain version at each VFO demod's shape."""
    import torch
    from torch.autograd import DeviceType
    from satdump_tpu_torch.io import write_baseband
    from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
    from satdump_tpu_torch.ops.vfo import VFOChannelizer
    from satdump_tpu_torch.pipeline.multivfo import MultiVFOLive
    t0 = time.perf_counter()
    wide, truth = _vfo_wideband(rng)
    work.mkdir(parents=True, exist_ok=True)
    src = work / "wide.cf32"
    write_baseband(src, "cf32", wide)
    log(f"two VFOs: {len(wide)} samples at {VFO_FS / 1e6} Msps "
        f"({len(wide) / VFO_FS:.1f} s), "
        f"{ {k: len(v) for k, v in truth.items()} } CADUs, made in "
        f"{time.perf_counter() - t0:.1f} s")
    res, wall, launches = _run_counted(lambda: _cli_json(
        ["live", "-", f"file://{src}", str(work / "live"),
         "--samplerate", str(VFO_FS)]
        + [a for name, off, pid, _, _ in VFO_CARRIERS
           for a in ("--vfo", f"{name}:{off:.0f}:{pid}")]),
        "live two VFOs")
    # each VFO's launches: its LivePipeline's, counted around its blocks
    path = [k.__name__ for k in _path_kernels()]
    per_vfo = {name: {k: res["stats"][name]["launches"][k] for k in path}
               for name, *_ in VFO_CARRIERS}
    for name, *_ in VFO_CARRIERS:
        if not all(per_vfo[name].values()):
            raise AssertionError(f"VFO {name}: a kernel of the path never "
                                 f"launched: {per_vfo[name]}")
        cadu = [o for o in res["outputs"][name] if o.endswith(".cadu")][0]
        _check_cadus(cadu, truth[name], f"live VFO {name} (cuda)")
    host_ms = {name: _per_block_ms(res["stats"][name], {})
               for name, *_ in VFO_CARRIERS}
    chan_ms = res["channelizer"]["host_s"] / res["channelizer"]["blocks"] \
        * 1e3
    log(f"live two VFOs: {len(wide)} samples in {wall:.3f} s = "
        f"{len(wide) / wall / 1e6:.3f} Msamp/s on the card (live limit "
        f"{VFO_FS / 1e6} Msamp/s); channelizer {res['channelizer']['blocks']}"
        f" blocks, {chan_ms:.3f} host ms a block; launches {per_vfo}; each "
        f"VFO's host ms a demod block {host_ms}")
    # the channelizer on the card against the CPU, block by block
    chans = {d: VFOChannelizer(VFO_FS, VFO_BLOCK, device=d)
             for d in ("cuda", "cpu")}
    for c in chans.values():
        for name, off, *_ in VFO_CARRIERS:
            c.add_vfo(name, off, 2.4 * 72e3)
    err = 0.0
    for b in range(VFO_CPU_BLOCKS):
        x = wide[b * VFO_BLOCK: (b + 1) * VFO_BLOCK]
        got, ref = chans["cuda"].work(x), chans["cpu"].work(x)
        err = max(err, max(float(np.abs(got[n] - ref[n]).max())
                           for n in got))
    log(f"channelizer: {VFO_CPU_BLOCKS} blocks of {VFO_BLOCK}, decim "
        f"{chans['cuda'].vfos['a'].decim}, card against CPU max |diff| "
        f"{err:.3g} (tolerance {VFO_ATOL})")
    if err > VFO_ATOL:
        raise AssertionError(f"channelizer card and CPU differ by {err}")
    # its device time and copies a block
    x = wide[:VFO_BLOCK]
    chans["cuda"].work(x)
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(VFO_CPU_BLOCKS):
            chans["cuda"].work(x)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        raise AssertionError("channelizer: the profiler saw no device work")
    chan = {"device_ms": sum(e.time_range.elapsed_us() for e in ev)
            / VFO_CPU_BLOCKS / 1e3,
            "h2d": sum("HtoD" in e.name for e in ev) / VFO_CPU_BLOCKS,
            "d2h": sum("DtoH" in e.name for e in ev) / VFO_CPU_BLOCKS,
            "kernels": sum("Memcpy" not in e.name for e in ev)
            / VFO_CPU_BLOCKS}
    log(f"channelizer a block on the card: {chan}")
    # the two-VFO path's steady state: VFO_CPU_BLOCKS channelizer blocks
    # (one demod block a VFO) to lock, as many timed, as many profiled
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    pipes = parse_pipeline_file(ROOT / "resources" / "pipelines" /
                                "Meteor-M.json")
    mv = MultiVFOLive(VFO_FS, str(work / "profiled"))
    for name, off, pid, _, _ in VFO_CARRIERS:
        mv.add_vfo(name, off, pipes[pid])
    n = VFO_CPU_BLOCKS * VFO_BLOCK

    def push(x):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mv.push(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    push(wide[:n])
    timed = push(wide[n: 2 * n])
    with profiled() as prof:
        pwall = push(wide[2 * n: 3 * n])
    mv.stop()
    prof_res = report_profile(
        f"profile two-VFO live ({VFO_CPU_BLOCKS} channelizer blocks after "
        f"{2 * VFO_CPU_BLOCKS})", prof, timed, pwall)
    # K2 against its plain version at each VFO demod's own shape: its
    # block after the input resampler with 7 samples of history, its sps
    # and out_cap
    bank = torch.as_tensor(mm_interpolator_bank()).cuda()
    k2_err = 0.0
    for name, _, pid, *_ in VFO_CARRIERS:
        d = mv.pipes[name].modules[0]
        for skew in (0.0, 0.005):
            k2_err = max(k2_err, _k2_case(
                rng, f"VFO {name} {pid}: n_ext {d._out_n + 7}, sps "
                f"{d.final_sps:.4f}, skew {skew}", d._out_n + 7,
                d.final_sps, skew, d._ff_cap, bank)[0])
    return {"wall_s": wall, "msamp_s": len(wide) / wall,
            "launches": per_vfo, "channelizer_host_ms": chan_ms,
            "channelizer": chan, "cpu_max_err": err, "k2_max_abs_err": k2_err,
            "host_ms": host_ms, "idle_share": prof_res["idle_share"],
            "copies_a_block": prof_res["copies"] / VFO_CPU_BLOCKS,
            "launches_a_block": prof_res["launches"] / VFO_CPU_BLOCKS}


def _cadu_count(out: str, cadus: np.ndarray) -> tuple:
    """(CADUs decoded that were sent, CADUs decoded that were not)."""
    got = np.fromfile(out, dtype=np.uint8).reshape(-1, cadus.shape[1])
    sent = {c.tobytes() for c in cadus}
    good = sum(g.tobytes() in sent for g in got)
    return good, len(got) - good


def _live_doppler(rng, work: Path) -> dict:
    """17.3: METEOR-M2 LRPT at 1 Msps carrying NOAA 19's predicted Doppler
    at 137.1 MHz over LIVE_DOP_SAMPLES centred on its highest point over
    LIVE_QTH (where the Doppler slews at ~21 Hz/s), so the pass crosses two
    of psk_demod's block seams. A live pass with set_doppler on the tracker
    on the card and the CPU: every CADU, the same .cadu, and the provider
    asked at each block's absolute position for the Doppler put on the
    signal. A control pass on the card without set_doppler must lose
    CADUs."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.geo import TLE
    from satdump_tpu_torch.pipeline.live import LivePipeline
    from satdump_tpu_torch.tracking import ObjectTracker
    t_make = time.perf_counter()
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
    log(f"live Doppler: {n_cadus} CADUs in {len(bb)} samples at 1 Msps, "
        f"{dop[0]:.1f} to {dop[-1]:.1f} Hz, made in "
        f"{time.perf_counter() - t_make:.1f} s")

    def run(dev, doppler=True):
        lp = LivePipeline(_pipeline("Meteor-M.json", "meteor_m2_lrpt"),
                          str(work / f"{dev}_{doppler}"),
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
    (out, block, asked), wall, launches = _run_counted(
        lambda: run("cuda"), "live Doppler")
    # the provider: one call a block at its absolute sample position,
    # giving the Doppler that was put on the signal there
    want = [(i * block, block) for i in range(-(-len(bb) // block))]
    if [a[:2] for a in asked] != want:
        raise AssertionError(f"live Doppler: provider asked at "
                             f"{[a[:2] for a in asked]}, not {want}")
    dop_err = max(float(np.abs(d - truth(pos, n)).max())
                  for pos, n, d in asked)
    if dop_err > 0.01:
        raise AssertionError(f"live Doppler: the provider's Doppler is "
                             f"{dop_err} Hz off the signal's")
    t = time.perf_counter()
    cpu_out = run("cpu")[0]
    cpu_wall = time.perf_counter() - t
    got = {d: _check_cadus(o, cadus, f"live Doppler ({d}, {len(bb)} "
                                     f"samples)")
           for d, o in (("cuda", out), ("cpu", cpu_out))}
    if not np.array_equal(got["cuda"], got["cpu"]):
        raise AssertionError("live Doppler: .cadu differs between devices")
    # the control: the same pass on the card without set_doppler
    t = time.perf_counter()
    good, bad = _cadu_count(run("cuda", doppler=False)[0], cadus)
    ctl_wall = time.perf_counter() - t
    log(f"live Doppler control without set_doppler: {good} of {n_cadus} "
        f"CADUs decoded, {bad} not sent, {ctl_wall:.3f} s")
    if good >= n_cadus - 2 and not bad:
        raise AssertionError("live Doppler: the pass decodes without "
                             "set_doppler, so it does not test it")
    log(f"live Doppler (METEOR-M2 1 Msps, NOAA 19 at 137.1 MHz, "
        f"{dop.min():.1f} to {dop.max():.1f} Hz, {len(asked)} blocks of "
        f"{block}): card {wall:.3f} s, CPU {cpu_wall:.3f} s; .cadu "
        f"byte-identical cuda vs cpu; provider within {dop_err:.2g} Hz of "
        f"the signal's Doppler; launches {launches}")
    return {"wall_s": wall, "cpu_s": cpu_wall, "launches": launches,
            "doppler_hz": [float(dop.min()), float(dop.max())],
            "blocks": len(asked), "control_cadus": [good, bad]}


def _live_launches(live: dict, kernel: str) -> dict:
    """A kernel's launches on each live path of phase 17."""
    return {"metop": live["metop"]["launches"][kernel],
            **{f"vfo_{n}": c[kernel]
               for n, c in live["vfo"]["launches"].items()},
            "doppler": live["doppler"]["launches"][kernel]}


def phase_live(rng, work: Path) -> dict:
    """The live path on the card (phase 17); returns its figures."""
    t_phase = time.perf_counter()
    out = {"metop": _live_metop(rng, work / "metop"),
           "vfo": _live_vfos(rng, work / "vfo"),
           "doppler": _live_doppler(rng, work / "doppler")}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"live phase {out['phase_s']:.1f} s")
    return out


GEO_SEED = SEED + 18
GEO_AVHRR_LINES, GEO_MHS_LINES = 1800, 112    # phase 8's 5-minute pass
GEO_CHANNELS = ("1", "2", "4")                 # the warped RGB's channels
GEO_OUT_WIDTH = 2048
GEO_SMART_WIDTH, GEO_SMART_TILE = 8192, 1024
GEO_CPU_WIDTH = 512           # the whole warp on both devices at this width
GEO_SMART_CPU = (2048, 512)   # the smart warp on both: width, tile
GEO_BAND_ROWS = 64            # rows of the full-width warp the CPU repeats
GEO_COORD_TOL = 1e-6          # px, card against CPU (float64 both)
GEO_PIXEL_SHARE = 1e-4        # of the pixels, each at most 1 LSB apart
GEO_GCP_TOL = 1e-2            # px, the spline at its own GCPs (reg 1e-6)
H100_F64_FLOPS = 34e12        # float64 outside the tensor cores, data sheet
# float64 operations a spline entry (point, GCP), the log counted as one:
# two differences, two squares, a sum, a clamp, the log, two products, and
# U @ w's two multiply-adds
SPLINE_OPS = 11
ING_NAT_LINES = 464           # of 3,712 VIS/IR lines (HRV 1,392 of 11,136)
ING_HSD_SEG_LINES, ING_HSD_SEGS = 550, 2     # of band 13's 10 segments


@contextlib.contextmanager
def _spline_calls():
    """Every device evaluation of a ThinPlateSpline in the block: its
    CUDA-event ms, points, GCPs and output coordinates."""
    from satdump_tpu_torch.geo import warp
    calls = []
    orig = warp.ThinPlateSpline._eval_torch

    def rec(self, flat, band=None):
        out = orig(self, flat, band)
        calls.append({"ms": self.device_ms, "points": flat.shape[0],
                      "gcps": self.src.shape[0], "xy": out})
        return out
    warp.ThinPlateSpline._eval_torch = rec
    try:
        yield calls
    finally:
        warp.ThinPlateSpline._eval_torch = orig


def _spline_bound(points: int, gcps: int, entries: int):
    """The least time of a spline evaluation on the card: its points in
    and coordinates out (float64 pairs) over the memory rate, or its
    entries' operations at half the float64 flop rate (operations that
    are not FMAs issue at half of it)."""
    return bound_ms(2 * points * 16 + gcps * 40, entries * SPLINE_OPS,
                    H100_F64_FLOPS / 2)


def _geo_close(a, b, what: str) -> int:
    """Card against CPU: at most GEO_PIXEL_SHARE of the pixels differ,
    each by at most 1 LSB (or across the image's edge)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape} {a.dtype} against "
                             f"{b.shape} {b.dtype}")
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    n = int((d > 0).sum())
    log(f"{what}: card against CPU {n} of {d.size} pixels differ, max "
        f"{int(d.max())} LSB; tolerance {GEO_PIXEL_SHARE:g} of the pixels")
    if n > max(1, GEO_PIXEL_SHARE * d.size):
        raise AssertionError(f"{what}: {n} pixels differ")
    return n


def _geo_pass(rng, work: Path):
    """The AVHRR/3 product of a 1,800-line pass (as phase 8 makes it), its
    proj cfg, an (H, W, 3) uint16 image of GEO_CHANNELS and a MetOp-B TLE
    whose epoch is an hour before the pass."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.geo.tle import TLE
    from satdump_tpu_torch.models.metop import MetOpInstrumentsDecoderModule
    from satdump_tpu_torch.products.product import load_product
    t0 = time.perf_counter()
    cadus, truth = sim.metop_instrument_cadus(rng, GEO_AVHRR_LINES,
                                              GEO_MHS_LINES)
    work.mkdir(parents=True, exist_ok=True)
    cadus.tofile(work / "pass.cadu")
    MetOpInstrumentsDecoderModule(str(work / "pass.cadu"),
                                  str(work / "metop_ahrpt"), {}).process()
    prod = load_product(str(work / "AVHRR" / "product.json"))
    cfg = prod.get_proj_cfg()
    ts = np.asarray(cfg["timestamps"])
    tle = TLE.parse("METOP-B", *sim.metop_b_tle(
        float(np.median(ts[ts > 0])) - 3600.0))
    img = np.stack([prod.get_channel(c).image for c in GEO_CHANNELS], -1)
    log(f"projection: {GEO_AVHRR_LINES}-line AVHRR/3 product made in "
        f"{time.perf_counter() - t0:.2f} s (host); image {img.shape} "
        f"{img.dtype}; {len(ts)} timestamps")
    return cfg, tle, img


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


def _float32_form(tps, flat, ref) -> dict:
    """The JAX package's float32 device form of the spline on the card
    (|q|^2 - 2 q.src^T + |src|^2, clamped; U @ w), against the port's
    float64 evaluation `ref`, under full-precision float32 matmuls and
    under TF32."""
    import torch
    from satdump_tpu_torch.utils.device import full_precision_matmul
    f32 = {n: torch.tensor(v, dtype=torch.float32, device="cuda")
           for n, v in (("q", flat), ("src", tps.src), ("w", tps.w),
                        ("a", tps.a))}

    def run():
        q, src, w, a = f32["q"], f32["src"], f32["w"], f32["a"]
        d2 = (torch.sum(q * q, -1, keepdim=True) - (2.0 * q) @ src.T
              + torch.sum(src * src, -1)[None, :])
        u = 0.5 * d2 * torch.log(torch.clamp(d2, min=1e-20))
        out = u @ w + a[0] + q[:, :1] * a[1] + q[:, 1:2] * a[2]
        return float(np.abs(out.double().cpu().numpy() - ref).max())
    res = {}
    with full_precision_matmul():
        res["highest"] = run()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        res["tf32"] = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"projection: the float32 form (the JAX package's) on the card over "
        f"{len(flat)} points: max |error| {res['highest']:.3f} px at float32 "
        f"matmul precision 'highest', {res['tf32']:.3f} px with TF32; the "
        f"port evaluates in float64 (default precision here: TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 "
        f"{torch.get_float32_matmul_precision()})")
    return res


def _geo_overlays(img, georef, work: Path) -> dict:
    """A grid, a GeoJSON map the phase writes and city labels on the
    warped image, then its GeoTIFF and a read-back of the tags."""
    from satdump_tpu_torch.geo.shapefile import read_geojson
    from satdump_tpu_torch.image import geotiff, overlay, text
    t0 = time.perf_counter()
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
    white = (65535, 65535, 65535)
    overlay.draw_latlon_grid(out, to_xy, (0, 65535, 0), spacing_deg=5.0)
    overlay.draw_map_overlay(out, to_xy, str(gj), white, thickness=2)
    cities = np.array([[wrap(lon0 + (lon1 - lon0) * u),
                        lat0 + (lat1 - lat0) * v]
                       for u, v in ((0.5, 0.5), (0.3, 0.7), (0.7, 0.2))])
    out = text.draw_city_labels(out, to_xy, cities, ["Alpha", "Beta", "Gamma"],
                                (255, 255, 0))
    inked = int(np.any(out != img, axis=-1).sum())
    if inked < 1000 or len(read_geojson(gj)) != 5:
        raise AssertionError(f"overlays inked {inked} pixels")
    w, h = out.shape[1], out.shape[0]
    tif = work / "pass.tif"
    geotiff.save_geotiff(out, tif, lon0, lat1, (lon1 - lon0) / (w - 1),
                         (lat1 - lat0) / (h - 1))
    tags = geotiff.read_geotiff_tags(tif)
    data = tif.read_bytes()
    ok = (tags["width"] == w and tags["height"] == h
          and tags["lon_min"] == lon0 and tags["lat_max"] == lat1
          and tags["geo_keys"] == {1024: 2, 1025: 1, 2048: 4326}
          and data[-out.nbytes:] == out.astype("<u2").tobytes())
    log(f"projection: overlays (grid, {len(feats)} GeoJSON features, "
        f"{len(cities)} labels) inked {inked} pixels; GeoTIFF "
        f"{len(data) / 1e6:.1f} MB, tags {tags}: read back "
        f"{'equal' if ok else 'WRONG'}; {time.perf_counter() - t0:.2f} s")
    if not ok:
        raise AssertionError("GeoTIFF tags or strip read back wrong")
    return {"inked": inked, "tif_bytes": len(data)}


def _geo_projection(rng, work: Path) -> dict:
    """Phase 18.1: GCPs, both warps on the card (against the CPU),
    reprojection to a stereographic and a geostationary target, overlays,
    labels and the GeoTIFF."""
    import torch
    from satdump_tpu_torch.geo import projs, raytrace, reproject, warp
    cfg, tle, img = _geo_pass(rng, work)
    res = {}
    t = time.perf_counter()
    gcps = raytrace.compute_gcps(cfg, img.shape[1], img.shape[0], tle=tle)
    res["gcps_s"] = time.perf_counter() - t
    lat = gcps[:, 3]
    log(f"projection: compute_gcps (host) {res['gcps_s']:.3f} s, "
        f"{len(gcps)} GCPs, lat {lat.min():.2f}..{lat.max():.2f}, lon "
        f"{gcps[:, 2].min():.2f}..{gcps[:, 2].max():.2f}")
    if len(gcps) < 900:
        raise AssertionError(f"only {len(gcps)} GCPs")
    # twice: the first call also pays the float64 matmul's and the
    # allocator's first use
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _spline_calls() as calls:
        for _ in range(2):
            t = time.perf_counter()
            full, georef = warp.warp_to_equirect(img, gcps, GEO_OUT_WIDTH,
                                                 device="cuda")
            walls.append(time.perf_counter() - t)
    call = calls[1]
    bound, by = _spline_bound(call["points"], call["gcps"],
                              call["points"] * call["gcps"])
    res["warp"] = {"wall_s": walls[1], "first_wall_s": walls[0],
                   "spline_ms": call["ms"], "first_spline_ms": calls[0]["ms"],
                   "spline_bound_ms": bound, "bound_by": by,
                   "points": call["points"], "gcps": call["gcps"],
                   "entries": call["points"] * call["gcps"],
                   "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                   "shape": list(full.shape)}
    log(f"projection: warp_to_equirect at {GEO_OUT_WIDTH} on cuda: "
        f"{json.dumps(res['warp'])}")
    # a band of the full-width warp's rows on the CPU, then the whole warp
    # on both devices at GEO_CPU_WIDTH
    hout = georef["height"]
    rows = slice(hout // 2, hout // 2 + GEO_BAND_ROWS)
    glon = np.linspace(georef["lon_min"], georef["lon_max"], GEO_OUT_WIDTH)
    glat = np.linspace(georef["lat_max"], georef["lat_min"], hout)[rows]
    band = np.stack(np.meshgrid(glon, glat), -1).reshape(-1, 2)
    lon = gcps[:, 2]
    if lon.max() - lon.min() > 180.0:
        lon = np.mod(lon + 360.0, 360.0)
    tps = warp.ThinPlateSpline(np.stack([lon, gcps[:, 3]], -1), gcps[:, :2],
                               reg=1e-6, device="cpu")
    t = time.perf_counter()
    xy_cpu = tps._eval_torch(band)
    cpu_band_s = time.perf_counter() - t
    xy_card = call["xy"].reshape(hout, GEO_OUT_WIDTH, 2)[rows].reshape(-1, 2)
    coord_err = float(np.abs(xy_cpu - xy_card).max())
    px_cpu = reproject.bilinear_sample(img, xy_cpu[:, 0].reshape(-1,
                                       GEO_OUT_WIDTH), xy_cpu[:, 1].reshape(
                                       -1, GEO_OUT_WIDTH))
    res["band"] = {"rows": GEO_BAND_ROWS, "coord_err_px": coord_err,
                   "cpu_s": cpu_band_s,
                   "differ": _geo_close(full[rows], px_cpu,
                                        f"warp rows {rows.start}+"
                                        f"{GEO_BAND_ROWS} at "
                                        f"{GEO_OUT_WIDTH}")}
    log(f"projection: the same rows' spline on the CPU {cpu_band_s:.3f} s; "
        f"coordinates card against CPU max |diff| {coord_err:.3g} px "
        f"(tolerance {GEO_COORD_TOL:g})")
    if not coord_err <= GEO_COORD_TOL:
        raise AssertionError(f"warp coordinates differ by {coord_err} px")
    # the spline on the card passes through its GCPs (reg 1e-6)
    fit = warp.ThinPlateSpline(tps.src, gcps[:, :2], reg=1e-6,
                               device="cuda")._eval_torch(tps.src)
    res["gcp_residual_px"] = float(np.abs(fit - gcps[:, :2]).max())
    log(f"projection: the card's spline at its {len(gcps)} GCPs: max "
        f"|residual| {res['gcp_residual_px']:.3g} px (limit {GEO_GCP_TOL})")
    if not res["gcp_residual_px"] <= GEO_GCP_TOL:
        raise AssertionError("the warp's spline misses its GCPs")
    res["float32_form"] = _float32_form(tps, band, xy_card)
    small = {}
    for d in ("cuda", "cpu"):
        t = time.perf_counter()
        small[d] = warp.warp_to_equirect(img, gcps, GEO_CPU_WIDTH, device=d)
        torch.cuda.synchronize()
        res[f"warp_{GEO_CPU_WIDTH}_{d}_s"] = time.perf_counter() - t
    if small["cuda"][1] != small["cpu"][1]:
        raise AssertionError("warp georefs differ")
    res[f"warp_{GEO_CPU_WIDTH}_differ"] = _geo_close(
        small["cuda"][0], small["cpu"][0], f"warp at {GEO_CPU_WIDTH}")
    # the smart warp: tiles of local splines; one channel
    ch = np.ascontiguousarray(img[..., 2])
    with _spline_calls() as calls:
        t = time.perf_counter()
        smart, sgeo = warp.smart_warp_to_equirect(
            ch, gcps, GEO_SMART_WIDTH, tile=GEO_SMART_TILE, device="cuda")
        wall = time.perf_counter() - t
    bounds = [_spline_bound(c["points"], c["gcps"], c["points"] * c["gcps"])
              for c in calls]
    res["smart"] = {"wall_s": wall, "tiles": len(calls),
                    "spline_ms": sum(c["ms"] for c in calls),
                    "spline_bound_ms": sum(b for b, _ in bounds),
                    "entries": sum(c["points"] * c["gcps"] for c in calls),
                    "shape": list(smart.shape),
                    "filled": float((smart > 0).mean())}
    log(f"projection: smart_warp_to_equirect at {GEO_SMART_WIDTH}, tile "
        f"{GEO_SMART_TILE} on cuda: {json.dumps(res['smart'])}")
    sw, st = GEO_SMART_CPU
    pair = [warp.smart_warp_to_equirect(ch, gcps, sw, tile=st, device=d)
            for d in ("cuda", "cpu")]
    if pair[0][1] != pair[1][1]:
        raise AssertionError("smart warp georefs differ")
    res["smart_small_differ"] = _geo_close(pair[0][0], pair[1][0],
                                           f"smart warp at {sw}, tile {st}")
    # reprojection to a stereographic and a geostationary target
    clon = float(np.median(gcps[:, 2]))
    for name, tgt in (("stereo", {"type": "stereo", "lon0": clon,
                                  "lat0": 90.0 if lat.mean() > 0 else -90.0}),
                      ("geos", {"type": "geos", "lon0": round(clon)})):
        t = time.perf_counter()
        out, tg = reproject.reproject_equirect(full, georef, tgt, 2048)
        res[f"reproject_{name}"] = {
            "s": time.perf_counter() - t, "shape": list(out.shape),
            "filled": float((out.max(-1) > 0).mean())}
        x, y = projs.forward(tgt, gcps[:, 2], gcps[:, 3])
        if not (np.isfinite(x).all() and res[f"reproject_{name}"]["filled"]
                > 0.05):
            raise AssertionError(f"reprojection to {name} came out empty")
        log(f"projection: reproject_equirect to {name} (host): "
            f"{json.dumps(res[f'reproject_{name}'])}")
    res.update(_geo_overlays(full, georef, work))
    return res


def _ingest_files(rng, work: Path) -> list:
    """A SEVIRI .nat and two band-13 HSD segments, by the port's writers."""
    from satdump_tpu_torch import sim
    work.mkdir(parents=True, exist_ok=True)
    raw, _ = sim.seviri_nat(rng, ING_NAT_LINES)
    nat = work / "MSG4-SEVI-MSG15-0100-NA-20240101121243.nat"
    nat.write_bytes(raw)
    files, _ = sim.ahi_hsd_segments(rng, ING_HSD_SEG_LINES, ING_HSD_SEGS)
    paths = [nat]
    for i, f in enumerate(files, 1):
        paths.append(work / f"HS_H09_20240101_1200_B13_FLDK_R20_S{i:02d}"
                     f"{ING_HSD_SEGS:02d}.DAT.bz2")
        paths[-1].write_bytes(f)
    log(f"ingest: SEVIRI .nat {len(raw) / 1e6:.1f} MB ({ING_NAT_LINES} "
        f"lines of {sim.SEVIRI_COLUMNS} columns, 12 channels with HRV), HSD "
        f"band 13 {ING_HSD_SEGS} x {ING_HSD_SEG_LINES} lines of 5500 "
        f"columns ({sum(len(f) for f in files) / 1e6:.1f} MB bzip2)")
    return paths


def _ingest(rng, work: Path) -> dict:
    """Phase 18.2: `ingest --process` through the CLI on the card and on
    the CPU; products and composites equal."""
    from satdump_tpu_torch.image.io import load_img
    paths = _ingest_files(rng, work / "in")
    res = {}
    for d in ("cuda", "cpu"):
        res[d] = _cli_json(["ingest", *map(str, paths), "-o",
                            str(work / d), "--process", "--torch_device", d])
        log(f"ingest --process on {d}: {json.dumps(res[d])}")
    tree = {d: sorted(p.relative_to(work / d) for p in (work / d).rglob("*")
                      if p.is_file() and p.name != ".preset_cache.json")
            for d in ("cuda", "cpu")}
    if tree["cuda"] != tree["cpu"] or res["cuda"]["composites"] < 3:
        raise AssertionError(f"ingest outputs differ: {tree}")
    differ = [str(r) for r in tree["cuda"]
              if (r.suffix == ".png"
                  and not _same_images(load_img(work / "cuda" / r),
                                       load_img(work / "cpu" / r)))
              or (r.suffix != ".png" and (work / "cuda" / r).read_bytes()
                  != (work / "cpu" / r).read_bytes())]
    log(f"ingest: {len(tree['cuda'])} files on each device, "
        f"{res['cuda']['composites']} composites; differing: {differ}")
    if differ:
        raise AssertionError(f"ingest card and CPU differ: {differ}")
    return res


def _bitview(rng, main_cadu: Path, work: Path) -> dict:
    """Phase 18.3: `bitview` through the CLI on the main path's .cadu, its
    period found and given (each row then starts with the ASM), and found
    on CADUs whose payload has no structure of its own."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.image.io import load_img
    work.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, src, opts in (("found", main_cadu, []),
                            ("given", main_cadu, ["--period", "8192"]),
                            ("random", work / "random.cadu", [])):
        if name == "random":
            sim.make_cadus(400, rng).tofile(src)
        png = work / f"{name}.png"
        t = time.perf_counter()
        info = _cli_json(["bitview", str(src), "-o", str(png), *opts])
        raster = load_img(png)
        res[name] = {"s": time.perf_counter() - t, "shape": list(raster.shape),
                     "period": info["period"],
                     "candidates": info["candidates"]}
        log(f"bitview {name} on {src.name}: {json.dumps(res[name])}")
        if raster.shape != (min(info["bits"] // info["period"], 4096),
                            info["period"]):
            raise AssertionError(f"bitview {name}: raster {raster.shape}")
    asm = np.unpackbits(np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8)) * 255
    raster = load_img(work / "given.png")
    if not (raster[:, :32] == asm).all():
        raise AssertionError("bitview at 8192: rows do not start with the ASM")
    if res["random"]["period"] != 8192:
        raise AssertionError(f"bitview period {res['random']['period']} on "
                             "random CADUs")
    return res


def phase_geo_ingest(rng, work: Path, main_cadu: Path) -> dict:
    """Projection, ingest and bitview on the card (phase 18)."""
    t_phase = time.perf_counter()
    out = {"projection": _geo_projection(rng, work / "geo"),
           "ingest": _ingest(rng, work / "ingest"),
           "bitview": _bitview(rng, main_cadu, work / "bitview")}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"projection / ingest phase {out['phase_s']:.1f} s")
    return out


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


# phase 19: the scale-out and the bench, on its own generator. MetOp
# AHRPT's main-path signal (phase 6's ~2^23 samples at 6 Msps, sps 18/7)
# through psk_demod `multichip: true` on MC_RANKS ranks sharing the card
# (parallel/timeshard.py: one process a rank, gloo between them), then
# metop_ahrpt_decoder; K3 (the block Viterbi, csrc/viterbi_block.cu)
# against its plain version on that pass's softs at its callers' shapes;
# dryrun_multichip on the card; `bench` on the card.
MC_SEED = SEED + 19
MC_RANKS = 4
MC_DRYRUN_RANKS = 8
MC_SOFT_LSB = 5          # the dryrun step's int8 softs, card against CPU
VB_B, VB_T = 4, 1 << 15
VB_CHUNKS = 1024   # the lcm of K3's ACS (256) and traceback (1024) chunks
VB_TILED = (8, 1024 + 2 * 128)  # the tiled decoder's lanes (renorm off)
VB_LOCK = (1024, 1023)   # a lock search's batch: max_lanes x (TEST_BITS-2)/2
VB_AERO = (1, 2496)      # an Aero 10.5k frame
VB_REPS = 10
# the reference's bench categories (satdump_tpu/bench.py)
BENCH_CATEGORIES = ("freq_shift", "agc", "rrc", "quadrature_demod", "snr_est",
                    "ff_cfo", "ff_timing", "ff_qpsk_full", "viterbi_k7",
                    "rs_decode", "soft_to_cadu")


def _vb_kernels():
    from satdump_tpu_torch.ops.cuda.viterbi_block import (
        viterbi_block_acs, viterbi_block_traceback)
    return (viterbi_block_acs, viterbi_block_traceback)


def _vb_decode(pm, x, renorm: bool = True):
    """K3: the ACS pass, then the traceback."""
    acs, tb = _vb_kernels()
    pm, dec = acs(pm, x, renorm)
    return pm, dec, tb(pm, dec)


def _vb_plain(pm, x, renorm: bool = True):
    from satdump_tpu_torch.ops.fec import convolutional as cc
    pm, dec = cc._acs_plain(pm, x, renorm)
    return pm, dec, cc._traceback_plain(pm, dec)


def _vb_bound(B: int, T: int):
    """The least time of a block decode: its bytes (the softs and pm in,
    the bits and pm out) and its operations a step and row: the 4 distinct
    branch metrics (2 subtractions, 2 absolute values, an add each), 2 adds,
    a compare and a select for each of the 64 states, the renormalisation's
    63 for the min and 64 subtractions, the traceback's 4."""
    nbytes = B * T * (8 + 1) + 2 * B * 64 * 4
    ops = B * T * (4 * 5 + 64 * 4 + 63 + 64 + 4)
    return bound_ms(nbytes, ops, H100_F32_OPS)


def _vb_sass() -> dict:
    """K3's loop-carried chains read off its SASS (tools/sass_chain.py):
    the ACS step loop (a step is its one 8-byte decision store to shared
    memory) and the traceback's (a step is its one byte store); no FFMA
    anywhere in it."""
    from satdump_tpu_torch.tools import sass_chain as sc
    funcs = sc.parse_sass(_sass("viterbi_block"))
    measured, _ = sc.measured_latencies()
    lat = sc.Latency(sc.fixed_latencies(funcs), measured)
    out = {}
    for key, fname, store in (("acs", "viterbi_acs_kernel", "STS.64"),
                              ("traceback", "viterbi_traceback_kernel",
                               "STS.U8")):
        f = next(f for f in funcs if fname in f.name)
        ffma = sum(x.mnemonic == "FFMA" for x in f.ins)
        if ffma:
            raise AssertionError(f"K3 {fname}: {ffma} FFMA in its SASS")
        loops = sc.step_loops(f, store)
        if not loops:
            raise AssertionError(f"K3 {fname}: no step loop")
        loop = max(loops, key=lambda lp: sum(
            x.op == store for x in f.ins[lp[0]:lp[1] + 1]))
        r = sc.chain(f, lat, loop=loop, step_store=store)
        log(f"K3 SASS chain, {key}: {r['cycles_a_step']:.2f} cycles a step "
            f"({r['instructions_a_pass']} instructions a pass of "
            f"{r['steps_a_pass']:g} steps); stall counts "
            f"{r['stall_cycles_a_step']:.1f} a step; chain opcodes "
            f"{json.dumps(r['chain_opcodes'])}; at the smallest latency "
            f"{json.dumps(r['unmeasured'])}")
        out[key] = r
    return out


def _mc_pass(work: Path, main_input: Path, main_cadu: Path,
             cadus: np.ndarray) -> dict:
    """19.1: the full-width sharded MetOp pass, stage by stage, with every
    kernel's count set to 0 just before each stage and read just after
    (the ranks report their own: K2 and K3 launch there; the decoder's K1
    and its lock search's K3 in this process)."""
    from satdump_tpu_torch.parallel import timeshard
    fname, pipe_id, _, _ = METOP
    kernels = _path_kernels() + _vb_kernels()
    timeshard.set_virtual_devices(MC_RANKS)
    try:
        outs, walls, launches = _staged(
            fname, pipe_id, main_input, work, {"multichip": True},
            ("baseband", "soft", "cadu"), kernels=kernels)
    finally:
        timeshard.set_virtual_devices(None)
    st = timeshard.run_sharded.last_stats
    if st is None or st["ranks"] != MC_RANKS or st["device"] != "cuda":
        raise AssertionError(f"sharded pass: no {MC_RANKS}-rank card run: "
                             f"{st}")
    ranks = {k: sum(r["launches"][k] for r in st["rank"])
             for k in st["rank"][0]["launches"]}
    _need(ranks, list(ranks), "sharded pass, ranks")
    _need(launches["cadu"], ("viterbi_re", "viterbi_block_acs",
                             "viterbi_block_traceback"), "sharded decoder")
    got = _check_cadus(outs["cadu"], cadus, "sharded MetOp pass")
    single = np.fromfile(main_cadu, np.uint8).reshape(-1, cadus.shape[1])
    if Path(outs["cadu"]).read_bytes() != Path(main_cadu).read_bytes():
        raise AssertionError(f"sharded .cadu ({len(got)} CADUs) differs "
                             f"from the single-device one ({len(single)})")
    n = Path(main_input).stat().st_size // 8
    wall = walls["soft"] + walls["cadu"]
    rank_setup = max(r["setup_s"] for r in st["rank"])
    rank_step = max(r["step_s"] for r in st["rank"])
    log(f"sharded MetOp pass, {MC_RANKS} ranks on the card over "
        f"{st['backend']} ({n} samples): .cadu byte-equal to the "
        f"single-device one, {len(got)} CADUs; psk_demod {walls['soft']:.3f}"
        f" s (spawn to exit {st['spawn_to_exit_s']:.3f}, the slowest rank's "
        f"set-up {rank_setup:.3f} and step {rank_step:.3f}), decoder "
        f"{walls['cadu']:.3f} s; {n / wall / 1e6:.3f} Msamp/s baseband to "
        f"CADU; {st['bytes_moved']} bytes through the host; launches: ranks "
        f"{ranks}, decoder {_launched(launches)['cadu']}")
    # a shard's Viterbi steps: psk_demod's block rule, the step's capacity
    block = -(-(n + 64) // (MC_RANKS * 4096)) * 4096
    shard_pairs = int(np.ceil(block / (METOP_SPS * 0.99))) + 4 - 8
    return {"soft": outs["soft"], "samples": n, "wall_s": wall,
            "soft_s": walls["soft"], "cadu_s": walls["cadu"],
            "spawn_to_exit_s": st["spawn_to_exit_s"],
            "rank_setup_s": rank_setup, "rank_step_s": rank_step,
            "msamp_s": n / wall / 1e6, "bytes_moved": st["bytes_moved"],
            "rank_launches": ranks, "decoder_launches": launches["cadu"],
            "cadus": len(got), "shard_pairs": shard_pairs}


def _vb_check(rng, soft_path: str, shard_pairs: int) -> dict:
    """19.2: K3 on the card against its plain version on CPU copies of the
    same inputs, tolerance 0 (path metrics, decision words, bits), all on
    the sharded pass's own softs: VB_B rows of VB_T pairs; one row whose
    length ends as a full-width shard's does modulo VB_CHUNKS (the ACS's
    partial last chunk and the traceback's partial first one, a block with
    three idle warps), since the plain version of a whole shard takes
    minutes on the host; a lock search's batch (VB_LOCK) and an Aero frame
    (VB_AERO) at their own shapes (renorm on in all of these, as the
    sharded step, the lock search and Aero decode); VB_TILED lanes (renorm
    off, the tiled decoder's). Its time at VB_B x VB_T and at a full-width
    shard, a lock search's batch and an Aero frame; its bound and its SASS
    chains' latency bound."""
    import torch
    from satdump_tpu_torch.ops.fec import convolutional as cc
    soft = np.fromfile(soft_path, np.int8)
    pairs = cc.soft_int8_to_u8(soft[: len(soft) // 2 * 2]).reshape(
        -1, 2).astype(np.float32)

    def rows(B, T):
        offs = rng.integers(0, len(pairs) - T, B)
        return torch.from_numpy(np.stack([pairs[o:o + T] for o in offs])
                                ).cuda()

    err = 0.0
    out = {"compared": {}}
    tail = (1, VB_T + shard_pairs % VB_CHUNKS)
    for label, (B, T), renorm in (("rows", (VB_B, VB_T), True),
                                  ("a full-width shard's chunk ends", tail,
                                   True),
                                  ("lock search", VB_LOCK, True),
                                  ("Aero 10.5k frame", VB_AERO, True),
                                  ("tiled lanes", VB_TILED, False)):
        x = rows(B, T)
        pm0 = torch.zeros((B, 64), device="cuda")
        got = [t.cpu() for t in _vb_decode(pm0, x, renorm)]
        ref, plain_ms = _timed_plain(
            lambda: _vb_plain(pm0.cpu(), x.cpu(), renorm))
        e = float((got[0] - ref[0]).abs().max())
        same = torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        log(f"K3 against its plain version, {label} ({B} x {T}, renorm "
            f"{renorm}): path metrics within {e}, decisions and bits "
            f"{'equal' if same else 'DIFFERENT'}; plain (CPU) {plain_ms:.1f} "
            "ms")
        if e or not same:
            raise AssertionError(f"K3 differs from its plain version at "
                                 f"{label}")
        err = max(err, e)
        out["compared"][label] = {"B": B, "T": T, "renorm": renorm,
                                  "max_abs_err": e, "plain_ms": plain_ms}
        if label == "rows":
            out["plain_ms"] = plain_ms
            out["ms"] = call_ms(lambda: _vb_decode(pm0, x), VB_REPS,
                                back_to_back=True)
            out["call_ms"] = call_ms(lambda: _vb_decode(pm0, x), VB_REPS)
    out["max_abs_err"] = err
    out["bound_ms"], out["bound_by"] = _vb_bound(VB_B, VB_T)
    chains = _vb_sass()
    cyc = sm_clock_mhz() * 1e3                     # cycles a millisecond
    step_cycles = chains["acs"]["cycles_a_step"] + \
        chains["traceback"]["cycles_a_step"]
    out["chain_cycles_per_step"] = step_cycles
    out["latency_bound_ms"] = step_cycles * VB_T / cyc
    shapes = {"full-width shard": (1, shard_pairs), "lock search": VB_LOCK,
              "Aero 10.5k frame": VB_AERO}
    out["shapes"] = {}
    for label, (B, T) in shapes.items():
        x = rows(B, T)
        pm0 = torch.zeros((B, 64), device="cuda")
        ms = call_ms(lambda: _vb_decode(pm0, x), 3)
        b, by = _vb_bound(B, T)
        out["shapes"][label] = {"B": B, "T": T, "ms": ms, "bound_ms": b,
                                "latency_bound_ms": step_cycles * T / cyc}
        log(f"K3 at {label} ({B} x {T}): {ms:.4f} ms a decode (events "
            f"around a call), bound {b:.5f} ms ({by}), latency bound "
            f"{step_cycles * T / cyc:.4f} ms")
    log(f"K3 at {VB_B} x {VB_T}: {out['ms']:.4f} ms a decode back to back, "
        f"{out['call_ms']:.4f} a call; plain (CPU) {out['plain_ms']:.1f} ms; "
        f"bound {out['bound_ms']:.5f} ms ({out['bound_by']}); latency bound "
        f"{out['latency_bound_ms']:.4f} ms ({step_cycles:.1f} cycles a step "
        f"at {cyc / 1e3:.0f} MHz)")
    return out


def _soft_turned(soft: np.ndarray, k: int) -> np.ndarray:
    """Interleaved int8 IQ softs times j^k."""
    c = soft.astype(np.int16).reshape(-1, 2)
    for _ in range(k % 4):
        c = np.stack([-c[:, 1], c[:, 0]], axis=1)
    return c.reshape(-1)


def _mc_dryrun() -> dict:
    """19.3: dryrun_multichip on the card (its step, then the runner path:
    12 of 12 CADUs), and its step against the same step on the CPU. The
    first shard's halo is zeros whose filtered values are FFT round-off,
    so each stream's rotation (a multiple of 90 degrees) and its first
    sub_phase samples of signal are arbitrary on either device
    (tests/test_torch_parallel.py): the softs are held after the channel's
    rotation, the first shard's lead left out."""
    from satdump_tpu_torch.parallel import dryrun, timeshard
    t0 = time.perf_counter()
    card = dryrun.dryrun_multichip(MC_DRYRUN_RANKS, device="cuda")
    wall = time.perf_counter() - t0
    mesh = timeshard.make_mesh(MC_DRYRUN_RANKS)
    cpu = timeshard.run_sharded(dryrun.step_signal(mesh), mesh, "cpu",
                                **dryrun.STEP_KW)
    a, b = card["step"], cpu
    if not np.array_equal(a.valid, b.valid):
        raise AssertionError("dryrun step: valid masks differ, card and CPU")
    lead = 2 * int(np.ceil(dryrun.STEP_KW["sub_phase"] /
                           dryrun.STEP_KW["sps"]))
    worst = 0
    for ch in range(mesh.n_ch):
        k = int(np.argmin([np.abs(_soft_turned(a.soft[1, ch], k)
                                  - b.soft[1, ch]).sum() for k in range(4)]))
        for t in range(mesh.n_t):
            d = np.abs(_soft_turned(a.soft[t, ch], k)
                       - b.soft[t, ch].astype(np.int16))[lead if t == 0
                                                         else 0:]
            worst = max(worst, int(d.max()))
            if d.max() > MC_SOFT_LSB or np.median(d) != 0:
                raise AssertionError(f"dryrun step shard ({ch}, {t}): softs "
                                     f"{d.max()} LSB apart, median "
                                     f"{np.median(d)}")
    launches = {k: sum(r["launches"][k] for r in a.stats["rank"])
                for k in a.stats["rank"][0]["launches"]}
    _need(launches, list(launches), "dryrun step")
    log(f"dryrun_multichip({MC_DRYRUN_RANKS}) on the card: mesh "
        f"{card['mesh']}, runner {card['matched']}/12 CADUs, {wall:.2f} s; "
        f"its step's softs within {worst} LSB of the CPU's (median 0), "
        f"valid masks equal; step launches {launches}")
    return {"wall_s": wall, "soft_lsb": worst, "launches": launches}


def _bench_card() -> dict:
    """19.4: `bench` on the card at its default n, every category rated."""
    from satdump_tpu_torch import bench
    t0 = time.perf_counter()
    res = bench.run_bench(device="cuda")
    missing = set(BENCH_CATEGORIES) - set(res)
    if missing or len(res) != len(BENCH_CATEGORIES):
        raise AssertionError(f"bench: no rate for {sorted(missing)}: {res}")
    log(f"bench on the card at n = {bench.DEFAULT_N}: "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def phase_multichip(rng, work: Path, main_input: Path, main_cadu: Path,
                    cadus: np.ndarray) -> dict:
    """The scale-out, K3 and the bench on the card (phase 19)."""
    t_phase = time.perf_counter()
    mc = _mc_pass(work / "pass", main_input, main_cadu, cadus)
    out = {"pass": mc, "k3": _vb_check(rng, mc["soft"], mc["shard_pairs"]),
           "dryrun": _mc_dryrun(), "bench": _bench_card()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"scale-out / K3 / bench phase {out['phase_s']:.1f} s")
    return out


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
    phase_rs_graph(np.random.default_rng(RS_SEED))
    walkers = phase_walkers(rng)
    work = ROOT / "satdump_tpu_torch" / "_build" / "smoke"
    try:
        phase_small_pass(rng, work)
        launches, main_input, main_cadus = phase_main(rng, work)
        phase_profile(main_input, work / "profile")
        phase_products(rng, work / "full")
        phase_idct(rng)
        walls = phase_resampled(rng, work / "resampled")
        classic_launches, classic_walls = phase_classic(rng, work / "classic")
        bcjr, fec_walls = phase_deep_space(rng, work / "deep_space")
        dvb_walls = phase_dvb(rng, work / "dvb")
        hrpt = phase_hrpt_inmarsat(rng, work / "hrpt")
        host = phase_host_decoders(np.random.default_rng(HOST_SEED),
                                   work / "host")
        xrit2 = phase_xrit_grb(np.random.default_rng(XRIT2_SEED),
                               work / "xrit_grb")
        live = phase_live(np.random.default_rng(LIVE_SEED), work / "live")
        main_cadu = next((work / "main" / "out").glob("*.cadu"))
        geo = phase_geo_ingest(np.random.default_rng(GEO_SEED),
                               work / "geo", main_cadu)
        mc = phase_multichip(np.random.default_rng(MC_SEED),
                             work / "multichip", main_input, main_cadu,
                             main_cadus)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the classic walkers' launches come from their slice's main path,
    # INTEGRAL's pm_demod -> conv-concat pass; K1's stay MetOp's
    for k in ("agc_walk", "pll_walk", "costas_walk", "mm_walk"):
        launches[k] = classic_launches[k]
    # turbo_bcjr's from its slice's main path, JUICE's baseband -> frames
    launches["turbo_bcjr"] = bcjr.pop("launches")
    mc_pass = mc["pass"]
    launches["viterbi_block"] = sum(
        mc_pass[w][k] for w in ("rank_launches", "decoder_launches")
        for k in ("viterbi_block_acs", "viterbi_block_traceback"))
    mc["k3"]["main_path_launches"] = sum(
        launches[k] for k in ("viterbi_block_acs", "viterbi_block_traceback"))
    costas_err = max(r["max_abs_err"] for k, r in walkers.items()
                     if k.startswith("costas"))
    mm_err = max(r["max_abs_err"] for k, r in walkers.items()
                 if k.startswith("mm"))
    # Gardner's launches: gardner_clock_recovery driven in phase 4b (no
    # pipeline of either package calls it)
    launches["gardner_walk"] = sum(walkers[k]["launches"]
                                   for k, _ in GARD_CASES)
    gard_err = max(walkers[k]["max_abs_err"] for k, _ in GARD_CASES)
    sw_src, sw_rep = "satdump_tpu_torch/csrc/sample_walk.cu", "satdump_tpu/ops"
    hrpt_walk = hrpt["noaa_hrpt_walker_launches"]
    rows = []
    for name, src, rep, r in (
            ("viterbi_re", "satdump_tpu_torch/csrc/viterbi_re.cu",
             "satdump_tpu/ops/pallas/viterbi.py:136",
             dict(k1, fy3d_launches=hrpt["fy3d_k1_launches"],
                  jpss_launches=host["jpss_k1_launches"],
                  xrit_launches=_xrit2_launches(xrit2, "viterbi_re"),
                  live_launches=_live_launches(live, "viterbi_re"))),
            ("resample_arith_grid", "satdump_tpu_torch/csrc/resample_arith.cu",
             "satdump_tpu/ops/pallas/resample.py:103",
             dict(k2, max_abs_err=max(k2["max_abs_err"],
                                      live["vfo"]["k2_max_abs_err"]),
                  gac_launches=hrpt["gac_k2_launches"],
                  jpss_launches=host["jpss_k2_launches"],
                  xrit_launches=_xrit2_launches(xrit2,
                                                "resample_arith_grid"),
                  live_launches=_live_launches(live,
                                               "resample_arith_grid"))),
            ("affine_probe", "satdump_tpu_torch/csrc/probe_affine.cu",
             "tools/pallas_smoke.py:10", probe),
            # the classic chain's walkers replace lax.scan loops (no Pallas);
            # their rows are at a 2^18 block, Costas at order 2 (pm_demod's),
            # M&M in complex mode at sps 8 (INTEGRAL's, the main path's)
            # (hrpt_launches: NOAA HRPT's pm_demod pass in phase 14)
            ("agc_walk", sw_src, f"{sw_rep}/stages.py:98",
             dict(walkers["agc"],
                  grb_launches=dvb_walls["grb_agc_launches_first"],
                  hrpt_launches=hrpt_walk["agc_walk"])),
            ("pll_walk", sw_src, f"{sw_rep}/costas.py:100",
             dict(walkers["pll"], hrpt_launches=hrpt_walk["pll_walk"])),
            ("costas_walk", sw_src, f"{sw_rep}/costas.py:71",
             dict(walkers["costas order 2"], max_abs_err=costas_err,
                  hrpt_launches=hrpt_walk["costas_walk"])),
            ("mm_walk", "satdump_tpu_torch/csrc/mm_clock.cu",
             f"{sw_rep}/clock_recovery.py:132",
             dict(walkers["mm complex, sps 8"], max_abs_err=mm_err,
                  hrpt_launches=hrpt_walk["mm_walk"])),
            # the Gardner walker replaces gardner_clock_recovery's lax.scan
            # (no Pallas); its row is at a 2^18 block at MetOp's sps 18/7
            ("gardner_walk", "satdump_tpu_torch/csrc/gardner_clock.cu",
             f"{sw_rep}/clock_recovery.py:227",
             dict(walkers["gardner, sps 18/7"], max_abs_err=gard_err)),
            # the max-log BCJR replaces the lax.scan recursions of
            # _bcjr_maxlog (no Pallas); its row is at base 1115 with
            # JUICE's 58-frame batch, its launches JUICE's pass's
            ("turbo_bcjr", "satdump_tpu_torch/csrc/turbo_bcjr.cu",
             f"{sw_rep}/fec/turbo.py:205", bcjr),
            # the block Viterbi replaces viterbi_acs' and viterbi_traceback's
            # lax.scan loops (no Pallas); its row is at VB_B x VB_T, its
            # launches (ACS and traceback) the sharded MetOp pass's: the
            # ranks' and the decoder's lock search's
            ("viterbi_block", "satdump_tpu_torch/csrc/viterbi_block.cu",
             f"{sw_rep}/fec/convolutional.py:111", mc["k3"])):
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        for k in ("call_ms", "latency_bound_ms", "cycles_per_sample",
                  "cycles_per_step", "chain_cycles_per_step",
                  "grb_launches", "fy3d_launches", "gac_launches",
                  "hrpt_launches", "jpss_launches", "xrit_launches",
                  "live_launches", "main_path_launches",
                  "pipeline_launches"):
            if k in r:
                row[k] = r[k]
        rows.append(row)
    log(f"resampled walls on the card, s: {json.dumps(walls)}")
    log(f"classic walls on the card, s: {json.dumps(classic_walls)}")
    log(f"deep-space walls on the card, s: {json.dumps(fec_walls)}")
    log(f"DVB walls on the card, s: {json.dumps(dvb_walls)}")
    log(f"HRPT / Inmarsat on the card: {json.dumps(hrpt)}")
    log(f"JPSS / xRIT / host decoders on the card: {json.dumps(host)}")
    log(f"xRIT images / GRB products on the card: {json.dumps(xrit2)}")
    log(f"live path on the card: {json.dumps(live)}")
    log(f"projection / ingest / bitview on the card: {json.dumps(geo)}")
    log(f"scale-out / K3 / bench on the card: {json.dumps(mc)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
