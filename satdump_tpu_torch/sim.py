"""Simulation / TX path: modulators + channel model for loopback testing.

The reference ships a channel model (src-core/dsp/channel_model/
channel_model_simple.h) and a GFSK TX modulator for manual loopback tests but
never automates them (SURVEY.md §4). Here the mod -> channel -> demod loop is
a first-class test fixture: synthesize CADUs, encode them through the exact
inverse of the decode chain, modulate, impair, and assert bit-exact recovery.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from satdump_tpu_torch.ops import firdes
from satdump_tpu_torch.ops.fec import convolutional as cc
from satdump_tpu_torch.ops.fec import differential
from satdump_tpu_torch.ops.fec.deframer import CCSDS_ASM
from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon


def make_cadus(n_frames: int, rng: np.random.Generator, cadu_bytes: int = 1024,
               rs_i: int = 4, rs: Optional[ReedSolomon] = None,
               dual_basis: bool = True) -> np.ndarray:
    """Random CCSDS CADUs: [ASM(4) | interleaved RS codewords]. Returns
    (n_frames, cadu_bytes) — the ground truth the decoder must reproduce."""
    rs = rs or ReedSolomon(k=223)
    data = rng.integers(0, 256, (n_frames, rs.k * rs_i)).astype(np.uint8)
    payload = rs.encode_interleaved(data, ccsds_dual=dual_basis, depth=rs_i)
    asm = np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8)
    cadus = np.concatenate([np.tile(asm, (n_frames, 1)), payload], axis=1)
    assert cadus.shape[1] == cadu_bytes
    return cadus


def encode_cadu_stream(cadus: np.ndarray, randomize: bool = True,
                       nrzm: bool = False, conv_rate: str = "1/2") -> np.ndarray:
    """CADUs -> channel bits: [randomize payload] -> bits -> [NRZ-M] ->
    conv encode r=1/2 -> [puncture]. The exact inverse of the decoder chain."""
    tx = cadus.copy()
    if randomize:
        tx[:, 4:] = derand_ccsds(tx[:, 4:])  # XOR with PN (involution)
    bits = np.unpackbits(tx.reshape(-1))
    if nrzm:
        bits, _ = differential.nrzm_encode(bits)
    enc = cc.conv_encode_batch(bits)
    if conv_rate != "1/2":
        from satdump_tpu_torch.ops.fec.depuncture import puncture
        enc = puncture(enc, conv_rate)
    return enc


def encode_cadu_stream_uncoded(cadus: np.ndarray, randomize: bool = True,
                               nrzm: bool = False) -> np.ndarray:
    """CADUs -> channel bits with NO convolutional code (the simple-PSK
    decoder's input, ref module_ccsds_simple_psk_decoder.cpp)."""
    tx = cadus.copy()
    if randomize:
        tx[:, 4:] = derand_ccsds(tx[:, 4:])
    bits = np.unpackbits(tx.reshape(-1))
    if nrzm:
        bits, _ = differential.nrzm_encode(bits)
    return bits


def bits_to_qpsk_symbols(chan_bits: np.ndarray) -> np.ndarray:
    """Pairs of channel bits -> QPSK symbols: I = bit0, Q = bit1, +-1/sqrt2.

    Matches the receiver's soft convention (module_psk_demod.cpp:203-213):
    soft stream is [I,Q,I,Q,...], bit = soft > 0."""
    b = chan_bits.reshape(-1, 2).astype(np.float32) * 2 - 1
    return ((b[:, 0] + 1j * b[:, 1]) / np.sqrt(2)).astype(np.complex64)


def symbols_to_soft_int8(chan_bits: np.ndarray, mag: int = 100) -> np.ndarray:
    """Channel bits -> ideal interleaved int8 softs (bypasses modulation)."""
    return (chan_bits.astype(np.int16) * 2 * mag - mag).astype(np.int8)


def qpsk_modulate(symbols: np.ndarray, sps: float, rrc_alpha: float = 0.5,
                  rrc_taps: int = 31) -> np.ndarray:
    """Upsample + RRC pulse shape at a rational samples-per-symbol."""
    from math import gcd
    num = int(round(sps * 1000))
    g = gcd(num, 1000)
    interp, decim = num // g, 1000 // g  # sps = interp/decim samples/symbol
    n_out = int(len(symbols) * sps)
    up = np.zeros(len(symbols) * interp, np.complex64)
    up[::interp] = symbols
    taps = firdes.root_raised_cosine(1.0, interp, 1.0, rrc_alpha,
                                     rrc_taps * max(1, interp // 2) | 1)
    shaped = np.convolve(up, taps * interp, "same")
    if decim > 1:
        shaped = shaped[::decim]
    return shaped[:n_out].astype(np.complex64)


def qpsk_modulate_rational(symbols: np.ndarray, up: int, down: int,
                           rrc_alpha: float = 0.5, rrc_taps: int = 31
                           ) -> np.ndarray:
    """Pulse shape at exactly sps = up/down samples/symbol (e.g. MetOp's
    6 Msps / 2.333 Msym/s = 18/7), which `qpsk_modulate`'s sps*1000
    rounding cannot give: a polyphase upfirdn with an RRC pulse designed at
    `up` samples/symbol, trimmed by its group delay."""
    from scipy.signal import upfirdn
    taps = firdes.root_raised_cosine(1.0, up, 1.0, rrc_alpha,
                                     (rrc_taps * (up // 2)) | 1) * up
    y = upfirdn(taps, symbols.astype(np.complex64), up=up, down=down)
    delay = (len(taps) - 1) // 2 // down
    n_out = len(symbols) * up // down
    return y[delay: delay + n_out].astype(np.complex64)


METOP_SPS = (18, 7)   # MetOp AHRPT: 6 Msps / 2.333 Msym/s
METEOR_SPS = (35, 9)  # METEOR-M LRPT: 72 ksym/s recorded at 280 ksps
METEOR_1M_SPS = (125, 9)    # METEOR-M LRPT at the pipelines' 1 Msps
GOES_HRIT_SPS = (2000, 309)  # GOES-R HRIT: 927 ksym/s at 6 Msps


def ccsds_qpsk_baseband(cadus: np.ndarray, rng: np.random.Generator,
                        sps: Tuple[int, int]) -> np.ndarray:
    """QPSK downlink of `cadus` (MetOp AHRPT, METEOR-M LRPT) at exactly
    sps = up/down samples/symbol: randomize, r=1/2 encode, QPSK, RRC
    (alpha 0.5), then AWGN at 18 dB SNR, a carrier offset of 1e-4
    cycles/sample and a phase of 0.4 rad. A short idle tail after the last
    frame lets the Viterbi flush it. The channel noise seed comes from
    `rng`. Returns complex64 baseband."""
    return ccsds_psk_baseband(cadus, rng, sps)


def ccsds_psk_baseband(cadus: np.ndarray, rng: np.random.Generator,
                       sps: Tuple[int, int], constellation: str = "qpsk",
                       nrzm: bool = False, snr_db: float = 18.0,
                       freq_offset: float = 1e-4, dc: complex = 0.0
                       ) -> np.ndarray:
    """Downlink of `cadus` at exactly sps = up/down samples/symbol:
    randomize, [NRZ-M], r=1/2 encode, then BPSK (GOES HRIT: one channel
    bit a symbol), QPSK (MetOp, METEOR-M2) or OQPSK (METEOR-M2-x: the I
    rail half a symbol late), RRC alpha 0.5, AWGN at `snr_db`, a carrier
    offset of `freq_offset` cycles/sample, a phase of 0.4 rad and a DC term
    `dc` added at the receiver (a direct-conversion SDR's). A short idle
    tail after the last frame lets the Viterbi flush it. The channel noise
    seed comes from `rng`. Returns complex64 baseband."""
    bits = encode_cadu_stream(cadus, nrzm=nrzm)
    tail = rng.integers(0, 2, 2048).astype(np.uint8)
    return psk_baseband(np.concatenate([bits, tail]), rng, sps,
                        constellation, snr_db, freq_offset, dc)


def psk_baseband(chan: np.ndarray, rng: np.random.Generator,
                 sps: Tuple[int, int], constellation: str = "qpsk",
                 snr_db: float = 18.0, freq_offset: float = 1e-4,
                 dc: complex = 0.0) -> np.ndarray:
    """Channel bits at exactly sps = up/down samples/symbol: BPSK (one bit a
    symbol, 1 -> +1), QPSK or OQPSK (bit pairs, I first; OQPSK's I rail half
    a symbol late), RRC alpha 0.5, then AWGN at `snr_db`, a carrier offset
    of `freq_offset` cycles/sample, a phase of 0.4 rad and a DC term `dc`.
    The channel noise seed comes from `rng`. Returns complex64 baseband."""
    if constellation == "bpsk":
        tx = qpsk_modulate_rational(
            (chan.astype(np.float32) * 2 - 1).astype(np.complex64), *sps)
    elif constellation == "qpsk":
        tx = qpsk_modulate_rational(bits_to_qpsk_symbols(chan), *sps)
    elif constellation == "oqpsk":
        tx = oqpsk_modulate_rational(bits_to_qpsk_symbols(chan), *sps)
    else:
        raise ValueError(f"unknown constellation {constellation}")
    return ChannelModel(snr_db=snr_db, freq_offset=freq_offset, phase=0.4,
                        dc=dc, seed=int(rng.integers(1 << 30))).apply(tx)


def oqpsk_modulate_rational(symbols: np.ndarray, up: int, down: int,
                            rrc_alpha: float = 0.5, rrc_taps: int = 31
                            ) -> np.ndarray:
    """OQPSK at exactly sps = up/down: the rails as a sequence of two
    elements a symbol, the I rail in the odd (half a symbol late) and the
    Q rail in the even ones, pulse-shaped by a polyphase upfirdn at 2*up
    samples a symbol (so that the half-symbol offset is whole samples
    there) and decimated by 2*down; the receiver's delay of the imaginary
    rail realigns them."""
    from scipy.signal import upfirdn
    n = len(symbols)
    seq = np.zeros(2 * n, np.complex64)
    seq[0::2] = 1j * symbols.imag
    seq[1::2] = symbols.real
    taps = firdes.root_raised_cosine(1.0, 2 * up, 1.0, rrc_alpha,
                                     (rrc_taps * up) | 1) * (2 * up)
    y = upfirdn(taps, seq, up=up, down=2 * down)
    delay = (len(taps) - 1) // 2 // (2 * down)
    n_out = n * up // down
    return y[delay: delay + n_out].astype(np.complex64)


def oqpsk_modulate(symbols: np.ndarray, sps: float = 2.0,
                   rrc_alpha: float = 0.5, rrc_taps: int = 31) -> np.ndarray:
    """OQPSK: QPSK pulse shaping with the I rail delayed half a symbol, so
    the receiver's delay-one-imag (delay_one_imag.cpp: imag[i-1]) realigns
    the rails. Integer sps only (the half-symbol shift must be whole
    samples at TX)."""
    assert abs(sps - round(sps)) < 1e-9 and int(round(sps)) % 2 == 0, \
        "oqpsk_modulate needs an even integer sps"
    x = qpsk_modulate(symbols, sps, rrc_alpha, rrc_taps)
    half = int(round(sps)) // 2
    re = np.concatenate([np.zeros(half, np.float32), x.real[:-half]])
    return (re + 1j * x.imag).astype(np.complex64)


def pm_bpsk_baseband(chan_bits: np.ndarray, sps: float,
                     rng: np.random.Generator, mod_index: float = 1.0,
                     freq_offset: float = 1e-4, noise: float = 0.02,
                     rrc_alpha: float = 0.5, lead_bits: int = 1024,
                     tail_bits: int = 2048) -> np.ndarray:
    """PM downlink of channel bits on a BPSK subcarrier at the symbol rate
    (pm_demod's default subcarrier), as tests/test_pm_fsk.py builds it:
    symbols 1 - 2 bit, RRC-shaped (63 taps) at an integer `sps` (held for
    sps samples at any other), times a cosine at the symbol rate,
    phase-modulating the carrier by `mod_index` rad, with a carrier offset
    of `freq_offset` cycles a sample and complex AWGN of `noise` a
    component. `lead_bits` random bits before and `tail_bits` after give
    the loops time to lock and the decoders their flush. The noise and the
    padding come from `rng`. Returns complex64 baseband."""
    lead = rng.integers(0, 2, lead_bits).astype(np.uint8)
    tail = rng.integers(0, 2, tail_bits).astype(np.uint8)
    bits = np.concatenate([lead, np.asarray(chan_bits, np.uint8), tail])
    sym = 1.0 - 2.0 * bits.astype(np.float32)
    if float(sps).is_integer():
        sps = int(sps)
        up = np.zeros(len(bits) * sps, np.float32)
        up[::sps] = sym
        taps = firdes.root_raised_cosine(1.0, sps, 1.0, rrc_alpha, 63)
        b = np.convolve(up, taps * sps, "same")
    else:
        b = sym[(np.arange(int(len(bits) * sps)) / sps).astype(np.int64)]
    n = np.arange(len(b))
    sub = b * np.cos(2 * np.pi * n / sps)
    x = np.exp(1j * (2 * np.pi * freq_offset * n + mod_index * sub))
    x = x + noise * (rng.standard_normal(len(x))
                     + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def crc_frames(n: int, rng: np.random.Generator, size: int) -> np.ndarray:
    """(n, size) random frames whose last two bytes are the CRC-16 (CCITT,
    big-endian) of the rest, as ccsds_turbo_decoder counts `crc_ok`."""
    from satdump_tpu_torch.ops.fec.crc import crc_ccitt
    frames = rng.integers(0, 256, (n, size), dtype=np.uint8)
    for fr in frames:
        c = crc_ccitt.compute(fr[: size - 2])
        fr[size - 2], fr[size - 1] = c >> 8, c & 0xFF
    return frames


def turbo_stream_bits(frames: np.ndarray, base: int, rate: str
                      ) -> np.ndarray:
    """Frames (n, base) -> the channel bits ccsds_turbo_decoder takes: each
    frame turbo-encoded at `rate`, the codeword PN-randomized from its
    start, behind the rate's attached sync marker (tests/test_turbo.py's
    fixture)."""
    from satdump_tpu_torch.ops.fec.randomization import derand_ccsds_soft_bits
    from satdump_tpu_torch.ops.fec.turbo import CCSDSTurbo
    from satdump_tpu_torch.pipeline.modules.ccsds.turbo_decoder import (
        TURBO_ASM, _asm_bits)
    cw = CCSDSTurbo(base, rate).encode_bits(np.unpackbits(frames, axis=-1))
    cw = derand_ccsds_soft_bits(cw)
    asm = np.tile(_asm_bits(*TURBO_ASM[rate]), (len(frames), 1))
    return np.concatenate([asm, cw], axis=1).reshape(-1)


def ldpc_stream_bits(frames: np.ndarray, asm_val: int, asm_size: int
                     ) -> np.ndarray:
    """LDPC frames (n, frame_bits) channel bits -> the stream
    ccsds_ldpc_decoder takes: each frame PN-randomized from its start,
    behind the `asm_size`-bit marker."""
    from satdump_tpu_torch.ops.fec.randomization import derand_ccsds_soft_bits
    frames = derand_ccsds_soft_bits(np.asarray(frames, np.uint8))
    asm = ((asm_val >> np.arange(asm_size - 1, -1, -1)) & 1).astype(np.uint8)
    return np.concatenate([np.tile(asm, (len(frames), 1)), frames],
                          axis=1).reshape(-1)


def ldpc_internal_frames(cadus: np.ndarray, ld, rng: np.random.Generator
                         ) -> np.ndarray:
    """CADUs carried as an LDPC internal stream (GOES-R raw sounder data):
    their bits cut into blocks of `ld.data_bits` (the last one padded with
    random bits) and each encoded into one frame of `ld` (a CCSDSLDPC).
    Returns the frames' channel bits (n, frame_bits)."""
    bits = np.unpackbits(np.asarray(cadus, np.uint8).reshape(-1))
    n = -(-len(bits) // ld.data_bits)
    pad = rng.integers(0, 2, n * ld.data_bits - len(bits)).astype(np.uint8)
    data = np.concatenate([bits, pad]).reshape(n, ld.data_bits)
    return ld.encode_frames(ld.encoder(), data)


def soft_stream(bits: np.ndarray, rng: np.random.Generator, mag: int = 90,
                sigma: float = 12.0, prefix: int = 777) -> np.ndarray:
    """Channel bits -> int8 softs of +-mag (bit 1 positive) behind `prefix`
    random softs in [-50, 50), with Gaussian noise of `sigma`, clipped to
    +-127 (tests/test_turbo.py's fixture)."""
    soft = (np.asarray(bits).astype(np.int16) * (2 * mag) - mag).astype(
        np.int8)
    soft = np.concatenate([rng.integers(-50, 50, prefix).astype(np.int8),
                           soft])
    return np.clip(soft + rng.normal(0, sigma, len(soft)), -127, 127
                   ).astype(np.int8)


def oqpsk_q_late(soft: np.ndarray) -> np.ndarray:
    """Interleaved (I, Q) softs with the Q rail one symbol late (the first
    Q an erasure) and both rails negated: an OQPSK stream that the
    correlator finds only through its Q-delayed replica turned by 180."""
    out = np.asarray(soft, np.int8).copy()
    out[3::2] = soft[1:-2:2]
    out[1] = 0
    return np.clip(-out.astype(np.int16), -127, 127).astype(np.int8)


GRB_SYMBOLRATE = 8_665_938.0   # GOES-R GRB (GOES.json goes_grb)


def grb_bbframes(cadus: np.ndarray, lead: int = 0) -> np.ndarray:
    """GOES-R GRB's BBFrames: the 2048-byte `cadus` as one continuous byte
    stream (after `lead` zero bytes) in the 7264-byte data fields of
    (B, 7274) unscrambled BBFrames behind a generic-stream BBHeader, the
    last frame padded with zeros."""
    from satdump_tpu_torch.ops.dvbs2.bbframe import BBHeader
    size, hdr = 58192 // 8, 10
    stream = np.concatenate([np.zeros(lead, np.uint8),
                             np.asarray(cadus, np.uint8).reshape(-1)])
    n = -(-len(stream) // (size - hdr))
    frames = np.zeros((n, size), np.uint8)
    frames[:, :hdr] = BBHeader(ts_gs=0b01, upl=0, dfl=(size - hdr) * 8,
                               sync=0, syncd=0).build()
    data = np.zeros(n * (size - hdr), np.uint8)
    data[: len(stream)] = stream
    frames[:, hdr:] = data.reshape(n, size - hdr)
    return frames


def dvbs2_baseband(symbols: np.ndarray, rng: np.random.Generator,
                   sps: Tuple[int, int] = (2, 1), rrc_alpha: float = 0.25,
                   snr_db: float = 14.0, freq_offset: float = 1e-4,
                   phase: float = 0.5, gain: float = 0.7, lead: int = 1000
                   ) -> np.ndarray:
    """DVB-S2 PLFRAME symbols (ops/dvbs2/tx.py) at exactly sps = up/down
    samples/symbol: `lead` random QPSK symbols ahead (a receiver joins a
    stream mid-frame), RRC at `rrc_alpha`, then the channel model: AWGN at
    `snr_db`, a carrier offset of `freq_offset` cycles/sample, a phase and a
    gain. The noise seed comes from `rng`. Returns complex64 baseband."""
    head = bits_to_qpsk_symbols(rng.integers(0, 2, 2 * lead).astype(
        np.uint8))
    tx = qpsk_modulate_rational(
        np.concatenate([head, np.asarray(symbols, np.complex64)]), *sps,
        rrc_alpha=rrc_alpha)
    return ChannelModel(snr_db=snr_db, freq_offset=freq_offset, phase=phase,
                        gain=gain, seed=int(rng.integers(1 << 30))).apply(tx)


def dvbs_symbols(ts_pkts: np.ndarray, rate: str) -> np.ndarray:
    """188-byte TS packets -> DVB-S QPSK symbols (EN 300 421 TX, as
    tests/test_dvbs_legacy.py's fixture: energy dispersal a group of 8 with
    the inverted sync -> RS(204,188) -> Forney interleave -> r=1/2 k=7
    encode, punctured to `rate` -> QPSK)."""
    from satdump_tpu_torch.ops import dvbs
    from satdump_tpu_torch.ops.fec.depuncture import puncture
    ts = np.asarray(ts_pkts, np.uint8).reshape(-1, dvbs.TS_SIZE)
    rnd = []
    for g in range(len(ts) // 8):
        grp = ts[g * 8:(g + 1) * 8].copy()
        grp[0, 0] = dvbs.SYNC_INV
        rnd.append(dvbs.energy_dispersal(grp))   # involution = randomize
    cws = dvbs.DVBSReedSolomon().encode(np.concatenate(rnd))
    inter = dvbs.ConvInterleaver().work(cws.reshape(-1))
    enc = cc.conv_encode_batch(np.unpackbits(inter)[None])[0]
    if rate != "1/2":
        enc = puncture(enc, rate)
    return bits_to_qpsk_symbols(enc[: len(enc) // 2 * 2])


def fsk_baseband(chan_bits: np.ndarray, samplerate: float, symbolrate: float,
                 rng: np.random.Generator, deviation: float,
                 snr_db: float = 20.0, lead_bits: int = 512) -> np.ndarray:
    """2-FSK downlink of channel bits at any samplerate / symbolrate: bit 1
    at +deviation Hz and bit 0 at -deviation (fsk_demod's soft > 0 is a
    1), each sample taking the bit whose symbol period it falls in, the
    phase the running sum of the frequency, then AWGN at `snr_db`.
    `lead_bits` random bits before and 512 after; the noise and the padding
    come from `rng`. Returns complex64 baseband."""
    bits = np.concatenate([rng.integers(0, 2, lead_bits).astype(np.uint8),
                           np.asarray(chan_bits, np.uint8),
                           rng.integers(0, 2, 512).astype(np.uint8)])
    n = int(len(bits) * samplerate / symbolrate)
    idx = np.minimum((np.arange(n) * (symbolrate / samplerate)).astype(
        np.int64), len(bits) - 1)
    freq = (2.0 * bits[idx] - 1.0) * (deviation / samplerate)
    tx = np.exp(2j * np.pi * np.cumsum(freq)).astype(np.complex64)
    return ChannelModel(snr_db=snr_db,
                        seed=int(rng.integers(1 << 30))).apply(tx)


def apt_audio(lines: int, audio_rate: float = 50_000.0,
              rng: Optional[np.random.Generator] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """NOAA APT audio, as tests/test_e2e.py synthesizes it: each line is
    2080 words at 4160 words/s, the 39-word sync A then a pattern of bands
    that moves from line to line (plus noise of 0.02 when `rng` is given),
    AM-modulated (index ~0.85) on a 2400 Hz subcarrier. Returns (audio
    float32 in [-1, 1], (lines, 2080) float32 words in [0, 1] sent)."""
    from satdump_tpu_torch.models.noaa_apt import APT_WORD_RATE, SYNC_A
    words_per_line = 2080
    line = np.zeros((lines, words_per_line), np.float32)
    line[:, :len(SYNC_A)] = SYNC_A / 255.0
    x = np.linspace(0, 1, words_per_line - 100)
    for i in range(lines):
        line[i, 100:] = 0.5 + 0.45 * np.sin(2 * np.pi * (x * 3 + i / 7))
    if rng is not None:
        line[:, 100:] = np.clip(
            line[:, 100:] + rng.normal(0, 0.02, line[:, 100:].shape), 0, 1)
    words = line.reshape(-1)
    n_audio = int(len(words) / APT_WORD_RATE * audio_rate)
    t_idx = (np.arange(n_audio) * APT_WORD_RATE / audio_rate).astype(np.int64)
    env = words[np.minimum(t_idx, len(words) - 1)]
    t = np.arange(n_audio) / audio_rate
    carrier = np.cos(2 * np.pi * 2400.0 * t)
    return ((0.15 + 0.8 * env) * carrier).astype(np.float32), line


def fm_modulate(audio: np.ndarray, audio_rate: float, samplerate: float,
                deviation: float, snr_db: float = 30.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Audio -> complex FM baseband at `samplerate`: the audio interpolated
    to the baseband rate (polyphase, scipy.signal.resample_poly), a phase
    that advances 2*pi*deviation*audio/samplerate a sample, then AWGN at
    `snr_db` (seeded from `rng`). The FM demodulators' output is
    audio * deviation / (audio_rate / 2)."""
    from fractions import Fraction
    from scipy.signal import resample_poly
    r = Fraction(samplerate / audio_rate).limit_denominator(1000)
    a = resample_poly(audio.astype(np.float64), r.numerator, r.denominator)
    phase = 2 * np.pi * deviation * np.cumsum(a) / samplerate
    seed = int(rng.integers(1 << 30)) if rng is not None else 1
    return ChannelModel(snr_db=snr_db, seed=seed).apply(
        np.exp(1j * phase).astype(np.complex64))


class ChannelModel:
    """AWGN + carrier offset + phase + delay + gain (ref
    channel_model_simple.h — noise/freq-offset impairments)."""

    def __init__(self, snr_db: float = 30.0, freq_offset: float = 0.0,
                 phase: float = 0.0, gain: float = 1.0, dc: complex = 0.0,
                 seed: int = 1):
        self.snr_db = snr_db
        self.freq_offset = freq_offset  # cycles/sample
        self.phase = phase
        self.gain = gain
        self.dc = dc
        self.rng = np.random.default_rng(seed)

    def apply(self, x: np.ndarray) -> np.ndarray:
        n = np.arange(len(x))
        y = x * np.exp(1j * (self.phase + 2 * np.pi * self.freq_offset * n))
        sig_pow = np.mean(np.abs(x) ** 2)
        noise_pow = sig_pow / (10 ** (self.snr_db / 10))
        noise = (self.rng.standard_normal(len(x))
                 + 1j * self.rng.standard_normal(len(x))) * np.sqrt(noise_pow / 2)
        return ((y + noise) * self.gain + self.dc).astype(np.complex64)


# ---------------------------------------------------------------------------
# Test signals that carry instrument data: CCSDS packets muxed into VCDUs,
# RS(255,223)x4-encoded CADUs that the decoders give back byte for byte.
# ---------------------------------------------------------------------------

METOP_B_SCID = 11
AVHRR_LINE_MS = 1000 / 6          # AVHRR/3: 6 lines a second
MHS_LINE_MS = 8000 / 3            # MHS: one scan every 8/3 s


def _cds_header(day: int, ms: int, us: int = 0) -> bytes:
    """CCSDS day-segmented time: 16-bit days, 32-bit ms of day, 16-bit µs."""
    return bytes([day >> 8, day & 0xFF, (ms >> 24) & 0xFF, (ms >> 16) & 0xFF,
                  (ms >> 8) & 0xFF, ms & 0xFF, us >> 8, us & 0xFF])


def vcid_frames(packets, vcid: int, scid: int) -> np.ndarray:
    """Packets -> (n, 896) AOS transfer frames behind the ASM: VCDU header
    (6), insert zone (2), M-PDU header (2) and an 882-byte data zone, the
    layout of MetOp AHRPT and METEOR LRPT."""
    from satdump_tpu_torch.ccsds.mux import mux_packets
    zones = mux_packets(packets, mpdu_data_size=882)
    out = np.zeros((len(zones), 896), np.uint8)
    out[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
    out[:, 4] = (1 << 6) | ((scid >> 2) & 0b111111)
    out[:, 5] = ((scid & 0b11) << 6) | (vcid & 0b111111)
    i = np.arange(len(zones))
    out[:, 6], out[:, 7], out[:, 8] = i >> 16 & 0xFF, i >> 8 & 0xFF, i & 0xFF
    for k, (fhp, data) in enumerate(zones):
        out[k, 12] = (fhp >> 8) & 0b111
        out[k, 13] = fhp & 0xFF
        out[k, 14:] = np.frombuffer(data, np.uint8)
    return out


def idle_cadus(n: int, scid: int = METOP_B_SCID, depth: int = 4
                ) -> np.ndarray:
    """n idle frames (VCID 63, no packet header, zero fill) RS-encoded at
    interleave `depth`, as a downlink sends between and around its data
    frames."""
    frames = np.zeros((n, 4 + 223 * depth), np.uint8)
    frames[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
    frames[:, 4] = (1 << 6) | ((scid >> 2) & 0b111111)
    frames[:, 5] = ((scid & 0b11) << 6) | 63
    frames[:, 12:14] = [0x07, 0xFE]          # first header pointer 2046
    return rs_encode_frames(frames, depth)


def rs_encode_frames(frames: np.ndarray, depth: int = 4) -> np.ndarray:
    """(n, 4 + 223 * depth) frames -> (n, 4 + 255 * depth) CADUs: the bytes
    after the ASM become `depth` interleaved RS(255,223) codewords (dual
    basis), as `make_cadus` encodes them (depth 4: 896 -> 1024 bytes)."""
    rs = ReedSolomon(k=223)
    payload = rs.encode_interleaved(frames[:, 4:], ccsds_dual=True,
                                    depth=depth)
    return np.concatenate([frames[:, :4], payload], axis=1)


def _interleave(streams) -> np.ndarray:
    """Merge per-VCID CADU streams in time order, each spread evenly."""
    keys = np.concatenate([(np.arange(len(s)) + 0.5) / len(s)
                           for s in streams if len(s)])
    allc = np.concatenate([s for s in streams if len(s)])
    return allc[np.argsort(keys, kind="stable")]


def avhrr_scene(rng: np.random.Generator, lines: int, width: int = 2048
                ) -> np.ndarray:
    """(lines, width, 5) 10-bit AVHRR/3 counts: a smooth field per channel
    plus noise."""
    y = np.arange(lines)[:, None, None] / 97.0
    x = np.arange(width)[None, :, None] / 211.0
    c = np.arange(5)[None, None, :]
    field = 0.5 + 0.25 * np.sin(x + 1.3 * c) * np.cos(y - 0.7 * c)
    noise = rng.normal(0.0, 0.05, (lines, width, 5))
    return np.clip((field + noise) * 1023, 0, 1023).astype(np.uint16)


def metop_instrument_cadus(rng: np.random.Generator, avhrr_lines: int,
                           mhs_lines: int):
    """MetOp-B AHRPT CADUs carrying AVHRR/3 (APIDs 103/104 alternating,
    VCID 9) and MHS (APID 34, VCID 12) packets, laid out as
    tests/test_metop.py builds them (CDS time, the AVHRR image zone at
    10-bit word 55, MHS FOVs at SCI byte 49) and RS-encoded. Returns
    (cadus (n, 1024) uint8, truth) with truth = {"avhrr": (lines, 2048, 5)
    10-bit counts, "ch3a": (lines,) bool, "mhs": (lines, 90, 5) uint16}."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    from satdump_tpu_torch.utils.repack import pack_nbits_to_bytes
    avhrr = avhrr_scene(rng, avhrr_lines)
    ch3a = np.arange(avhrr_lines) % 2 == 0
    packets = []
    for lo in range(0, avhrr_lines, 256):
        blk = avhrr[lo: lo + 256]
        words = np.zeros((len(blk), 10355), np.uint16)
        words[:, 55: 55 + 2048 * 5] = blk.reshape(len(blk), -1)
        body = pack_nbits_to_bytes(words, 10)[:, :12944]
        for j, b in enumerate(body):
            i = lo + j
            payload = bytearray(_cds_header(20000, int(i * AVHRR_LINE_MS))
                                + bytes(6) + b.tobytes())
            payload += bytes(12960 - len(payload))
            packets.append(CCSDSPacket(
                header=CCSDSHeader(apid=103 if ch3a[i] else 104,
                                   packet_sequence_count=i & 0x3FFF),
                payload=payload))
    mhs = rng.integers(0, 65536, (mhs_lines, 90, 5)).astype(np.uint16)
    mpk = []
    for i, line in enumerate(mhs):
        sci = np.zeros(1286, np.uint8)
        fovs = np.zeros((90, 12), np.uint8)
        fovs[:, 2:12:2] = line >> 8
        fovs[:, 3:12:2] = line & 0xFF
        sci[49: 49 + 90 * 12] = fovs.reshape(-1)
        payload = bytearray(_cds_header(20000, int(i * MHS_LINE_MS))
                            + bytes(6) + sci.tobytes() + b"\x00\x00")
        mpk.append(CCSDSPacket(header=CCSDSHeader(
            apid=34, packet_sequence_count=i & 0x3FFF), payload=payload))
    frames = _interleave([vcid_frames(packets, 9, METOP_B_SCID),
                          vcid_frames(mpk, 12, METOP_B_SCID)])
    return rs_encode_frames(frames), {"avhrr": avhrr, "ch3a": ch3a,
                                      "mhs": mhs}


# -- baseline JPEG entropy encoder (T.81), for MSU-MR test segments ---------

def _huffman_codes(bits, vals):
    codes, code, i = {}, 0, 0
    for length in range(1, len(bits) + 1):
        for _ in range(bits[length - 1]):
            codes[vals[i]] = (length, code)
            i += 1
            code += 1
        code <<= 1
    return codes


def _category(v: int) -> int:
    return 0 if v == 0 else int(abs(v)).bit_length()


def jpeg_encode_blocks(coeffs_zz: np.ndarray) -> bytes:
    """(N, 64) zig-zag quantized coefficients -> baseline entropy bitstream
    with the T.81 Annex K luminance tables, padded with 1 bits."""
    from satdump_tpu_torch.image import jpeg
    dc = _huffman_codes(jpeg.DC_BITS, jpeg.DC_VALS)
    ac = _huffman_codes(jpeg.AC_BITS, jpeg.AC_VALS)
    out = []

    def put(value, length):
        out.extend((value >> i) & 1 for i in range(length - 1, -1, -1))

    def put_coeff(v, length):
        if length:
            put(v + (1 << length) - 1 if v < 0 else v, length)

    last_dc = 0
    for blk in coeffs_zz:
        diff = int(blk[0]) - last_dc
        last_dc = int(blk[0])
        cat = _category(diff)
        put(dc[cat][1], dc[cat][0])
        put_coeff(diff, cat)
        k = 1
        for idx in np.nonzero(blk[1:])[0]:
            pos = int(idx) + 1
            run = pos - k
            while run >= 16:
                put(ac[0xF0][1], ac[0xF0][0])
                run -= 16
            v = int(blk[pos])
            size = _category(v)
            put(ac[(run << 4) | size][1], ac[(run << 4) | size][0])
            put_coeff(v, size)
            k = pos + 1
        if k < 64:
            put(ac[0x00][1], ac[0x00][0])
    out.extend([1] * ((-len(out)) % 8))
    return np.packbits(np.array(out, np.uint8)).tobytes()


def jpeg_quantize_forward(pixels: np.ndarray, qf: float) -> np.ndarray:
    """(N, 8, 8) uint8 -> (N, 64) zig-zag quantized DCT coefficients."""
    from satdump_tpu_torch.image import jpeg
    C = jpeg._dct_basis().astype(np.float64)
    dct = np.einsum("ik,nkl,jl->nij", C, pixels.astype(np.float64) - 128.0, C)
    nat = np.round(dct.reshape(-1, 64) / jpeg.quantization_table(qf))
    zz = np.zeros(nat.shape, np.int32)
    zz[:, jpeg.ZIGZAG] = nat
    return zz


def msumr_lrpt_cadus(rng: np.random.Generator, strips: int,
                     channels=(1, 2, 3), qf: int = 80):
    """Test-signal generator: METEOR-M LRPT CADUs carrying MSU-MR imagery.
    Each 8-line strip of each channel is 14 segments (APID 63 + channel,
    VCID 5) of 14 JPEG-coded 8x8 blocks, sent in the 43-packet loop (14
    segments a channel for three channels, then a telemetry packet on APID
    70); the packet sequence count runs over the loop. Segment headers carry
    a CDS time (as M2-x sends it), the MCU number and the quality factor
    `qf`, as tests/test_meteor.py builds them. Returns (cadus (n, 1024)
    uint8, truth {channel: (strips * 8, 1568) uint8 image sent})."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    h, w = strips * 8, 14 * 112
    y = np.arange(h)[:, None] / 9.0
    x = np.arange(w)[None, :] / 37.0
    truth = {}
    for ch in channels:
        field = 128 + 70 * np.sin(x + ch) * np.cos(y - ch)
        truth[ch] = np.clip(field + rng.normal(0, 6, (h, w)), 0, 255
                            ).astype(np.uint8)
    packets, seq = [], 0
    for s in range(strips):
        for slot in range(3):
            ch = slot + 1
            for seg in range(14):
                if ch in truth:
                    strip = truth[ch][s * 8:(s + 1) * 8,
                                      seg * 112:(seg + 1) * 112]
                    mcus = np.ascontiguousarray(
                        strip.reshape(8, 14, 8).transpose(1, 0, 2))
                    hdr = _cds_header(0, s * 1600 + slot * 200) + bytes(
                        [seg * 14, 0x00, 0x00, 0xFF, 0xF0, qf])
                    body = jpeg_encode_blocks(jpeg_quantize_forward(mcus, qf))
                    packets.append(CCSDSPacket(
                        header=CCSDSHeader(apid=63 + ch,
                                           packet_sequence_count=seq),
                        payload=bytearray(hdr + body)))
                seq = (seq + 1) & 0x3FFF
        packets.append(CCSDSPacket(                       # telemetry
            header=CCSDSHeader(apid=70, packet_sequence_count=seq),
            payload=bytearray(_cds_header(0, s * 1600) + bytes(40))))
        seq = (seq + 1) & 0x3FFF
    return rs_encode_frames(vcid_frames(packets, 5, 0)), truth


# ---------------------------------------------------------------------------
# FengYun-3 AHRPT, NOAA and METEOR HRPT, Inmarsat STD-C and Aero
# ---------------------------------------------------------------------------

FY3_SPS = (3, 1)   # FY-3 AHRPT: 8.4 / 2.8, 7.8 / 2.6 and 90 / 30 Msps / Msym/s


def fengyun_diff_encode(bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The inverse of models.fengyun3.fengyun_diff_decode in closed form:
    bit pairs (b1, b0) -> the rails x and y, one symbol longer than the
    pairs and starting at x = y = 0. With s = x ^ y, each symbol sets
    s_k = s_(k-1) ^ b1 ^ b0 and x_k = x_(k-1) ^ (b0 if s_k else b1): two
    running XORs."""
    bits = np.asarray(bits, np.uint8)
    b1, b0 = bits[0::2], bits[1::2]
    s = np.bitwise_xor.accumulate(b1 ^ b0)
    x = np.bitwise_xor.accumulate(np.where(s == 1, b0, b1))
    zero = np.zeros(1, np.uint8)
    return np.concatenate([zero, x]), np.concatenate([zero, x ^ s])


def fy3_ahrpt_baseband(cadus: np.ndarray, rng: np.random.Generator,
                       snr_db: float = 18.0, freq_offset: float = 1e-4
                       ) -> np.ndarray:
    """FengYun-3 AHRPT downlink of `cadus` at sps 3: randomize, the FengYun
    differential encoder, each rail its own r=1/2 k=7 code (I carries x,
    Q carries y), QPSK with RRC alpha 0.35 (the pipelines' own), AWGN at
    `snr_db`, a carrier offset of `freq_offset` cycles/sample and a phase
    of 0.4 rad. An idle tail after the last frame lets the Viterbi flush
    it. The tail and the noise seed come from `rng`. Returns complex64
    baseband."""
    tx = cadus.copy()
    tx[:, 4:] = derand_ccsds(tx[:, 4:])
    bits = np.concatenate([np.unpackbits(tx.reshape(-1)),
                           rng.integers(0, 2, 4096).astype(np.uint8)])
    x, y = fengyun_diff_encode(bits)
    chan = np.empty(4 * len(x), np.uint8)
    chan[0::2] = cc.conv_encode_batch(x)
    chan[1::2] = cc.conv_encode_batch(y)
    sym = qpsk_modulate_rational(bits_to_qpsk_symbols(chan), *FY3_SPS,
                                 rrc_alpha=0.35)
    return ChannelModel(snr_db=snr_db, freq_offset=freq_offset, phase=0.4,
                        seed=int(rng.integers(1 << 30))).apply(sym)


def virr_frame(rng: np.random.Generator, days: int = 1234,
               ms: int = 5_000_000) -> Tuple[np.ndarray, np.ndarray]:
    """One VIRR frame (208,400 bits, its 60-bit sync first) carrying a
    random (2048, 10) line of 10-bit counts and a day / ms timestamp, as
    tests/test_fengyun3.py builds it. Returns (frame bytes, line)."""
    from satdump_tpu_torch.models.fengyun3 import (VIRR_FRAME_BITS,
                                                   VIRR_SYNC, VIRR_SYNC_BITS)
    from satdump_tpu_torch.utils.repack import pack_nbits_to_bytes
    frame = np.zeros(VIRR_FRAME_BITS // 8, np.uint8)
    sync = (VIRR_SYNC >> np.arange(VIRR_SYNC_BITS - 1, -1, -1)) & 1
    bits = np.unpackbits(frame)
    bits[:VIRR_SYNC_BITS] = sync
    frame = np.packbits(bits)
    img = rng.integers(0, 1024, (2048, 10), dtype=np.uint16)
    frame[436: 436 + 25600] = pack_nbits_to_bytes(img.reshape(-1), 10)[:25600]
    t = np.zeros(8, np.uint8)
    t[1], t[2] = (days >> 10) & 0b11, (days >> 2) & 0xFF
    t[3] = ((days & 0b11) << 6) | ((ms >> 24) & 0b11)
    t[4], t[6], t[7] = (ms >> 16) & 0xFF, (ms >> 8) & 0xFF, ms & 0xFF
    for k, off in zip((0, 1, 2, 3, 4, 6, 7), range(7)):
        frame[26041 + off] |= (t[k] >> 2) & 0b111111
        frame[26042 + off] |= (t[k] & 0b11) << 6
    return frame, img


def _fy3_sounder_packets(mwhs2_scans: int, mwts2_scans: int) -> list:
    """MWHS-2 (APID 16: four packets a scan, channel ch pixel i = 100 ch +
    i + scan) and MWTS-2 (APID 7: markers 1-4, channel ch pixel i = 1000 +
    16 i + ch + scan) packets, as tests/test_fengyun3.py builds them."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    pkts = []
    for s in range(mwhs2_scans):
        for marker in range(4):
            pl = bytearray(1018)
            pl[0:8] = _cds_header(2000, 1_000_000 + s * 2667)
            pl[35] = marker << 2
            words = np.zeros(468, np.uint16)
            for g in range(3 if marker == 3 else 4):
                words[106 * g: 106 * g + 98] = \
                    100 * (marker * 4 + g) + np.arange(98) + s
            pl[50: 50 + 2 * 468] = words.astype(">u2").tobytes()
            pkts.append(CCSDSPacket(header=CCSDSHeader(apid=16), payload=pl))
    for s in range(mwts2_scans):
        for marker in range(1, 5):
            pl = bytearray(1018)
            pl[0] = marker << 4
            pl[4:12] = _cds_header(2000, 2_000_000 + s * 5333)
            words = np.zeros(492, np.uint16)
            if marker >= 2:
                px = np.arange(30) + 30 * (marker - 2)
                words[: 30 * 16] = (1000 + 16 * px[:, None]
                                    + np.arange(16)[None, :] + s).reshape(-1)
            pl[38: 38 + 2 * 492] = words.astype(">u2").tobytes()
            pkts.append(CCSDSPacket(header=CCSDSHeader(apid=7), payload=pl))
    return pkts


def fy3_instrument_cadus(rng: np.random.Generator, virr_lines: int,
                         mwhs2_scans: int, mwts2_scans: int):
    """RS-encoded FY-3 CADUs: `virr_lines` VIRR frames as a bit stream in
    VCID 5's 882-byte data zones, then MWHS-2 and MWTS-2 packets on VCID 12
    (CCSDS packets behind an insert zone). Returns (cadus (n, 1024) uint8,
    the VIRR lines sent (virr_lines, 2048, 10))."""
    lines = []
    stream = []
    for i in range(virr_lines):
        frame, img = virr_frame(rng, ms=5_000_000 + 1000 * i)
        stream.append(frame)
        lines.append(img)
    frames = []
    if virr_lines:
        stream = np.concatenate(stream)
        n = -(-len(stream) // 882)
        zones = np.zeros(n * 882, np.uint8)
        zones[: len(stream)] = stream
        virr = np.zeros((n, 896), np.uint8)
        virr[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
        virr[:, 4], virr[:, 5] = 0x40, 5
        virr[:, 14:] = zones.reshape(n, 882)
        frames.append(virr)
    if mwhs2_scans or mwts2_scans:
        frames.append(vcid_frames(
            _fy3_sounder_packets(mwhs2_scans, mwts2_scans), 12, 0))
    return rs_encode_frames(np.concatenate(frames)), \
        np.stack(lines) if lines else np.zeros((0, 2048, 10), np.uint16)


def _noaa_frames(rng: np.random.Generator, n: int, n_words: int,
                 avhrr_at: int, width: int, per_second: int, day: int,
                 ms0: int) -> Tuple[np.ndarray, np.ndarray]:
    """n NOAA frames of random 10-bit words with the 60-bit HRPT sync, the
    day / ms timestamp in words 8-11 (per_second frames a second) and an
    AVHRR line of width x 5 random counts at word avhrr_at. Returns
    (words (n, n_words) uint16, lines (n, width, 5))."""
    from satdump_tpu_torch.models.noaa_hrpt import SYNC_WORDS
    words = rng.integers(0, 1024, (n, n_words), dtype=np.uint16)
    lines = rng.integers(0, 1024, (n, width, 5), dtype=np.uint16)
    words[:, :6] = SYNC_WORDS
    ms = ms0 + 1000 * np.arange(n) // per_second
    words[:, 8] = day << 1
    words[:, 9] = (ms >> 20) & 0x7F
    words[:, 10] = (ms >> 10) & 0x3FF
    words[:, 11] = ms & 0x3FF
    words[:, avhrr_at: avhrr_at + width * 5] = lines.reshape(n, -1)
    return words, lines


def noaa_hrpt_frames(rng: np.random.Generator, n: int, day: int = 100,
                     ms0: int = 43_200_000) -> Tuple[np.ndarray, np.ndarray]:
    """n NOAA HRPT minor frames (11,090 words, 665.4 kbit/s: a frame every
    1/6 s) with an AVHRR line of 2048 x 5 counts at word 750, as
    tests/test_noaa_hrpt.py builds them. Returns (words, lines)."""
    from satdump_tpu_torch.models.noaa_hrpt import FRAME_WORDS
    return _noaa_frames(rng, n, FRAME_WORDS, 750, 2048, 6, day, ms0)


def words_to_bits(words: np.ndarray, width: int = 10) -> np.ndarray:
    """Words -> their `width` low bits each, MSB first, concatenated."""
    w = np.asarray(words, np.uint16).reshape(-1)
    return ((w[:, None] >> np.arange(width - 1, -1, -1)) & 1
            ).astype(np.uint8).reshape(-1)


def noaa_gac_frames(rng: np.random.Generator, n: int, day: int = 100,
                    ms0: int = 43_200_000) -> Tuple[np.ndarray, np.ndarray]:
    """n NOAA GAC frames as sent (3,327 words = 33,270 bits, a frame every
    0.5 s, a GAC AVHRR line of 409 x 5 counts at word 1182), the bits
    after the 60 sync bits XORed with the 1023-bit GAC PN
    (models.noaa_hrpt.gac_pn_bytes). Returns (channel bits (n * 33270,),
    lines (n, 409, 5))."""
    from satdump_tpu_torch.models.noaa_hrpt import GAC_FRAME_BITS, gac_pn_bytes
    words, lines = _noaa_frames(rng, n, GAC_FRAME_BITS // 10, 1182, 409, 2,
                                day, ms0)
    pn = np.unpackbits(gac_pn_bytes())[:GAC_FRAME_BITS]
    return (words_to_bits(words).reshape(n, -1) ^ pn[None]).reshape(-1), \
        lines


def tip_frames(rng: np.random.Generator, n: int) -> np.ndarray:
    """n NOAA DSB TIP frames (104 bytes, 0xEDE2 sync first, the minor frame
    number in bytes 4-5 counting from 0, random data). Returns (n, 104)."""
    frames = rng.integers(0, 256, (n, 104)).astype(np.uint8)
    frames[:, 0], frames[:, 1] = 0xED, 0xE2
    mf = np.arange(n) % 320
    frames[:, 4] = (frames[:, 4] & 0xFE) | (mf >> 8)
    frames[:, 5] = mf & 0xFF
    return frames


def meteor_hrpt_cadus(rng: np.random.Generator, lines: int, serial: int = 3,
                      day_seconds: int = 86400 * 9000):
    """METEOR-M HRPT CADUs carrying `lines` MSU-MR frames (6 channels x
    1572 random 10-bit pixels, H/M/S = 10:30:s) and one BIS-M clock frame
    a line, in the per-CADU byte slices of module_meteor_instruments.cpp,
    as tests/test_meteor_hrpt.py builds them. Returns (cadus (n, 1024)
    uint8, images (lines, 6, 1572))."""
    from satdump_tpu_torch.models import meteor_hrpt as mh
    msumr, bism, imgs = [], [], []
    for i in range(lines):
        f = np.zeros(mh.MSUMR_FRAME, np.uint8)
        f[:8] = np.frombuffer(mh.MSUMR_SYNC.to_bytes(8, "big"), np.uint8)
        f[8], f[9], f[10], f[11] = 10, 30, i % 60, 128
        f[12] = serial << 4
        f[35:50] = np.packbits(words_to_bits(
            rng.integers(0, 1024, 12, dtype=np.uint16)))
        img = rng.integers(0, 1024, (6, 1572), dtype=np.uint16)
        data = np.stack([np.packbits(words_to_bits(img[ch])).reshape(393, 5)
                         for ch in range(6)], 1).reshape(393, 30)
        f[50: 50 + 393 * 30] = data.reshape(-1)
        msumr.append(f)
        imgs.append(img)
        b = np.zeros(mh.BISM_FRAME, np.uint8)
        b[:4] = np.frombuffer(mh.BISM_SYNC.to_bytes(4, "big"), np.uint8)
        b[6:10] = np.frombuffer(int(day_seconds + i).to_bytes(4, "little"),
                                np.uint8)
        bism.append(b)
    msumr, bism = np.concatenate(msumr), np.concatenate(bism)
    per_m = sum(n for _, n in mh._MSUMR_SLICES)
    per_b = sum(n for _, n in mh._BISM_SLICES)
    # BIS-M leads by a frame so each line's day is known when it arrives
    n = -(-len(msumr) // per_m) + 1
    msumr = np.concatenate([np.zeros(per_m, np.uint8), msumr,
                            np.zeros((n - 1) * per_m - len(msumr), np.uint8)])
    bism = np.concatenate([bism, np.zeros(n * per_b - len(bism), np.uint8)])
    cadus = np.zeros((n, mh.CADU_SIZE), np.uint8)
    cadus[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
    for k, (off, ln) in enumerate(mh._MSUMR_SLICES):
        o = sum(x for _, x in mh._MSUMR_SLICES[:k])
        cadus[:, off: off + ln] = msumr.reshape(n, per_m)[:, o: o + ln]
    for k, (off, ln) in enumerate(mh._BISM_SLICES):
        o = sum(x for _, x in mh._BISM_SLICES[:k])
        cadus[:, off: off + ln] = bism.reshape(n, per_b)[:, o: o + ln]
    return cadus, np.stack(imgs)


def stdc_frames() -> np.ndarray:
    """Three 640-byte STD-C frames carrying a Bulletin Board each, a message
    on logical channel 3 in two pieces and a two-part EGC message, as
    tests/test_inmarsat_stdc.py builds them: the third frame's Bulletin
    Board (69 s on) flushes the message. Returns (3, 640) uint8."""
    from satdump_tpu_torch.pipeline.modules.inmarsat.stdc_pkts import \
        append_crc

    def medium(ptype, body):
        return append_crc(bytes([0x80 | ptype, len(body) + 2]) + body
                          + b"\0\0")

    def bulletin(frame_number):
        body = bytes([1, frame_number >> 8, frame_number & 0xFF, 3 << 2,
                      0x00, (1 << 5) | (2 << 2), (1 << 6) | 4, 0xE0, 0x60,
                      0x00, 25])
        return append_crc(bytes([(0x07 << 4) | (len(body) + 2)]) + body
                          + b"\0\0")

    def message(seq, text):
        return medium(0x2A, bytes([(1 << 6) | 4, 3, seq]) + text.encode())

    def egc(ptype, cont, text):
        return medium(ptype, bytes([0x00, (cont << 7) | (1 << 5) | 3, 0, 7,
                                    0, 0]) + b"\x01\x02\x03" + text.encode())

    frames = [[bulletin(1000), message(0, "THE QUICK BROWN "),
               egc(0x31, True, "SECURITE: "), egc(0x32, False, "ICE REPORT")],
              [bulletin(1002), message(1, "FOX JUMPS OVER")],
              [bulletin(1010)]]
    return np.stack([np.frombuffer(b"".join(f).ljust(640, b"\0"), np.uint8)
                     for f in frames])


def acars_signal_units(reg: str, label: str, text: str) -> bytes:
    """An ACARS message as Aero signal units: a User Data ISU (0x71) and its
    SSU chain, 12 bytes each with the CRC, as tests/test_inmarsat_aero.py
    builds them."""
    from satdump_tpu_torch.pipeline.modules.inmarsat.aero_parser import \
        append_crc

    def odd(c):
        return c | 0x80 if bin(c & 0x7F).count("1") % 2 == 0 else c

    body = [0xFF, 0xFF, 0x01, ord("2")]
    body += [odd(ord(ch)) for ch in reg.rjust(7, ".")]
    body += [ord("!"), ord(label[0]), ord(label[1]), ord("1"), 0x02]
    body += [odd(ord(ch)) for ch in text] + [0x03, 0x00, 0x00, 0x7F]
    payload = bytes(body)
    rest = payload[2:]
    n_ssu = -(-len(rest) // 8)
    last = len(rest) - (n_ssu - 1) * 8
    sus = [append_crc(bytes([0x71, 0x12, 0x34, 0x56, 0x01, 0x20,
                             n_ssu & 0x3F, last << 4]) + payload[:2])]
    for i in range(n_ssu):
        seq = 0 if i == n_ssu - 1 else n_ssu - 1 - i
        sus.append(append_crc(bytes([0xC0 | seq, 0x12])
                              + rest[i * 8: (i + 1) * 8].ljust(8, b"\0")))
    return b"".join(sus)


# ---------------------------------------------------------------------------
# JPSS HRD (VIIRS, ATMS, OMPS) and GOES-R HRIT xRIT files
# ---------------------------------------------------------------------------

JPSS_HRD_SPS = (8, 5)   # JPSS-2 HRD: 25 Msym/s OQPSK at 40 Msps
NPP_HRD_SPS = (5, 3)    # Suomi NPP HRD: 15 Msym/s QPSK at 25 Msps
JPSS_DAY = 24000        # CDS day of the synthetic passes (2023-09-17)


def viirs_segment_packets(name: str, det_lines: np.ndarray,
                          day: int = JPSS_DAY, ms: int = 0, seq0: int = 0
                          ) -> list:
    """One VIIRS segment of band `name`: det_lines (zone_height, oversampled
    width) 15-bit samples before aggregation, split per zone and
    Rice-compressed per detector (n 15, J 8, rsi 128). A header packet
    (sequence flag 1, CDS time, packet count) and one body packet a
    detector, with channel_reader.cpp's field offsets, as tests/test_jpss.py
    builds them."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    from satdump_tpu_torch.models.jpss import VIIRS_CHANNELS
    from satdump_tpu_torch.xrit.rice import rice_encode
    ch = VIIRS_CHANNELS[name]
    sync_pattern = 0xDEADBEEF
    hdr = bytearray(_cds_header(day, ms)) + bytes([ch.zone_height]) \
        + bytes(20)
    pkts = [CCSDSPacket(header=CCSDSHeader(
        apid=ch.apid, sequence_flag=1, packet_sequence_count=seq0 & 0x3FFF),
        payload=hdr)]
    for det in range(ch.zone_height):
        body = bytearray(88)
        body[19] = det
        body[20:24] = sync_pattern.to_bytes(4, "big")
        col = 0
        for z in range(6):
            w = ch.zone_width[z] * ch.oversample[z]
            enc = rice_encode(det_lines[det, col: col + w] & 0x7FFF, 15, 8,
                              rsi=128)
            col += w
            body += bytes([0, 0]) + (4 + len(enc)).to_bytes(2, "big") + enc \
                + bytes(4) + sync_pattern.to_bytes(4, "big")
        pkts.append(CCSDSPacket(header=CCSDSHeader(
            apid=ch.apid, sequence_flag=0,
            packet_sequence_count=(seq0 + 1 + det) & 0x3FFF), payload=body))
    return pkts


def viirs_rows(name: str, det_lines: np.ndarray) -> np.ndarray:
    """What VIIRSReader.get_image gives for one segment of det_lines (no
    differential coding): rows line-reversed, oversampled zones averaged,
    times the band's scale."""
    from satdump_tpu_torch.models.jpss import VIIRS_CHANNELS
    ch = VIIRS_CHANNELS[name]
    rows = np.zeros((ch.zone_height, ch.total_width), np.uint16)
    for det in range(ch.zone_height):
        col, out = 0, []
        for z in range(6):
            w, o = ch.zone_width[z], ch.oversample[z]
            v = det_lines[det, col: col + w * o].astype(np.int64) & 0x7FFF
            col += w * o
            out.append(v.reshape(-1, o).sum(axis=1) // o)
        rows[ch.zone_height - 1 - det] = np.clip(
            np.concatenate(out) * ch.scale, 0, 65535)
    return rows


def viirs_scene(rng: np.random.Generator, name: str) -> np.ndarray:
    """(zone_height, oversampled width) uint16 counts for one segment of
    band `name`: a smooth field plus noise, 12-bit."""
    from satdump_tpu_torch.models.jpss import VIIRS_CHANNELS
    ch = VIIRS_CHANNELS[name]
    w = sum(z * o for z, o in zip(ch.zone_width, ch.oversample))
    x = np.arange(w)[None, :] / 377.0
    y = np.arange(ch.zone_height)[:, None] / 5.0
    field = 2000 + 1200 * np.sin(x + 0.1 * ch.apid) * np.cos(y)
    return np.clip(field + rng.normal(0, 24, (ch.zone_height, w)), 0,
                   4095).astype(np.uint16)


def atms_scan_packets(chans: np.ndarray, line: int, day: int = JPSS_DAY,
                      seq0: int = 0) -> list:
    """One ATMS scan: chans (22, 104) counts (96 earth views, 4 cold, 4
    warm), one APID-528 packet a view, the first carrying the scan sync
    flag, as tests/test_jpss.py builds them."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    pkts = []
    for sp in range(104):
        payload = bytearray(_cds_header(day, 8000 * line)) + bytes(2) \
            + bytes([0x80 if sp == 0 else 0, 0]) \
            + chans[:, sp].astype(">u2").tobytes()
        pkts.append(CCSDSPacket(header=CCSDSHeader(
            apid=528, sequence_flag=3,
            packet_sequence_count=(seq0 + sp) & 0x3FFF), payload=payload))
    return pkts


def omps_nadir_packets(vals: np.ndarray, day: int = JPSS_DAY, ms: int = 0,
                       seq0: int = 0) -> list:
    """One OMPS nadir frame: vals (339, 142) counts as 32-bit words at word
    74, Rice-compressed (n 32, J 32, rsi 8) between 149 header and 149
    trailer bytes, in a first packet and its continuations on APID 616
    (omps_nadir_reader.cpp's layout, as tests/test_jpss.py builds it)."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    from satdump_tpu_torch.xrit.rice import rice_encode
    words = np.zeros(74 + vals.size, np.uint32)
    words[74:] = vals.reshape(-1)
    head = bytearray(_cds_header(day, ms)) + bytes(141)
    frame = head + rice_encode(words, 32, 32, rsi=8) + bytes(149)
    parts = [frame[i: i + 4000] for i in range(0, len(frame), 4000)]
    return [CCSDSPacket(header=CCSDSHeader(
        apid=616, sequence_flag=1 if i == 0 else 0,
        packet_sequence_count=(seq0 + i) & 0x3FFF), payload=bytearray(p))
        for i, p in enumerate(parts)]


def jpss_instrument_cadus(rng: np.random.Generator, viirs_bands,
                          atms_scans: int, omps_frames: int,
                          npp: bool = False, idle: int = 8):
    """JPSS HRD CADUs carrying one VIIRS segment of each band in
    `viirs_bands` (VCID 16), `atms_scans` ATMS scans (VCID 1) and
    `omps_frames` OMPS nadir frames (VCID 11), with `idle` fill frames
    (VCID 63) ahead and behind. NOAA-21's layout (`npp` False: SCID 177, a
    9-byte insert zone, 1094-byte M-PDU data, RS(255,223) x5, 1279-byte
    CADUs) or Suomi NPP's (SCID 157, no insert zone, 884 bytes, x4, 1024).
    Returns (cadus, truth) with truth = {"viirs": {band: (rows, width)
    uint16 image rows}, "atms": (scans, 22, 104), "omps": (frames, 339,
    142)}."""
    from satdump_tpu_torch.ccsds.mux import make_cadus_for_vcid
    scid, mpdu, iz, depth = (157, 884, 0, 4) if npp else (177, 1094, 9, 5)
    width = 4 + 223 * depth

    def frames(pkts, vcid):
        return make_cadus_for_vcid(pkts, vcid, scid, mpdu, iz > 0, iz or 2,
                                   total_size=width)
    truth = {"viirs": {}}
    viirs = []
    for i, band in enumerate(viirs_bands):
        det = viirs_scene(rng, band)
        truth["viirs"][band] = viirs_rows(band, det)
        viirs += viirs_segment_packets(band, det, ms=1000 * i,
                                       seq0=100 * i)
    truth["atms"] = rng.integers(0, 65536, (atms_scans, 22, 104),
                                 dtype=np.uint16)
    atms = [p for ln in range(atms_scans)
            for p in atms_scan_packets(truth["atms"][ln], ln, seq0=104 * ln)]
    truth["omps"] = rng.integers(0, 60000, (omps_frames, 339, 142),
                                 dtype=np.int64)
    omps = [p for k in range(omps_frames)
            for p in omps_nadir_packets(truth["omps"][k], ms=8000 * k,
                                        seq0=16 * k)]
    if omps_frames:   # the reader finishes a frame at the next one's start
        omps += omps_nadir_packets(np.zeros((339, 142), np.int64),
                                   ms=8000 * omps_frames)[:1]
    body = _interleave([frames(viirs, 16), frames(atms, 1),
                        frames(omps, 11)])
    fill = idle_cadus(idle, scid, depth)
    return np.concatenate([fill, rs_encode_frames(body, depth), fill]), truth


GOES_HRIT_SCID = 0x0C


def abi_segments(rng: np.random.Generator, nseg: int, width: int,
                 seg_lines: int) -> np.ndarray:
    """(nseg * seg_lines, width) uint8: a smooth ABI-like scene."""
    walk = np.cumsum(rng.normal(0, 2, (nseg * seg_lines, width)), axis=1)
    return np.clip(120 + walk, 0, 255).astype(np.uint8)


def goes_rice_abi_packets(full: np.ndarray, nseg: int, apid0: int = 300,
                          image_id: int = 7, channel: int = 13) -> list:
    """GOES-R HRIT transport packets of an ABI image split into `nseg`
    Rice-compressed segment files (NOAA compression 1): each file's first
    packet carries its headers, each following packet one Rice-compressed
    scanline, as tests/test_xrit.py builds them."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    from satdump_tpu_torch.xrit import (ImageStructureRecord, NOAALRITHeader,
                                        SegmentIdentificationHeader,
                                        TimeStampRecord, build_xrit_file,
                                        compute_crc)
    from satdump_tpu_torch.xrit.rice import rice_encode
    seg_lines = full.shape[0] // nseg
    pkts = []
    for s in range(nseg):
        records = [
            ImageStructureRecord(bit_per_pixel=8, columns_count=full.shape[1],
                                 lines_count=seg_lines, compression_flag=1),
            SegmentIdentificationHeader(
                image_identifier=image_id, segment_sequence_number=s,
                max_segment=nseg, max_column=full.shape[1],
                max_row=full.shape[0]),
            NOAALRITHeader(product_id=16, product_subid=channel,
                           noaa_specific_compression=1),
            TimeStampRecord(days=25000, milliseconds_of_day=43200)]
        raw = build_xrit_file(f"OR_ABI-L2-CMIPF-M6C{channel:02d}_G16_s2022{s}"
                              ".lrit", b"", records)
        tp = (0).to_bytes(2, "big") + (len(raw) * 8).to_bytes(8, "big")
        chunks = [tp + raw] + [rice_encode(line) for line in
                               full[s * seg_lines: (s + 1) * seg_lines]]
        for i, c in enumerate(chunks):
            flag = 1 if i == 0 else 2 if i == len(chunks) - 1 else 0
            pkts.append(CCSDSPacket(
                header=CCSDSHeader(apid=apid0 + s, sequence_flag=flag,
                                   packet_sequence_count=i & 0x3FFF),
                payload=bytearray(c + compute_crc(c).to_bytes(2, "big"))))
    return pkts


def emwin_packets(name: str, text: bytes, apid: int = 400) -> list:
    """An EMWIN text file (file type 2, NOAA product 9, uncompressed) as
    GOES-R HRIT transport packets."""
    from satdump_tpu_torch.xrit import (NOAALRITHeader, build_xrit_file,
                                        packetize_xrit_file)
    raw = build_xrit_file(name, text, [NOAALRITHeader(product_id=9)],
                          file_type_code=2)
    return packetize_xrit_file(raw, apid=apid)


def goes_hrit_xrit_cadus(rng: np.random.Generator, nseg: int, width: int,
                         seg_lines: int, emwin_text: bytes, idle: int = 8):
    """GOES-R HRIT CADUs (1024 bytes, RS(255,223) x4) on VCID 13 carrying an
    ABI image of `nseg` Rice-compressed segments and an EMWIN text file,
    between `idle` fill frames ahead and behind. Returns (cadus, image)."""
    from satdump_tpu_torch.ccsds.mux import make_cadus_for_vcid
    full = abi_segments(rng, nseg, width, seg_lines)
    pkts = goes_rice_abi_packets(full, nseg) + emwin_packets(
        "A_EMWIN_TEST.TXT", emwin_text)
    fill = idle_cadus(idle, GOES_HRIT_SCID)
    frames = rs_encode_frames(make_cadus_for_vcid(pkts, 13, GOES_HRIT_SCID))
    return np.concatenate([fill, frames, fill]), full


# ---------------------------------------------------------------------------
# Aqua DB (MODIS), GOES GVAR and sensor data, M10 radiosondes, Orbcomm
# ---------------------------------------------------------------------------

AQUA_DB_SPS = (2, 1)        # Aqua DB: 7.5 Msym/s OQPSK at 15 Msps
AQUA_SCID = 154
GVAR_SPS = (600, 211)       # GOES GVAR: 2.11 Msym/s BPSK at 6 Msps
GOESN_SD_SPS = (6000, 2621)  # GOES-N sensor data: 2.621 Msym/s at 6 Msps


def modis_day_packet(words415: np.ndarray, position: int, seq: int,
                     scan_count: int = 1, day: int = 20000, ms: int = 0):
    """One MODIS day-group packet half (APID 64): 415 12-bit words and
    their checksum at earth-frame count `position` + 1, as
    tests/test_eos_modis.py builds it."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    from satdump_tpu_torch.models.eos import _modis_crc
    from satdump_tpu_torch.utils.repack import pack_nbits_to_bytes
    words = np.zeros(416, np.uint16)
    words[:415] = words415
    words[415] = _modis_crc(words[:415])
    payload = bytearray(12)
    payload[0:2] = int(day).to_bytes(2, "big")
    payload[2:6] = int(ms).to_bytes(4, "big")
    payload[8] = (scan_count & 0b111) << 1
    efc = position + 1
    payload[9] = (efc >> 4) & 0x7F
    payload[10] = (efc & 0xF) << 4
    payload += bytes(pack_nbits_to_bytes(words, 12))
    payload += bytes(max(0, 636 - len(payload)))
    return CCSDSPacket(header=CCSDSHeader(apid=64, sequence_flag=seq),
                       payload=payload)


def aqua_modis_cadus(rng: np.random.Generator, positions: int,
                     idle: int = 4):
    """Aqua DB CADUs (VCID 30, 884-byte M-PDU data, RS(255,223) x4) carrying
    one MODIS day scan of `positions` earth frames (both packet halves),
    between `idle` fill frames ahead and behind. Returns (cadus, words)
    with words (positions, 2, 415)."""
    from satdump_tpu_torch.ccsds.mux import make_cadus_for_vcid
    words = rng.integers(0, 4096, (positions, 2, 415)).astype(np.uint16)
    pkts = [modis_day_packet(words[p, s], p, s + 1)
            for p in range(positions) for s in range(2)]
    fill = idle_cadus(idle, AQUA_SCID)
    frames = rs_encode_frames(make_cadus_for_vcid(pkts, 30, AQUA_SCID))
    return np.concatenate([fill, frames, fill]), words


def aqua_db_baseband(cadus: np.ndarray, rng: np.random.Generator,
                     snr_db: float = 18.0) -> np.ndarray:
    """Aqua DB downlink of `cadus` at sps 2: randomized, uncoded, each
    OQPSK rail NRZ-M encoded on its own (module_aqua_db_decoder.cpp's
    inverse), an idle tail, RRC alpha 0.5 and the channel of
    `psk_baseband`."""
    bits = encode_cadu_stream_uncoded(cadus)
    bits = np.concatenate([bits, rng.integers(0, 2, 2048).astype(np.uint8)])
    chan = np.empty_like(bits)
    chan[0::2], _ = differential.nrzm_encode(bits[0::2])
    chan[1::2], _ = differential.nrzm_encode(bits[1::2])
    return psk_baseband(chan, rng, AQUA_DB_SPS, "oqpsk", snr_db)


def _gvar_words_frame(block_id: int, words_after_98: np.ndarray
                      ) -> np.ndarray:
    from satdump_tpu_torch.models import goes_gvar as gv
    frame = np.zeros(gv.FRAME_BYTES, np.uint8)
    frame[0:8] = np.frombuffer(gv.ASM_SYNC.to_bytes(8, "big"), np.uint8)
    for off in (8, 38, 68):
        frame[off] = block_id
    packed = np.packbits(((np.asarray(words_after_98, np.uint16)[:, None]
                           >> np.arange(9, -1, -1)) & 1).astype(np.uint8))
    frame[98: 98 + len(packed)] = packed[: gv.FRAME_BYTES - 98]
    return frame


def _gvar_linedoc(counter: int, word_count: int, sc_id: int = 13
                  ) -> np.ndarray:
    w = np.zeros(16, np.uint16)
    w[0] = sc_id
    w[5], w[6] = counter >> 10, counter & 0x3FF
    w[11], w[12] = word_count >> 10, word_count & 0x3FF
    return w


def gvar_imager_frames(rng: np.random.Generator, counter: int,
                       vis_blocks: int = 8):
    """GOES GVAR imager frames of one scan, as tests/test_goes_gvar.py
    builds them: an IR block (4 lines of 10-bit counts) and `vis_blocks`
    visible blocks (one line each). Returns (frames (n, FRAME_BYTES),
    ir (4, IR_WIDTH), vis (vis_blocks, VIS_WIDTH))."""
    from satdump_tpu_torch.models import goes_gvar as gv
    ir = rng.integers(0, 1024, (4, gv.IR_WIDTH)).astype(np.uint16)
    vis = rng.integers(0, 1024, (vis_blocks, gv.VIS_WIDTH)).astype(np.uint16)
    words = np.zeros(16 + 5240 * 3 + gv.IR_WIDTH, np.uint16)
    words[:16] = _gvar_linedoc(counter, 5240)
    for k in range(4):
        words[16 + 5240 * k: 16 + 5240 * k + gv.IR_WIDTH] = ir[k]
    frames = [_gvar_words_frame(1, words)]
    for b in range(vis_blocks):
        frame = _gvar_words_frame(3 + b, _gvar_linedoc(counter, 6530))
        # pixel words start at byte 116, bit offset 6; pixel i = word i + 1
        pw = np.zeros(gv.VIS_WIDTH + 2, np.uint16)
        pw[1: 1 + gv.VIS_WIDTH] = vis[b]
        bits = ((pw[:, None] >> np.arange(9, -1, -1)) & 1).astype(np.uint8)
        packed = np.packbits(np.concatenate(
            [np.unpackbits(frame[116:118])[:6], bits.reshape(-1)]))
        frame[116: 116 + len(packed)] = packed[: gv.FRAME_BYTES - 116]
        frames.append(frame)
    return np.stack(frames), ir, vis


def gvar_baseband(frames: np.ndarray, rng: np.random.Generator,
                  snr_db: float = 18.0) -> np.ndarray:
    """GOES GVAR downlink of `frames` at sps 600/211: each frame randomized
    (rand_frame_tx) to its 262,288 bits, random lead and tail bits, NRZ-S,
    BPSK, RRC alpha 0.5 and the channel of `psk_baseband`."""
    from satdump_tpu_torch.models import goes_gvar as gv
    bits = np.concatenate(
        [rng.integers(0, 2, 4096).astype(np.uint8)]
        + [np.unpackbits(gv.rand_frame_tx(f))[:gv.FRAME_BITS]
           for f in frames] + [rng.integers(0, 2, 4096).astype(np.uint8)])
    chan, _ = differential.nrzs_encode(bits)
    return psk_baseband(chan, rng, GVAR_SPS, "bpsk", snr_db)


def goesn_sd_bits(rng: np.random.Generator, n: int):
    """n GOES-N sensor-data frames behind random lead bits, as
    tests/test_goes_sd.py builds them: the 14-bit ASM over the frame head,
    PN-randomized 480-bit frames. Returns (stream bits before NRZ-M,
    expected decoder output (n, 60))."""
    from satdump_tpu_torch.models.goes_sd import (SD_ASM, SD_ASM_BITS,
                                                  SD_FRAME_BITS,
                                                  SD_FRAME_BYTES, SD_PN)
    payloads = rng.integers(0, 256, (n, SD_FRAME_BYTES), dtype=np.uint8)
    asm = ((SD_ASM >> np.arange(SD_ASM_BITS - 1, -1, -1)) & 1).astype(
        np.uint8)
    out = [rng.integers(0, 2, 2048).astype(np.uint8)]
    for pl in payloads:
        bits = np.unpackbits(pl ^ SD_PN)[:SD_FRAME_BITS]
        bits[:SD_ASM_BITS] = asm
        pl[:] = np.packbits(bits) ^ SD_PN
        out.append(bits)
    out.append(rng.integers(0, 2, 2048).astype(np.uint8))
    return np.concatenate(out), payloads


def goesn_sd_baseband(bits: np.ndarray, rng: np.random.Generator,
                      snr_db: float = 18.0) -> np.ndarray:
    """GOES-N sensor data: NRZ-M, BPSK at sps 6000/2621 and the channel of
    `psk_baseband`."""
    chan, _ = differential.nrzm_encode(bits)
    return psk_baseband(chan, rng, GOESN_SD_SPS, "bpsk", snr_db)


def m10_channel_bits(rng: np.random.Generator, n: int) -> np.ndarray:
    """n M10 radiosonde frames (Manchester channel bits at 9600 baud), a
    position each, behind and between random bits."""
    from satdump_tpu_torch.models.radiosonde import encode_frame
    parts = [rng.integers(0, 2, 500).astype(np.uint8)]
    for i in range(n):
        parts.append(encode_frame({"timestamp": 1700000000 + i,
                                   "lat": 45.0 + 0.01 * i, "lon": 7.0,
                                   "alt": 5000.0 + 10 * i, "sat_count": 8}))
        parts.append(rng.integers(0, 2, 64).astype(np.uint8))
    return np.concatenate(parts)


def orbcomm_channel_bits(rng: np.random.Generator, n: int) -> np.ndarray:
    """n Orbcomm STX frames, an ephemeris packet each and random bytes in
    the unused slots (an all-zero filler droops through fsk_demod's DC
    blocker), as channel bits at 4800 baud behind random bits."""
    from satdump_tpu_torch.models.orbcomm import (STX_FRM_BYTES,
                                                  frame_to_channel_bits,
                                                  make_ephemeris_packet,
                                                  make_frame)
    frames = [make_frame([(2, make_ephemeris_packet(
        105 + i, 1700000000 + i, (6800.0, 1000.0 * i, 1500.0)))],
        fill=rng.integers(0, 256, STX_FRM_BYTES))
        for i in range(n)]
    return np.concatenate([rng.integers(0, 2, 600).astype(np.uint8)]
                          + [frame_to_channel_bits(f) for f in frames])


# ---------------------------------------------------------------------------
# xRIT imagery of ELEKTRO-L, GK-2A and HimawariCast; GOES-R GRB's products
# ---------------------------------------------------------------------------

ELEKTRO_HRIT_SPS = (3000, 1157)   # ELEKTRO-L HRIT: 1.157 Msym/s at 3 Msps
GK2A_LRIT_SPS = (125, 16)         # GK-2A LRIT: 128 ksym/s BPSK at 1 Msps
XRIT_GEO_SCID = 0x2A
J2K_TESTDATA = Path(__file__).resolve().parent / "testdata" / "j2k"


class RawHeaderRecord:
    """An xRIT header record of any type: type, 16-bit length, body."""

    def __init__(self, rtype: int, body: bytes):
        self.rtype = rtype
        self.body = bytes(body)

    def encode(self) -> bytes:
        n = 3 + len(self.body)
        return bytes([self.rtype, n >> 8, n & 0xFF]) + self.body


def msg_segment_record(channel_id: int, seq: int, start: int, end: int
                       ) -> RawHeaderRecord:
    """The MSG-style segment identification header (type 128) of ELEKTRO
    and MSG: spacecraft id, channel id, sequence, planned start and end."""
    return RawHeaderRecord(128, bytes([0, 16, channel_id, seq >> 8, seq & 255,
                                       start >> 8, start & 255, end >> 8,
                                       end & 255, 0]))


def gk2a_segment_record(seq: int, total: int, line: int = 0
                        ) -> RawHeaderRecord:
    """GK-2A's image segmentation identification (type 128)."""
    return RawHeaderRecord(128, bytes([seq, total, line >> 8, line & 255]))


def gk2a_key_record(index: int) -> RawHeaderRecord:
    """GK-2A's key header (type 7): the index of the file's DES key."""
    return RawHeaderRecord(7, index.to_bytes(4, "big"))


def smooth_scene(rng: np.random.Generator, lines: int, width: int,
                 depth: int = 8) -> np.ndarray:
    """(lines, width) uint8 (depth 8) or uint16 (up to 16): a smooth
    imager-like scene that compresses, with a little noise."""
    y, x = np.mgrid[0:lines, 0:width]
    f = (0.5 + 0.22 * np.sin(x / rng.uniform(9, 40) + rng.uniform(0, 6))
         + 0.18 * np.cos(y / rng.uniform(7, 30) + rng.uniform(0, 6))
         + rng.normal(0, 0.01, (lines, width)))
    v = np.clip(f, 0, 1) * ((1 << depth) - 1)
    return np.round(v).astype(np.uint8 if depth <= 8 else np.uint16)


def xrit_geo_cadus(files, vcid: int = 0, scid: int = XRIT_GEO_SCID,
                   idle: int = 8) -> np.ndarray:
    """xRIT files (raw bytes, one APID each) as 1024-byte CADUs, RS(255,223)
    x4 (the ccsds_conv_concat_decoder pipelines' framing), between `idle`
    fill frames ahead and behind."""
    from satdump_tpu_torch.ccsds.mux import make_cadus_for_vcid
    from satdump_tpu_torch.xrit import packetize_xrit_file
    pkts = []
    for k, raw in enumerate(files):
        pkts += packetize_xrit_file(raw, apid=100 + k, seq_start=k * 97)
    fill = idle_cadus(idle, scid)
    frames = rs_encode_frames(make_cadus_for_vcid(pkts, vcid, scid))
    return np.concatenate([fill, frames, fill])


def elektro_xrit_files(rng: np.random.Generator, nseg: int, width: int,
                       seg_lines: int):
    """ELEKTRO-L MSU-GS segment files in EUMETSAT naming with MSG-style
    segment headers: channel 4 (ch5) as 8-bit JPEG (the port's NumPy
    encoder, SOF1 at precision 8) and channel 8 (ch9) as 10-bit lossless
    wavelet (DecompWT), `nseg` segments each. Returns (files, {"jpeg":
    [payload per segment], "wt": 10-bit image})."""
    from satdump_tpu_torch.image.jpeg12 import compress_jpeg12
    from satdump_tpu_torch.xrit import ImageStructureRecord, build_xrit_file
    from satdump_tpu_torch.xrit.decompwt import wt_compress
    jimg = smooth_scene(rng, nseg * seg_lines, width, 8)
    wimg = smooth_scene(rng, nseg * seg_lines, width, 10)
    files, jpegs = [], []
    for kind, ch, img, bpp, flag in (("jpeg", 4, jimg, 8, 2),
                                     ("wt", 8, wimg, 10, 1)):
        for s in range(nseg):
            part = img[s * seg_lines: (s + 1) * seg_lines]
            if kind == "jpeg":
                payload = compress_jpeg12(part, 8, quality_div=4)
                jpegs.append(payload)
            else:
                payload = wt_compress(part, 10)
            name = (f"H-000-GOMS3_-GOMS3________-{ch:02d}_9_076E-"
                    f"00000{s}___-202601010000-__")
            files.append(build_xrit_file(name, payload, [
                ImageStructureRecord(bit_per_pixel=bpp, columns_count=width,
                                     lines_count=seg_lines,
                                     compression_flag=flag),
                msg_segment_record(ch, s, 0, nseg - 1)]))
    return files, {"jpeg": jpegs, "wt": wimg}


def j2k_fixture(name: str) -> bytes:
    """A committed JPEG 2000 codestream of testdata/j2k/."""
    return (J2K_TESTDATA / name).read_bytes()


GK2A_SW038_SEED = 0x5038


def gk2a_xrit_files(rng: np.random.Generator, width: int, seg_lines: int,
                    key_index: int = 3, sw038: str = "encode"):
    """GK-2A AMI segment files, two segments a channel of `seg_lines` x
    `width`: VI006 as 8-bit JPEG, IR105 as 12-bit JPEG (both through
    jpeg12.c in the decoder), WV069 uncompressed and DES-encrypted, SW038
    as J2K (the second segment behind an 85-byte UHRIT preamble), and one
    additional-data file. SW038 is a 12-bit scene of the same size, drawn
    from a generator of its own (GK2A_SW038_SEED: `rng` draws what it drew
    before the scene was added) and encoded by the port's compress_j2k
    (`sw038="encode"`),
    or the committed codestreams at their own 32 x 256, 8-bit
    (`sw038="fixtures"`). Returns (files, key file bytes (the decrypted
    xrit-rx format), {"jpeg8", "jpeg12": [payloads], "wv069": image,
    "j2k": [codestreams], "sw038": the encoded scene or None})."""
    from satdump_tpu_torch.image.j2k import compress_j2k
    from satdump_tpu_torch.image.jpeg12 import compress_jpeg12
    from satdump_tpu_torch.utils.des import DES
    from satdump_tpu_torch.xrit import ImageStructureRecord, build_xrit_file
    key = bytes(rng.integers(0, 256, 8).astype(np.uint8))
    des = DES(key)
    vis = smooth_scene(rng, 2 * seg_lines, width, 8)
    ir = smooth_scene(rng, 2 * seg_lines, width, 12)
    wv = rng.integers(0, 256, (2 * seg_lines, width)).astype(np.uint8)
    if sw038 == "encode":
        sw = smooth_scene(np.random.default_rng(GK2A_SW038_SEED),
                          2 * seg_lines, width, 12)
        j2k = [compress_j2k(sw[s * seg_lines: (s + 1) * seg_lines])
               for s in range(2)]
        j2k_lines, j2k_width, j2k_bpp = seg_lines, width, 12
    elif sw038 == "fixtures":
        sw = None
        j2k = [j2k_fixture(f"gk2a_sw038_{s}.j2k") for s in range(2)]
        j2k_lines, j2k_width = json.loads(
            (J2K_TESTDATA / "MANIFEST.json").read_text())[
                "gk2a_sw038_0.j2k"]["shape"]
        j2k_bpp = 8
    else:
        raise ValueError(f"sw038: 'encode' or 'fixtures', not {sw038!r}")
    files, truth = [], {"jpeg8": [], "jpeg12": [], "wv069": wv, "j2k": j2k,
                        "sw038": sw}

    def isr(bpp, flag, lines=seg_lines, columns=width):
        return ImageStructureRecord(bit_per_pixel=bpp, columns_count=columns,
                                    lines_count=lines, compression_flag=flag)

    for s in range(2):
        rows = slice(s * seg_lines, (s + 1) * seg_lines)
        j8 = compress_jpeg12(vis[rows], 8, quality_div=4)
        j12 = compress_jpeg12(ir[rows], 12, quality_div=8)
        truth["jpeg8"].append(j8)
        truth["jpeg12"].append(j12)
        raw = wv[rows].tobytes()
        enc = b"".join(des.encrypt_block(raw[i: i + 8])
                       for i in range(0, len(raw), 8))
        for ch, payload, rec, extra in (
                ("VI006", j8, isr(8, 2), []),
                ("IR105", j12, isr(12, 2), []),
                ("SW038", (bytes(85) if s else b"") + j2k[s],
                 isr(j2k_bpp, 1, j2k_lines, j2k_width), []),
                ("WV069", enc, isr(8, 0), [gk2a_key_record(key_index)])):
            files.append(build_xrit_file(
                f"IMG_FD_xx_{ch}_20260101_000000_{s:03d}.lrit", payload,
                [rec, gk2a_segment_record(s, 2)] + extra))
    files.append(build_xrit_file("ANT_20260101_000000.txt",
                                 b"GK-2A additional data\n" * 8, []))
    keyfile = bytes([0, 1]) + key_index.to_bytes(2, "little") + key
    return files, keyfile, truth


def himawari_xrit_files(rng: np.random.Generator, width: int,
                        seg_lines: int, channel: str = "DK01VIS"):
    """HimawariCast's ten 16-bit big-endian segments of one channel (10-bit
    samples). Returns (files, the image)."""
    from satdump_tpu_torch.xrit import ImageStructureRecord, build_xrit_file
    img = smooth_scene(rng, 10 * seg_lines, width, 10)
    files = [build_xrit_file(
        f"IMG_{channel}_202601010000_{s + 1:03d}",
        img[s * seg_lines: (s + 1) * seg_lines].astype(">u2").tobytes(),
        [ImageStructureRecord(bit_per_pixel=16, columns_count=width,
                              lines_count=seg_lines, compression_flag=0)])
        for s in range(10)]
    return files, img


GRB_ABI_MESO1_C13 = 0xDC      # mode 6, MESO-1, channel 13 (2 km: 500 x 500)
GRB_GLM_FLASH = 0x302


def grb_packet(apid: int, variant: int, body: bytes, seq: int = 0):
    """A standalone GRB CCSDS packet: the 8-byte GRB secondary header, the
    body and its CRC-32."""
    import zlib
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    payload = bytes([0, 0, 0, 0, 0, 0, (1 << 3) | (variant >> 2),
                     (variant & 0b11) << 6]) + bytes(body)
    h = CCSDSHeader(apid=apid, sequence_flag=3,
                    packet_sequence_count=seq & 0x3FFF, packet_length=0)
    h.packet_length = len(payload) + 4 - 1
    h.raw = h.encode()
    crc = zlib.crc32(h.raw + payload) & 0xFFFFFFFF
    return CCSDSPacket(header=h, payload=bytearray(payload
                                                   + crc.to_bytes(4, "big")))


def grb_image_header(ts: int, width: int, height: int, x: int, y: int,
                     comp: int, dqf_off: int) -> bytes:
    """The 34-byte GRB image payload header."""
    return (bytes([comp]) + ts.to_bytes(4, "big") + bytes(4) + bytes(2)
            + bytes(3) + x.to_bytes(4, "big") + y.to_bytes(4, "big")
            + height.to_bytes(4, "big") + width.to_bytes(4, "big")
            + dqf_off.to_bytes(4, "big"))


def grb_glm_flash_frame(rng: np.random.Generator, n: int) -> bytes:
    """A GLM flash frame: a little-endian count and n 24-byte records."""
    import struct
    out = struct.pack("<Q", n)
    for i in range(n):
        out += struct.pack("<5H2f3H", i + 1, 1, 2, 3, 4,
                           float(rng.uniform(-60, 60)),
                           float(rng.uniform(-140, -20)), 100, 200, 0)
    return out


def grb_cadus(pkts, vcid: int, idle: int = 4) -> np.ndarray:
    """GRB packets as 2048-byte CADUs (M-PDU data zone 2034 at byte 12) on
    `vcid`, the last zone filled by an idle packet (APID 2047), then `idle`
    fill CADUs (VCID 63)."""
    from satdump_tpu_torch.ccsds import CCSDSHeader, CCSDSPacket
    from satdump_tpu_torch.ccsds.mux import mux_packets
    pkts = list(pkts)
    used = sum(6 + len(p.payload) for p in pkts) % 2034
    if pkts and used:
        n = 2034 - used - 6 if 2034 - used > 6 else 2 * 2034 - used - 6
        h = CCSDSHeader(apid=2047, sequence_flag=3, packet_length=n - 1)
        h.raw = h.encode()
        pkts.append(CCSDSPacket(header=h, payload=bytearray(n)))
    zones = mux_packets(pkts, mpdu_data_size=2034)
    out = np.zeros((len(zones) + idle, 2048), np.uint8)
    out[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
    out[:, 4] = 1 << 6
    out[:, 5] = vcid
    out[len(zones):, 5] = 63
    for i, (fhp, data) in enumerate(zones):
        out[i, 6:9] = [(i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF]
        out[i, 10] = (fhp >> 8) & 0b111
        out[i, 11] = fhp & 0xFF
        out[i, 12:12 + 2034] = np.frombuffer(data, np.uint8)
    return out


def grb_abi_cadus(rng: np.random.Generator, blocks, ts: int = 800000000,
                  glm_flashes: int = 3):
    """GOES-R GRB CADUs of an ABI MESO-1 channel-13 image (500 columns at
    2 km) built from `blocks`: each (codestream or None, raw rows) is one
    image payload at the next row offset, J2K (compression 1) when a
    codestream is given, else the rows raw (compression 0); then one GLM
    flash frame on LHCP. Returns (cadus, {"image": the rows sent, stacked,
    "glm": frame bytes, "blocks": count})."""
    pkts, rows, y = [], [], 0
    for seq, (cs, blk) in enumerate(blocks):
        comp = 1 if cs is not None else 0
        data = cs if cs is not None else blk.astype("<u2").tobytes()
        hdr = grb_image_header(ts, blk.shape[1], blk.shape[0], 0, y, comp,
                               len(data))
        pkts.append(grb_packet(GRB_ABI_MESO1_C13, 2, hdr + data, seq))
        rows.append(blk)
        y += blk.shape[0]
    glm = grb_glm_flash_frame(rng, glm_flashes)
    gen = bytes([0]) + (ts + 20).to_bytes(4, "big") + bytes(16)
    cadus = np.concatenate([grb_cadus(pkts, 5, idle=0),
                            grb_cadus([grb_packet(GRB_GLM_FLASH, 0,
                                                  gen + glm)], 6)])
    return cadus, {"image": np.concatenate(rows), "glm": glm,
                   "blocks": len(blocks)}


# ---------------------------------------------------------------------------
# Agency level-1 files (SEVIRI .nat, Himawari HSD) and a MetOp-B TLE
# ---------------------------------------------------------------------------

SEVIRI_COLUMNS = 3712          # VIS/IR columns of a full-disk line
SEVIRI_HRV_COLUMNS = 11136     # HRV image width; each HRV line holds 5568
SEVIRI_HRV_LINE = 5568


def _tle_checksum(line: str) -> str:
    s = sum(int(c) if c.isdigit() else (1 if c == "-" else 0)
            for c in line[:68])
    return line[:68] + str(s % 10)


def metop_b_tle(epoch_unix: float) -> Tuple[str, str]:
    """A MetOp-B two-line element set (NORAD 38771; its orbit: 98.7 deg
    inclination, 14.2149 rev/day, near-circular) with its epoch at
    `epoch_unix`; checksums valid."""
    import time as _time
    tm = _time.gmtime(epoch_unix)
    day = tm.tm_yday + (epoch_unix % 86400) / 86400.0
    l1 = (f"1 38771U 12049A   {tm.tm_year % 100:02d}{day:012.8f}  .00000048"
          "  00000-0  42111-4 0  999")
    l2 = ("2 38771  98.7008 347.6325 0001532  83.6539 276.4816 "
          "14.21494672 99999")
    return _tle_checksum(l1.ljust(68)), _tle_checksum(l2.ljust(68))


def _mh_put(buf: bytearray, off: int, text: str) -> None:
    b = text.encode()
    buf[off: off + len(b)] = b


def seviri_nat(rng: np.random.Generator, vis_lines: int,
               bands: str = "XXXXXXXXXXXX", lower_east_col: int = 2000,
               upper_east_col: int = 4000):
    """A SEVIRI level-1.5 native file (.nat): the main product header's
    ASCII records at their fixed offsets, the 15HEADER with one slope /
    offset pair a channel, the image lines as 38 + 27 header bytes and
    10-bit packed counts (3,712 a VIS/IR line, 5,568 an HRV line, three
    HRV lines a VIS/IR line), and the 15TRAILER's HRV window columns
    (the upper window from HRV line `vis_lines` * 3 / 2). The layout of
    satdump_tpu_torch/products/firstparty/nat_seviri.py (EUMETSAT's native
    format, ref seviri_nat.cpp). Returns (bytes, truth) with truth
    {"vis": {ch: (vis_lines, 3712) counts}, "hrv": (3 * vis_lines, 5568)
    counts, "slope", "offset", "upper_south_line"}."""
    from satdump_tpu_torch.utils.repack import pack_nbits_to_bytes
    hrv_lines = 3 * vis_lines
    chans = [ch for ch in range(12) if bands[ch] == "X"]
    vis = {ch: smooth_scene(rng, vis_lines, SEVIRI_COLUMNS, 10)
           for ch in chans if ch < 11}
    hrv = (smooth_scene(rng, hrv_lines, SEVIRI_HRV_LINE, 10)
           if 11 in chans else None)
    line_len = {ch: 65 + (SEVIRI_HRV_LINE if ch == 11
                          else SEVIRI_COLUMNS) * 10 // 8 for ch in chans}
    data_len = vis_lines * sum(line_len[ch] * (3 if ch == 11 else 1)
                               for ch in chans)
    headerpos = 6000
    cal_off = 38 + headerpos + 1 + 60134 + 700 + 326058 + 101 + 72
    datapos = cal_off + 192 + 1024
    trailerpos = datapos + data_len
    tro = 38 + trailerpos + 1 + 2 + 14 + 12 + 192 + 72 + 16
    buf = bytearray(b" " * (tro + 32))
    _mh_put(buf, 0, "FormatName                  : NATIVE")
    _mh_put(buf, 604, f"15HEADERPosition : 0 {headerpos}")
    _mh_put(buf, 666, f"15DATAPosition : 0 {datapos}")
    _mh_put(buf, 728, f"15TRAILERPosition : 0 {trailerpos}")
    _mh_put(buf, 2314, "ASTI : MSG4")
    _mh_put(buf, 2394, "LLOS : 0.0")
    _mh_put(buf, 2634, "SSBT : 20240101120000.000Z")
    _mh_put(buf, 4394, f"SelectedBandIDs : {bands}")
    _mh_put(buf, 4794, f"NumberLinesVISIR : {vis_lines}")
    _mh_put(buf, 4874, f"NumberColumnsVISIR : {SEVIRI_COLUMNS}")
    _mh_put(buf, 4954, f"NumberLinesHRV : {hrv_lines}")
    _mh_put(buf, 5034, f"NumberColumnsHRV : {SEVIRI_HRV_COLUMNS}")
    slope = rng.uniform(0.005, 0.03, 12)
    offset = -slope * 51.0
    buf[cal_off: cal_off + 192] = struct.pack(
        ">24d", *np.stack([slope, offset], 1).reshape(-1))
    upper_south = hrv_lines // 2
    buf[tro: tro + 32] = struct.pack(
        ">8i", 1, upper_south - 1, lower_east_col, lower_east_col + 5567,
        upper_south, hrv_lines, upper_east_col, upper_east_col + 5567)

    def line(px):
        payload = pack_nbits_to_bytes(np.asarray(px, np.uint16), 10)
        hdr = bytearray(65)
        hdr[18:22] = struct.pack(">I", payload.size + 15 + 27)
        return bytes(hdr) + payload.tobytes()

    out = bytearray()
    for ln in range(vis_lines):
        for ch in chans:
            if ch < 11:
                out += line(vis[ch][ln])
            else:
                for rep in range(3):
                    out += line(hrv[ln * 3 + rep])
    buf[datapos: datapos + len(out)] = out
    return bytes(buf), {"vis": vis, "hrv": hrv, "slope": slope,
                        "offset": offset, "upper_south_line": upper_south}


# Himawari Standard Data: the header blocks' lengths; 1-7 and 11 as the
# format specifies them, 8-10 (navigation correction, observation times,
# error information) holding no entries
HSD_BLOCK_LEN = (282, 50, 127, 139, 147, 259, 47, 40, 15, 40, 259)
AHI_B13 = dict(band=13, wavelength_um=10.4073, columns=5500, bits=12,
               cfac=20466275, lfac=20466275, coff=2750.5, loff=2750.5,
               gain=-0.0074, const=30.32)


def ahi_hsd_segments(rng: np.random.Generator, seg_lines: int, nsegs: int,
                     band: dict = AHI_B13, compress: bool = True):
    """`nsegs` Himawari-9 AHI segment files of one band (default band 13 at
    its 5,500 columns, 2 km): the 11 header blocks of the HSD format at
    their field offsets (satdump_tpu_torch/products/firstparty/hsd_ahi.py,
    ref ahi_hsd.cpp), then the segment's little-endian 16-bit counts,
    bzip2-compressed as distributed. Returns (files, image) with image the
    (nsegs * seg_lines, columns) counts sent (65535 fill pixels
    included)."""
    import bz2
    offs = np.cumsum((0,) + HSD_BLOCK_LEN).tolist()
    ncols = band["columns"]
    img = smooth_scene(rng, nsegs * seg_lines, ncols, band["bits"])
    img[rng.integers(0, img.shape[0], 16),
        rng.integers(0, ncols, 16)] = 65535
    files = []
    for s in range(nsegs):
        buf = bytearray(offs[-1])
        for i, ln in enumerate(HSD_BLOCK_LEN):
            buf[offs[i]] = i + 1
            buf[offs[i] + 1: offs[i] + 3] = struct.pack("<H", ln)
        buf[offs[0] + 6: offs[0] + 16] = b"Himawari-9"
        buf[offs[0] + 46: offs[0] + 54] = struct.pack("<d", 60310.125)
        buf[offs[1] + 5: offs[1] + 10] = struct.pack("<HHB", ncols,
                                                     seg_lines, 0)
        buf[offs[2] + 3: offs[2] + 27] = struct.pack(
            "<diiff", 140.7, band["cfac"], band["lfac"], band["coff"],
            band["loff"])
        buf[offs[2] + 27: offs[2] + 43] = struct.pack("<dd", 42164.0,
                                                      6378.137)
        buf[offs[4] + 3: offs[4] + 14] = struct.pack(
            "<HdB", band["band"], band["wavelength_um"], band["bits"])
        buf[offs[4] + 19: offs[4] + 35] = struct.pack("<dd", band["gain"],
                                                      band["const"])
        buf[offs[6] + 3: offs[6] + 7] = struct.pack("<BBH", nsegs, s + 1,
                                                    s * seg_lines + 1)
        raw = bytes(buf) + img[s * seg_lines: (s + 1) * seg_lines].astype(
            "<u2").tobytes()
        files.append(bz2.compress(raw) if compress else raw)
    return files, img
