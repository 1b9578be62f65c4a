"""Simulation / TX path: modulators + channel model for loopback testing.

The reference ships a channel model (src-core/dsp/channel_model/
channel_model_simple.h) and a GFSK TX modulator for manual loopback tests but
never automates them (SURVEY.md §4). Here the mod -> channel -> demod loop is
a first-class test fixture: synthesize CADUs, encode them through the exact
inverse of the decode chain, modulate, impair, and assert bit-exact recovery.
"""

from __future__ import annotations

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


def ccsds_qpsk_baseband(cadus: np.ndarray, rng: np.random.Generator,
                        sps: Tuple[int, int]) -> np.ndarray:
    """QPSK downlink of `cadus` (MetOp AHRPT, METEOR-M LRPT) at exactly
    sps = up/down samples/symbol: randomize, r=1/2 encode, QPSK, RRC
    (alpha 0.5), then AWGN at 18 dB SNR, a carrier offset of 1e-4
    cycles/sample and a phase of 0.4 rad. A short idle tail after the last
    frame lets the Viterbi flush it. The channel noise seed comes from
    `rng`. Returns complex64 baseband."""
    syms = bits_to_qpsk_symbols(encode_cadu_stream(cadus))
    tail = bits_to_qpsk_symbols(rng.integers(0, 2, 2048).astype(np.uint8))
    tx = qpsk_modulate_rational(np.concatenate([syms, tail]), *sps)
    return ChannelModel(snr_db=18.0, freq_offset=1e-4, phase=0.4,
                        seed=int(rng.integers(1 << 30))).apply(tx)


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
