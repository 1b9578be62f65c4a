"""Inmarsat Aero frame coding: sync patterns, interleaving, scrambling,
C-channel puncturing and the voice/data demux (+ TX inverses for tests).

Reference: plugins/inmarsat_support/aero/{module_aero_decoder.cpp,
decode_utils.cpp} — a frame is [sync][header][info]; info is
`inter_blocks` blocks of 64 x `inter_cols` symbols interleaved by row
permutation (i*27 % 64), Viterbi k=7 {109,79} decoded, and derandomized with
the x^15+x^1 LFSR byte sequence (+ per-byte bit reversal on P/R/T channels).
The 8.4k C channel additionally punctures every 4th trellis symbol
(depuncture shift 2, decode_utils.cpp:18-40) and splits the decoded stream
into 96-bit voice / 13-bit data slices per 109-bit group
(unpack_areo_c84_packet, :42-91).

Counterpart of satdump_tpu/ops/inmarsat_aero.py (host NumPy, copied).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from satdump_tpu_torch.ops.fec.convolutional import conv_encode

# module_aero_decoder.cpp:66-68
SYNC_BPSK = np.array([int(b) for b in
                      f"{0b11100001010110101110100010010011:032b}"], np.uint8)
SYNC_OQPSK = np.array(
    [int(b) for b in
     f"{0b1111110000000011001100111100110011111100110000001100001100001111:064b}"],
    np.uint8)
# module_aero_decoder.cpp:46-59 (C channel, 104 bits)
SYNC_C = np.array([1, 0, 0, 0, 1, 0, 0, 0,
                   1, 1, 0, 1, 1, 0, 1, 0,
                   0, 0, 0, 1, 1, 0, 1, 1,
                   0, 0, 1, 0, 1, 1, 1, 1,
                   0, 1, 1, 1, 1, 0, 0, 1,
                   1, 0, 0, 0, 0, 0, 1, 1,
                   0, 1, 0, 1, 1, 0, 1, 0,
                   1, 1, 0, 0, 0, 0, 0, 1,
                   1, 0, 0, 1, 1, 1, 1, 0,
                   1, 1, 1, 1, 0, 1, 0, 0,
                   1, 1, 0, 1, 1, 0, 0, 0,
                   0, 1, 0, 1, 1, 0, 1, 1,
                   0, 0, 0, 1, 0, 0, 0, 1], np.uint8)

_ROWS = 64
_ROWP = (np.arange(_ROWS) * 27) % _ROWS

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def frame_geometry(oqpsk: bool, dummy_bits: int, inter_cols: int,
                   inter_blocks: int, is_c: bool = False) -> dict:
    """Frame layout per module_aero_decoder.cpp:27-41."""
    if is_c:
        sync = 52 * 2
        hdr = dummy_bits
    else:
        sync = 64 if oqpsk else 32
        hdr = 16 + dummy_bits
    block = _ROWS * inter_cols
    info = block * inter_blocks
    return {"sync": sync, "hdr": hdr, "block": block, "info": info,
            "total": sync + hdr + info}


def deinterleave(block: np.ndarray, cols: int) -> np.ndarray:
    """out[j*64+i] = in[((i*27)%64)*cols + j] (decode_utils.cpp:9-16)."""
    return block.reshape(_ROWS, cols)[_ROWP].T.reshape(-1)


def interleave(data: np.ndarray, cols: int) -> np.ndarray:
    """TX inverse of deinterleave."""
    out = np.zeros((_ROWS, cols), data.dtype)
    out[_ROWP] = data.reshape(cols, _ROWS).T
    return out.reshape(-1)


def randomization_seq(info_size: int) -> np.ndarray:
    """x^15 + x^1 LFSR byte sequence, seed 0b100110101001011
    (module_aero_decoder.cpp:74-94). Returns info_size//8 bytes."""
    shifter = 0b100110101001011
    out = np.empty(info_size // 8, np.uint8)
    byte = 0
    for i in range(info_size):
        newb = (shifter & 1) ^ ((shifter >> 14) & 1)
        shifter = shifter << 1 | newb
        byte = (byte << 1 | newb) & 0xFF
        if i % 8 == 7:
            out[i // 8] = byte
    return out


def depuncture(soft: np.ndarray, shift: int = 2) -> np.ndarray:
    """C-channel depuncture: every 3 input symbols expand to 4 trellis
    symbols with a 128 erasure (decode_utils.cpp:18-40). soft: int8.
    Returns uint8 (soft+127, 128 = erasure)."""
    n = len(soft)
    phase = (np.arange(n) + shift % 3) % 3
    u8 = (soft.astype(np.int16) + 127).clip(0, 255).astype(np.uint8)
    out = []
    # vectorized: emit u8 always; after every phase==1 symbol insert 128
    n_out = n + int(np.sum(phase == 1)) + (1 if shift > 2 else 0)
    res = np.full(n_out, 128, np.uint8)
    pos = np.arange(n) + np.cumsum(phase == 1) - (phase == 1) \
        + (1 if shift > 2 else 0)
    res[pos] = u8
    return res


def puncture_tx(trellis_bits: np.ndarray) -> np.ndarray:
    """TX inverse: drop every 4th trellis symbol (matches depuncture's
    erasure positions for shift=2)."""
    keep = np.ones(len(trellis_bits), bool)
    keep[3::4] = False
    return trellis_bits[keep]


def unpack_c84(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """C-channel voice/data demux (decode_utils.cpp:42-91): walk 341 bytes
    bit-MSB-first; per 109-bit group, bits 1..96 are voice (MSB-first bytes)
    and bits 97..108 feed data blocks (LSB-first byte build).
    Returns (voice 300 bytes, blocks 36 bytes)."""
    bits = np.unpackbits(np.asarray(data[:341], np.uint8))
    bpos = np.arange(len(bits)) % 109
    voice_bits = bits[(0 < bpos) & (bpos <= 96)]
    voice = np.packbits(voice_bits[: (len(voice_bits) // 8) * 8])[:300]
    block_bits = bits[(96 < bpos) & (bpos <= 109)]
    nb = (len(block_bits) // 8) * 8
    # blockByte = bit << 7 | blockByte >> 1 -> LSB-first within each byte
    blocks = np.packbits(block_bits[:nb].reshape(-1, 8)[:, ::-1])[:36]
    return voice, blocks


def pack_c84(voice: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """TX inverse of unpack_c84 -> 341 bytes (+3 pad to 344 for bit count).
    Only the first 25*109+... bits are structured; remaining bits zero."""
    nbits = 341 * 8
    bits = np.zeros(nbits, np.uint8)
    bpos = np.arange(nbits) % 109
    vmask = (0 < bpos) & (bpos <= 96)
    bmask = (96 < bpos) & (bpos <= 109)
    vbits = np.unpackbits(np.asarray(voice[:300], np.uint8))
    nv = min(int(vmask.sum()) // 8 * 8, len(vbits))
    idx = np.nonzero(vmask)[0][:nv]
    bits[idx] = vbits[:nv]
    bbits = np.unpackbits(np.asarray(blocks[:36], np.uint8)
                          .reshape(-1, 1), axis=1)[:, ::-1].reshape(-1)
    nbl = min(int(bmask.sum()) // 8 * 8, len(bbits))
    bits[np.nonzero(bmask)[0][:nbl]] = bbits[:nbl]
    return np.packbits(bits)


def derand_bytes(data: np.ndarray, seq: np.ndarray, reverse: bool = True
                 ) -> np.ndarray:
    """XOR the randomization sequence; P/R/T channels also bit-reverse each
    byte (module_aero_decoder.cpp:182-188)."""
    n = min(len(data), len(seq))
    out = data[:n] ^ seq[:n]
    return _REV8[out] if reverse else out


def rand_bytes_tx(payload: np.ndarray, seq: np.ndarray, reverse: bool = True
                  ) -> np.ndarray:
    """TX inverse of derand_bytes."""
    data = _REV8[np.asarray(payload, np.uint8)] if reverse else \
        np.asarray(payload, np.uint8)
    return data ^ seq[: len(data)]


def encode_frame(payload: np.ndarray, *, oqpsk: bool, dummy_bits: int,
                 inter_cols: int, inter_blocks: int, is_c: bool = False,
                 rng=None) -> np.ndarray:
    """Full TX frame build -> channel bits (0/1) of length geometry[total].
    payload: info//16 bytes (P/R/T) or (voice 300 + blocks 36) pre-packed
    341(+pad) bytes for the C channel. Conv code streams (109, 79)."""
    g = frame_geometry(oqpsk, dummy_bits, inter_cols, inter_blocks, is_c)
    info = g["info"]
    if is_c:
        seq = randomization_seq(5460)
        raw = rand_bytes_tx(payload, seq, reverse=False)
        bits = np.unpackbits(raw)
        if len(bits) < 5460 // 2:
            bits = np.concatenate(
                [bits, np.zeros(5460 // 2 - len(bits), np.uint8)])
        bits = bits[: 5460 // 2]
        coded = conv_encode(bits).reshape(-1, 2)[:, ::-1].reshape(-1)
        coded = puncture_tx(coded)[: info]
        if len(coded) < info:
            coded = np.concatenate(
                [coded, np.zeros(info - len(coded), np.uint8)])
    else:
        seq = randomization_seq(info)
        raw = rand_bytes_tx(payload, seq, reverse=True)
        bits = np.unpackbits(raw)[: info // 2]
        coded = conv_encode(bits).reshape(-1, 2)[:, ::-1].reshape(-1)
    blocks = [interleave(coded[i * g["block"]: (i + 1) * g["block"]],
                         inter_cols) for i in range(inter_blocks)]
    sync = SYNC_C if is_c else (SYNC_OQPSK if oqpsk else SYNC_BPSK)
    if rng is None:
        hdr = np.zeros(g["hdr"], np.uint8)
    else:
        hdr = rng.integers(0, 2, g["hdr"]).astype(np.uint8)
    return np.concatenate([sync, hdr] + blocks)
