"""Inmarsat STD-C frame coding: sync search, permutation, interleaving,
scrambling (+ TX inverses for loopback tests).

Reference: plugins/inmarsat_support/stdc/decode_utils.{h,cpp} — a 10368-symbol
frame is 64 rows x 162 symbols; each received row j leads with two sync
symbols equal to SYNCWORD[j] (decode_utils.cpp:12-38), rows are permuted by
j = (i*23) % 64 (depermute, :40-44), the 160 data columns are read out
column-major (deinterleave, :46-51), Viterbi k=7 {109,79} decoded, and the
640 decoded bytes are bit-reversed and XORed with a 160-entry per-4-byte
scrambling mask (descramble, :53-62).

The frame correlator is a dense gather+dot over all offsets at once (the
sync pattern touches only 128 of 10368 positions, so the score for every
offset of a chunk is one (L,128)x(128,) contraction instead of the
reference's per-offset byte loop); permutation/interleaving are pure numpy
reshapes.

Counterpart of satdump_tpu/ops/inmarsat_stdc.py: the same host NumPy, and
the Viterbi is the port's batched block decoder
(`convolutional.viterbi_decode_block`: the CUDA kernel K3 on the card)
on the given device, several frames as rows of one call.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.fec.convolutional import (conv_encode,
                                                     soft_int8_to_u8,
                                                     viterbi_decode_block)
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

ENCODED_FRAME_SIZE = 10368          # 64 rows x 162 symbols
ENCODED_FRAME_SIZE_NOSYNC = 10240   # 64 x 160 data symbols
FRAME_SIZE_BYTES = 640              # decoded frame
ROWS = 64
ROW_LEN = 162
DATA_COLS = 160

# decode_utils.cpp:12-13 (one bit per row, repeated on both sync symbols)
SYNCWORD = np.array([0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0,
                     1, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 0,
                     0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1,
                     0, 0, 1, 0, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0],
                    np.uint8)

# decode_utils.cpp:53-56 (per-4-byte-group scrambling flags)
SCRAMBLING = np.array([0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1,
                       0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1,
                       0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 0, 0, 0,
                       0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 0, 1,
                       0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 0, 1, 1,
                       1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0,
                       1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0,
                       0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0,
                       1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0],
                      np.uint8)

# sync pattern as (position, +-1 expected sign) over one frame
_SYNC_POS = np.concatenate([np.arange(ROWS) * ROW_LEN,
                            np.arange(ROWS) * ROW_LEN + 1])
_SYNC_SIGN = np.concatenate([2.0 * SYNCWORD - 1.0] * 2).astype(np.float32)

_PERM = (np.arange(ROWS) * 23) % ROWS          # depermuted row i <- rx row PERM[i]

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def frame_match_scores(soft: np.ndarray) -> np.ndarray:
    """Sync correlation score for every start offset (vectorized
    compute_frame_match, decode_utils.cpp:15-38). soft: int8 symbols.
    Returns (len(soft) - ENCODED_FRAME_SIZE + 1,) float signed scores in
    [-128, 128]: score = match_nrm - match_inv; the reference's best match
    is (128 + |score|)/2 and inverted = score < 0."""
    n = len(soft) - ENCODED_FRAME_SIZE + 1
    if n <= 0:
        return np.zeros(0, np.float32)
    hard = np.where(soft > 0, 1.0, -1.0).astype(np.float32)
    idx = np.arange(n)[:, None] + _SYNC_POS[None, :]     # (n, 128)
    return hard[idx] @ _SYNC_SIGN


def depermute(frame: np.ndarray) -> np.ndarray:
    """Row depermutation (decode_utils.cpp:40-44)."""
    return frame.reshape(ROWS, ROW_LEN)[_PERM].reshape(-1)


def deinterleave(frame: np.ndarray) -> np.ndarray:
    """Column-major readout skipping the 2 sync symbols per row
    (decode_utils.cpp:46-51). Returns 10240 symbols."""
    return frame.reshape(ROWS, ROW_LEN)[:, 2:].T.reshape(-1)


def descramble(pkt: np.ndarray) -> np.ndarray:
    """Bit-reverse each byte and XOR the per-4-byte-group mask
    (decode_utils.cpp:58-62). pkt: (640,) uint8."""
    mask = np.repeat(np.where(SCRAMBLING > 0, 0xFF, 0).astype(np.uint8), 4)
    return _REV8[pkt] ^ mask[: len(pkt)]


# -- TX side (tests / simulator) ---------------------------------------------

def scramble(pkt: np.ndarray) -> np.ndarray:
    """Inverse of descramble (XOR then bit-reverse commute per byte)."""
    mask = np.repeat(np.where(SCRAMBLING > 0, 0xFF, 0).astype(np.uint8), 4)
    return _REV8[pkt ^ mask[: len(pkt)]]


def interleave_frame(coded_bits: np.ndarray) -> np.ndarray:
    """Inverse of depermute+deinterleave: 10240 coded bits -> 10368-bit
    frame with sync columns, in received (channel) order."""
    assert len(coded_bits) == ENCODED_FRAME_SIZE_NOSYNC
    dep = np.zeros((ROWS, ROW_LEN), np.uint8)
    dep[:, 2:] = coded_bits.reshape(DATA_COLS, ROWS).T
    rx = np.zeros((ROWS, ROW_LEN), np.uint8)
    rx[_PERM] = dep
    rx[:, 0] = SYNCWORD
    rx[:, 1] = SYNCWORD
    return rx.reshape(-1)


def encode_frame(frame_bytes: np.ndarray) -> np.ndarray:
    """Full STD-C TX frame build: 640 bytes -> 10368 channel bits (0/1).
    Mirrors decode_utils in reverse; the convolutional code streams
    (poly 109, poly 79) in that order (module_stdc_decoder.cpp:14)."""
    raw = scramble(np.asarray(frame_bytes, np.uint8))
    bits = np.unpackbits(raw)
    pairs = conv_encode(bits).reshape(-1, 2)[:, ::-1]    # swap to {109,79}
    return interleave_frame(pairs.reshape(-1))


def decode_frames(frames_soft: np.ndarray, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 10368) int8 soft symbols (already inversion-corrected) -> (B, 640)
    bytes and (B,) viterbi ber estimates. The B frames are the rows of one
    block decode on `device` (default cuda). The pair swap maps the
    {109,79} stream onto the shared {79,109} trellis decoder."""
    frames_soft = np.asarray(frames_soft, np.int8).reshape(
        -1, ENCODED_FRAME_SIZE)
    deint = np.stack([deinterleave(depermute(f)) for f in frames_soft])
    u8 = soft_int8_to_u8(deint).reshape(len(deint), -1, 2)[:, :, ::-1]
    bits, _ = viterbi_decode_block(torch.from_numpy(
        np.ascontiguousarray(u8, np.float32)).to(resolve_device(device)))
    bits = to_numpy(bits).astype(np.uint8)
    # BER estimate: re-encode and compare against hard decisions
    # (viterbi27.cpp:58-66; the reference scales by 4)
    data = np.empty((len(bits), FRAME_SIZE_BYTES), np.uint8)
    bers = np.empty(len(bits))
    for i, b in enumerate(bits):
        re_enc = conv_encode(b).reshape(-1, 2)[:, ::-1].reshape(-1)
        bers[i] = np.mean(re_enc != (deint[i] > 0))
        data[i] = descramble(np.packbits(b))
    return data, bers


def decode_frame(frame_soft: np.ndarray, device=None
                 ) -> Tuple[np.ndarray, float]:
    """One frame: 10368 int8 soft symbols -> (640 bytes, viterbi ber
    estimate), decoded on `device` (default cuda)."""
    data, bers = decode_frames(frame_soft[None], device)
    return data[0], float(bers[0])


def find_frames(soft: np.ndarray, threshold: int = 120
                ) -> list[Tuple[int, bool]]:
    """All frame starts in a soft chunk: offsets where the sync correlation
    clears the reference's >120/128 bar (module_stdc_decoder.cpp:49-51).
    Returns [(offset, inverted)] with offsets spaced >= one frame apart."""
    scores = frame_match_scores(soft)
    bar = 2 * threshold - 128            # match > threshold in signed form
    hits = np.nonzero(np.abs(scores) > bar)[0]
    out: list[Tuple[int, bool]] = []
    last = -ENCODED_FRAME_SIZE
    for o in hits:
        if o - last < ENCODED_FRAME_SIZE:
            continue
        # refine within the next few offsets (a strong frame can clear the
        # bar one symbol early on noisy data): take the local best
        win = scores[o: min(o + 4, len(scores))]
        best = o + int(np.argmax(np.abs(win)))
        out.append((best, bool(scores[best] < 0)))
        last = best
    return out
