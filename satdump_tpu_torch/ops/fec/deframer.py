"""CADU frame sync: correlate-everywhere + state-machine lock tracking.

Reference semantics: src-core/common/codings/deframing/bpsk_ccsds_deframer.cpp
(bit-serial 32-bit shifter vs ASM/~ASM, NOSYNC -> SYNCING -> SYNCED with
per-state hamming tolerance) and codings/correlator.h.

TPU-native reformulation (SURVEY.md A.2): the heavy part — comparing every
bit offset against the syncword — is one vectorized pass over the whole
block (hamming distance at all offsets, on bit-packed words; the inverted
syncword's distance is its length less that); the residual state machine
walks only the *candidate* positions, which is O(frames) per block instead
of O(bits), done host-side in NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

CCSDS_ASM = 0x1ACFFC1D
ASM_SIZE = 32

STATE_NOSYNC = 0
STATE_SYNCING = 2
STATE_SYNCED = 6


def asm_bits(asm: int = CCSDS_ASM, nbits: int = ASM_SIZE) -> np.ndarray:
    return ((asm >> np.arange(nbits - 1, -1, -1)) & 1).astype(np.uint8)


def correlate_bits(bits: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Hamming distance of `pattern` against every offset of `bits`.
    Returns dist[i] (int32) for i in [0, len(bits)-len(pattern)]: the sum,
    over the pattern's 64-bit pieces, of each piece's distance on packed
    words (`_packed_distance`)."""
    n, m = len(bits), len(pattern)
    if n < m:
        return np.zeros(0, dtype=np.int32)
    cnt = n - m + 1
    dist = _packed_distance(bits[:cnt + min(m, 64) - 1], pattern[:64])
    for c in range(64, m, 64):
        q = pattern[c: c + 64]
        dist += _packed_distance(bits[c: c + cnt + len(q) - 1], q)
    return dist


def _packed_distance(bits: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """correlate_bits for a pattern of m <= 64 bits: the m-bit window at
    each offset as one big-endian uint32 (m <= 32) or uint64 word, XOR the
    pattern, popcount. Offsets 8j + r take their words from the bytes
    that `np.packbits` makes of the stream from bit r on."""
    n, m = len(bits), len(pattern)
    cnt = n - m + 1
    dt = np.uint32 if m <= 32 else np.uint64
    nb = np.dtype(dt).itemsize
    k = -(-cnt // 8)                    # offsets of each bit phase
    buf = np.zeros(8 * (k + nb), np.uint8)   # zeros past the end
    buf[:n] = bits
    p = dt(int("".join(str(int(b)) for b in pattern), 2))
    out = np.empty(8 * k, np.int32)
    for r in range(8):
        w = np.packbits(buf[r: r + 8 * (k + nb - 1)]).astype(dt)
        s = 1
        while s < nb:                   # word j: bytes j .. j + 2s - 1
            w = (w[:-s] << dt(8 * s)) | w[s:]
            s *= 2
        w >>= dt(8 * nb - m)
        w ^= p
        out[r::8] = np.bitwise_count(w)
    return out[:cnt]


@dataclass
class DeframerState:
    state: int = STATE_NOSYNC
    bit_inversion: bool = False
    d_good: int = 0
    d_invalid: int = 0
    next_expected: int = -1   # absolute bit index where the next ASM should sit
    tail: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    abs_offset: int = 0       # absolute index of tail[0] in the stream
    # the ASM at tail[0] was already state-checked before the block split a
    # frame — skip re-checking it next call (keeps d_good/d_invalid counts
    # identical to the reference's contiguous bit-serial walk)
    pending_checked: bool = False


class CCSDSDeframer:
    """Streaming CADU deframer over hard bits.

    cadu_size is in bits *including* the 32-bit ASM (matches the reference's
    CADU_SIZE usage: frames emitted are (cadu_size+pad)/8 bytes starting with
    the ASM bytes)."""

    def __init__(self, cadu_size: int, asm: int = CCSDS_ASM,
                 syncing_threshold: int = 2, synced_threshold: int = 6,
                 good_to_lock: int = 10, bad_to_drop: int = 2):
        self.cadu_bits = cadu_size
        self.asm = asm
        self.pattern = asm_bits(asm)
        self.thr_syncing = syncing_threshold
        self.thr_synced = synced_threshold
        self.good_to_lock = good_to_lock
        self.bad_to_drop = bad_to_drop
        self.st = DeframerState()

    def reset(self) -> None:
        self.st = DeframerState()

    @property
    def state(self) -> int:
        return self.st.state

    def work(self, bits: np.ndarray) -> List[np.ndarray]:
        """Process a block of hard bits (uint8 0/1). Returns a list of frames,
        each (cadu_bits/8,) uint8 bytes starting with the ASM."""
        st = self.st
        stream = np.concatenate([st.tail, np.asarray(bits, np.uint8)])
        base = st.abs_offset
        n = len(stream)
        L = self.cadu_bits
        if n < ASM_SIZE:
            st.tail = stream
            return []

        # one correlation: the inverted ASM's distance is ASM_SIZE - dist
        dist = correlate_bits(stream, self.pattern)
        exact = np.flatnonzero((dist == 0) | (dist == ASM_SIZE))

        frames: List[np.ndarray] = []
        pos = 0  # index into stream
        first_prechecked = st.pending_checked
        st.pending_checked = False
        # candidate threshold for searching: exact match when NOSYNC
        while pos + ASM_SIZE <= n:
            if pos == 0 and first_prechecked and st.state != STATE_NOSYNC:
                first_prechecked = False  # ASM already counted last call
            elif st.state == STATE_NOSYNC:
                # next exact ASM (either polarity) at or after pos
                i = np.searchsorted(exact, pos)
                if i == len(exact):
                    pos = n  # nothing in this block
                    break
                pos = int(exact[i])
                st.bit_inversion = dist[pos] != 0  # exact hit was the inverted ASM
                st.state = STATE_SYNCING
                st.d_good = st.d_invalid = 0
                # fall through to frame extraction
            else:
                # expect an ASM exactly at pos
                d = ASM_SIZE - dist[pos] if st.bit_inversion else dist[pos]
                thr = self.thr_syncing if st.state == STATE_SYNCING else self.thr_synced
                if d >= thr:
                    if st.state == STATE_SYNCING:
                        st.d_invalid += 1
                        st.d_good = 0
                        if st.d_invalid > self.bad_to_drop:
                            st.state = STATE_NOSYNC
                            continue
                    else:
                        st.state = STATE_NOSYNC  # hard reset (ref :95-101)
                        continue
                else:
                    if st.state == STATE_SYNCING:
                        st.d_invalid = 0
                        st.d_good += 1
                        if st.d_good > self.good_to_lock:
                            st.state = STATE_SYNCED

            # extract the frame starting at pos if fully present
            if pos + L <= n:
                fb = stream[pos: pos + L]
                if st.bit_inversion:
                    fb = fb ^ 1
                # frame bytes start with the true ASM (ref reset_frame writes
                # the nominal ASM over the frame header)
                fb = fb.copy()
                fb[:ASM_SIZE] = self.pattern
                frames.append(np.packbits(fb))
                pos += L
            else:
                st.pending_checked = True
                break  # partial frame -> keep as tail, ASM already counted

        st.tail = stream[pos:]
        st.abs_offset = base + pos
        self.st = st
        return frames

    def work_soft(self, soft: np.ndarray) -> List[np.ndarray]:
        """Convenience: signed soft bits (int8, >=0 -> 1) to frames."""
        return self.work((np.asarray(soft) >= 0).astype(np.uint8))


def getstate_name(state: int) -> str:
    return {0: "NOSYNC", 2: "SYNCING", 6: "SYNCED"}[state]
