"""Bit repacking utilities (ref src-core/common/repack.h), vectorized over
all lines/packets at once. Words are cut from groups of lcm(n, 8) bits:
each group of bytes becomes one integer, and its words come out by shift
and mask (10-bit words: 4 from every 5 bytes), so no bit matrix is built.
A group must fit one 64-bit integer (n = 10, 12, 16, ...)."""

from __future__ import annotations

from math import gcd

import numpy as np


def _group(nbits: int) -> tuple[int, int]:
    """(bytes, words) of the smallest whole group of n-bit words."""
    group_bits = nbits * 8 // gcd(nbits, 8)
    if group_bits > 64:
        raise ValueError(f"{nbits}-bit words need a {group_bits}-bit group; "
                         "at most 64 bits are supported")
    return group_bits // 8, group_bits // nbits


def repack_bytes_to_nbits(data: np.ndarray, nbits: int) -> np.ndarray:
    """data: (..., nbytes) uint8 -> (..., nwords) uint16/uint32 of
    big-endian-packed n-bit words (ref repackBytesTo10bits etc.)."""
    gbytes, gwords = _group(nbits)
    data = np.asarray(data, np.uint8)
    lead, nbytes = data.shape[:-1], data.shape[-1]
    nwords = nbytes * 8 // nbits
    ngroups = -(-nbytes // gbytes)
    padded = np.zeros(lead + (ngroups * gbytes,), np.uint8)
    padded[..., :nbytes] = data
    g = padded.reshape(lead + (ngroups, gbytes)).astype(np.uint64)
    acc = np.zeros(lead + (ngroups,), np.uint64)
    for i in range(gbytes):
        acc = (acc << np.uint64(8)) | g[..., i]
    shifts = np.arange(gwords - 1, -1, -1, dtype=np.uint64) * np.uint64(nbits)
    words = (acc[..., None] >> shifts) & np.uint64((1 << nbits) - 1)
    words = words.reshape(lead + (ngroups * gwords,))[..., :nwords]
    return words.astype(np.uint16 if nbits <= 16 else np.uint32)


def repack_10bit(data: np.ndarray) -> np.ndarray:
    return repack_bytes_to_nbits(data, 10)


def repack_12bit(data: np.ndarray) -> np.ndarray:
    return repack_bytes_to_nbits(data, 12)


def pack_nbits_to_bytes(words: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of repack_bytes_to_nbits (for TX/test fixtures): the words'
    bits back to back, zero-padded to whole bytes."""
    gbytes, gwords = _group(nbits)
    words = np.asarray(words, np.uint32)
    lead, nwords = words.shape[:-1], words.shape[-1]
    ngroups = -(-nwords // gwords)
    w = np.zeros(lead + (ngroups * gwords,), np.uint64)
    w[..., :nwords] = words & ((1 << nbits) - 1)
    w = w.reshape(lead + (ngroups, gwords))
    acc = np.zeros(lead + (ngroups,), np.uint64)
    for i in range(gwords):
        acc = (acc << np.uint64(nbits)) | w[..., i]
    shifts = np.arange(gbytes - 1, -1, -1, dtype=np.uint64) * np.uint64(8)
    out = ((acc[..., None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)
    return out.reshape(lead + (ngroups * gbytes,))[..., : -(-nwords * nbits // 8)]
