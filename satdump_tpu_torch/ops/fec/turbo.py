"""CCSDS turbo codes (131.0-B): rates 1/2, 1/3, 1/4, 1/6 at bases
223/446/892/1115 bytes (info blocks 1784/3568/7136/8920 bits).

Reference behavior: src-core/common/codings/turbo/ccsds_turbo.{h,cpp} + the
vendored deepspace-turbo C library (libs/deepspace-turbo/). This is a
from-scratch implementation of the same code family:

* two 16-state recursive systematic constituent encoders (feedback 0b0011
  register form), the CCSDS algorithmic permutation (ccsds_turbo.cpp:22-31),
  per-encoder trellis termination (memory feedback-driven tail), the
  upper/lower mux and the rate-1/2 alternating parity puncture
  (ccsds_turbo.h puncturing());
* decoding is iterative max-log-MAP (BCJR), both constituent decoders
  batched over frames. Each constituent pass is `turbo_bcjr`: on the card
  the hand-written kernel csrc/turbo_bcjr.cu, on the CPU its plain version
  (ops/cuda/turbo_bcjr.py). The iteration loop around it (the interleaver
  gathers and the extrinsic terms) is torch ops on the frames' device.

Counterpart of satdump_tpu/ops/fec/turbo.py: the permutation, the trellis
tables (ops/fec/turbo_trellis.py), the puncture mask, the encoder (a test
fixture) and the depuncturing are host NumPy copies of it.

Soft convention: positive LLR/soft value = bit 1 (the repo's int8 softs).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda.turbo_bcjr import turbo_bcjr
# MEMORY and NSTATES are this module's names in the JAX package too
from satdump_tpu_torch.ops.fec.turbo_trellis import (MEMORY, NSTATES,  # noqa: F401
                                                     _trellis)
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

# (upper component list, lower component list) per nominal rate
_RATES: Dict[str, Tuple[List[str], List[str]]] = {
    "1/2": (["sys", "p1"], ["p1"]),
    "1/3": (["sys", "p1"], ["p1"]),
    "1/4": (["sys", "p2", "p3"], ["p1"]),
    "1/6": (["sys", "p1", "p2", "p3"], ["p1", "p3"]),
}

BASES = (223, 446, 892, 1115)


def ccsds_permutation(base: int) -> np.ndarray:
    """The CCSDS 131.0-B algorithmic interleaver (ccsds_turbo.cpp:16-31)."""
    p = [31, 37, 43, 47, 53, 59, 61, 67]
    k1, k2 = 8, base
    n = base * 8
    pi = np.zeros(n, np.int64)
    for s in range(1, n + 1):
        m = (s - 1) % 2
        i = (s - 1) // (2 * k2)
        j = (s - 1) // 2 - i * k2
        t = (19 * i + 1) % (k1 // 2)
        q = t % 8 + 1
        c = (p[q - 1] * j + 21 * m) % k2
        pi[s - 1] = 2 * (t + c * (k1 // 2) + 1) - m - 1
    return pi


class CCSDSTurbo:
    """One (base, rate) CCSDS turbo code: encode (NumPy fixture) + batched
    iterative max-log-MAP decode (torch, on the device asked for)."""

    def __init__(self, base: int = 223, rate: str = "1/2"):
        if base not in BASES:
            raise ValueError(f"base must be one of {BASES}")
        if rate not in _RATES:
            raise ValueError(f"rate must be one of {sorted(_RATES)}")
        self.base, self.rate = base, rate
        self.info_length = base * 8
        self.pi = ccsds_permutation(base)
        up, lo = _RATES[rate]
        self.cu, self.cl = len(up), len(lo)
        self._up, self._lo = tuple(up), tuple(lo)
        steps = self.info_length + MEMORY
        self.mux_length = steps * (self.cu + self.cl)
        if rate == "1/2":
            k = np.arange(self.mux_length)
            bit_idx = k % 3
            blk = k // 3
            self._punct_keep = (bit_idx == 0) | \
                np.where(blk % 2 == 1, bit_idx != 1, bit_idx != 2)
            self.encoded_length = int(self._punct_keep.sum())
        else:
            self._punct_keep = np.ones(self.mux_length, bool)
            self.encoded_length = self.mux_length
        self._perm: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    # -- encode (host fixture) ------------------------------------------------
    def _conv_encode(self, bits: np.ndarray, comps: Tuple[str, ...]
                     ) -> np.ndarray:
        """bits (B, K) -> (B, (K+4)*C) with feedback-driven termination."""
        ns_t, out_t, term_t = _trellis(comps)
        B, K = bits.shape
        state = np.zeros(B, np.int32)
        C = len(comps)
        out = np.zeros((B, K + MEMORY, C), np.int8)
        for i in range(K):
            b = bits[:, i].astype(np.int32)
            out[:, i] = out_t[state, b]
            state = ns_t[state, b]
        for i in range(K, K + MEMORY):
            b = term_t[state]
            out[:, i] = out_t[state, b]
            state = ns_t[state, b]
        assert (state == 0).all()
        return out

    def encode(self, frames: np.ndarray) -> np.ndarray:
        """frames (B, base) bytes -> (B, ceil(encoded_length/8)) bytes."""
        frames = np.atleast_2d(np.asarray(frames, np.uint8))
        bits = np.unpackbits(frames, axis=-1)
        return np.packbits(self.encode_bits(bits), axis=-1)

    def encode_bits(self, bits: np.ndarray) -> np.ndarray:
        """bits (B, info_length) -> (B, encoded_length) channel bits."""
        bits = np.atleast_2d(np.asarray(bits, np.uint8))
        inter = bits[:, self.pi]
        up = self._conv_encode(bits, self._up)        # (B, S, cu)
        lo = self._conv_encode(inter, self._lo)       # (B, S, cl)
        mux = np.concatenate([up, lo], axis=-1)       # (B, S, cu+cl)
        mux = mux.reshape(bits.shape[0], -1)
        return mux[:, self._punct_keep]

    # -- decode ---------------------------------------------------------------
    def depuncture(self, soft: np.ndarray) -> np.ndarray:
        """(B, encoded_length) soft -> (B, mux_length) with 0-LLR erasures."""
        soft = np.atleast_2d(np.asarray(soft, np.float32))
        out = np.zeros((soft.shape[0], self.mux_length), np.float32)
        out[:, self._punct_keep] = soft
        return out

    def _permutation(self, dev: torch.device):
        """pi and its inverse as index tensors on `dev` (made once)."""
        if dev not in self._perm:
            inv = np.zeros_like(self.pi)
            inv[self.pi] = np.arange(len(self.pi))
            self._perm[dev] = (torch.from_numpy(self.pi).to(dev),
                               torch.from_numpy(inv).to(dev))
        return self._perm[dev]

    def decode(self, soft: np.ndarray, iterations: int = 10,
               device: str | torch.device | None = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """soft (B, encoded_length) float LLRs (positive = bit 1) ->
        (bits (B, info_length) uint8, llr (B, info_length)), decoded on
        `device` (default cuda)."""
        dev = resolve_device(device)
        full = self.depuncture(soft)
        B = full.shape[0]
        S = self.info_length + MEMORY
        mux = torch.from_numpy(full).to(dev).reshape(B, S, self.cu + self.cl)
        Lu = mux[:, :, : self.cu].contiguous()        # (B, S, cu)
        Ll = mux[:, :, self.cu:].contiguous()         # (B, S, cl)
        pi, inv = self._permutation(dev)
        bits, llr = turbo_decode(Lu, Ll, pi, inv, self._up, self._lo,
                                 self.info_length, iterations)
        return to_numpy(bits), to_numpy(llr)


def turbo_decode(Lu: torch.Tensor, Ll: torch.Tensor, pi: torch.Tensor,
                 inv: torch.Tensor, up: Tuple[str, ...], lo: Tuple[str, ...],
                 K: int, iterations: int):
    """The JAX package's `_turbo_decode`: `iterations` rounds of decoder 1
    then decoder 2 exchanging extrinsic LLRs through the interleaver, then
    decoder 1 once more for the final APP. Returns (bits (B, K) uint8, APP
    (B, K) float32) on the inputs' device."""
    Lsys = Lu[:, :K, 0]
    La1 = torch.zeros((Lu.shape[0], K), dtype=torch.float32, device=Lu.device)
    for _ in range(iterations):
        app1 = turbo_bcjr(Lu, La1, up)
        ext1 = app1 - La1 - Lsys
        La2 = (ext1 + Lsys)[:, pi]
        app2 = turbo_bcjr(Ll, La2, lo)
        ext2 = app2 - La2
        La1 = ext2[:, inv]
    app = turbo_bcjr(Lu, La1, up)
    return (app > 0).to(torch.uint8), app
