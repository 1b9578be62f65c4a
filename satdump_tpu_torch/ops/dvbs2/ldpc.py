"""DVB-S2 LDPC codes: IRA construction from the ETSI accumulator tables,
vectorized systematic encoder, batched min-sum decode — port of
satdump_tpu/ops/dvbs2/ldpc.py.

Reference behavior: plugins/dvb_support/codings/dvb-s2/ldpc/ (table-driven
IRA encoder encoder.hh:40-58, layered offset-min-sum decoder
layered_decoder.hh). Here the same H feeds this repo's generic batched
min-sum decoder (ops/fec/ldpc.py, frames in lanes, plain torch ops on the
device it is given); the encoder (host NumPy) is a single scatter-reduce +
cumulative XOR instead of a per-bit loop.

Code structure (EN 302 307-1 §5.3.2): K info bits in groups of 360; info
bit j = g*360+t toggles parity accumulators (x + t*q) mod R for each base
address x of group g, q = R/360. Transmitted parity is the running XOR of
the accumulators (dual-diagonal/staircase), so check i connects its info
bits plus parity bits i and i-1.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.dvbs2.tables_data import TABLES
from satdump_tpu_torch.ops.fec.ldpc import LDPCCode, MinSumDecoder
from satdump_tpu_torch.ops.fec.ldpc_ccsds import code_from_connections


def _info_edges(frame: str, rate: str) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(check, var) arrays for the info-bit part of H, with duplicate
    (check, var) pairs XOR-cancelled. Returns (chk, var, K, N)."""
    K, N, rows = TABLES[(frame, rate)]
    R = N - K
    q = R // 360
    t = np.arange(360)
    chks, vars_ = [], []
    for g, row in enumerate(rows):
        x = np.asarray(row, np.int64)
        # (360, deg) accumulator addresses for the group's bits
        addr = (x[None, :] + t[:, None] * q) % R
        v = (g * 360 + t)[:, None].repeat(len(row), axis=1)
        chks.append(addr.ravel())
        vars_.append(v.ravel())
    chk = np.concatenate(chks)
    var = np.concatenate(vars_)
    # XOR-cancel duplicated connections (GF(2) sum of repeated entries)
    pair = chk.astype(np.int64) * N + var
    uniq, counts = np.unique(pair, return_counts=True)
    keep = uniq[counts % 2 == 1]
    return (keep // N).astype(np.int64), (keep % N).astype(np.int64), K, N


@lru_cache(maxsize=None)
def make_code(frame: str, rate: str) -> Tuple[LDPCCode, int]:
    """Build the full parity-check structure. Returns (code, K)."""
    chk, var, K, N = _info_edges(frame, rate)
    R = N - K
    i = np.arange(R, dtype=np.int64)
    # staircase parity: check i <- parity var K+i; check i>0 <- var K+i-1
    pchk = np.concatenate([i, i[1:]])
    pvar = np.concatenate([K + i, K + i[1:] - 1])
    all_chk = np.concatenate([chk, pchk])
    all_var = np.concatenate([var, pvar])
    conns = set(zip(all_chk.tolist(), all_var.tolist()))
    assert len(conns) == len(all_chk), "unexpected duplicate connections"
    code = code_from_connections(N, R, conns)
    return code, K


class IRAEncoder:
    """Vectorized DVB-S2 LDPC encoder (TX/test fixture, host NumPy).
    Matches the accumulate-then-running-XOR procedure of encoder.hh:40-58."""

    def __init__(self, frame: str, rate: str):
        chk, var, K, N = _info_edges(frame, rate)
        self.K, self.N, self.R = K, N, N - K
        self._chk = chk
        self._var = var

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg (..., K) bits -> codeword (..., N) = [msg | parity]."""
        msg = np.asarray(msg, np.uint8)
        lead = msg.shape[:-1]
        m2 = msg.reshape(-1, self.K)
        B = m2.shape[0]
        acc = np.zeros((B, self.R), np.int64)
        contrib = m2[:, self._var].astype(np.int64)        # (B, E)
        np.add.at(acc, (np.arange(B)[:, None], self._chk[None, :]), contrib)
        parity = (np.cumsum(acc & 1, axis=-1) & 1).astype(np.uint8)
        return np.concatenate([m2, parity], axis=-1).reshape(lead + (self.N,))


class DVBS2LDPC:
    """One DVB-S2 LDPC code: batched min-sum decode + encoder access.
    LLR convention: positive = bit 0 (decoder convention of ops/fec/ldpc)."""

    def __init__(self, frame: str, rate: str, iters: int = 25):
        self.frame, self.rate = frame, rate
        self.code, self.K = make_code(frame, rate)
        self.N = self.code.n
        self.dec = MinSumDecoder(self.code, iters=iters)

    def decode(self, llr: np.ndarray, device: str | torch.device | None = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """llr (B, N) float -> (bits (B, N) uint8, parity_ok (B,)), decoded
        on `device` (default cuda)."""
        return self.dec.decode(llr, device=device)

    def decode_tensor(self, llr: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """llr (B, N) float32 on its device -> (bits, ok) on that device."""
        return self.dec.decode_tensor(llr)


@lru_cache(maxsize=None)
def get_ldpc(frame: str, rate: str, iters: int = 25) -> DVBS2LDPC:
    return DVBS2LDPC(frame, rate, iters=iters)
