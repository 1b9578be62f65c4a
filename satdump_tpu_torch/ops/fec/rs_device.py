"""Device-resident batched Reed-Solomon decoder (CCSDS RS(255,223)/(255,239))
— port of satdump_tpu/ops/fec/rs_device.py.

The NumPy codec in reed_solomon.py is the portable reference; this is the
batched tensor form that keeps the CADU chain on the device:

* GF(256) products and inverses are lookups in 64 KB / 256-entry tables (a
  gather costs the card one load; the reference's xtime ladder exists to
  avoid the TPU's slow gathers and gives the same field products);
* GF(2)-linear maps are bit-sliced matrix products: the syndrome operator
  (with the CCSDS dual-basis conversion fused in), and Chien / derivative /
  Omega evaluation over all 255 locations. They are plain float32 matmuls:
  the inputs are 0/1 and the sums are <= 2040, so the result is exact (in
  TF32 or bf16 too), and the parity is taken on the integer cast;
* Berlekamp-Massey as a shift-free recurrence: B' = x^m·B is carried
  pre-shifted, so the per-lane variable shift is a static 1-coefficient
  roll.

Reference behavior: src-core/common/codings/reedsolomon/reedsolomon.cpp
(libcorrect wrapper, poly 0x187, fcr 112/120, prim 11, dual basis,
interleave 4/5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.fec.reed_solomon import (FROM_DUAL, PRIM_POLY,
                                                    TO_DUAL, gf_tables)
from satdump_tpu_torch.utils.device import resolve_device

_MSB_FIRST = np.arange(7, -1, -1)
I32 = torch.int32


def _unpack_bits(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """(..., n) int -> (..., n*8) 0/1 int32, MSB first per byte."""
    b = (x[..., None].to(I32) >> shifts) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8)


def _bitmatmul(bits: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """GF(2) matmul (B, n) @ (n, m) -> (B, m) int32 in {0,1}: float32
    product of 0/1 values (exact), mod 2 on the integer cast."""
    return (bits.to(torch.float32) @ M).to(I32) & 1


def _pack_bits_gf(bits: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(B, nbytes*8) 0/1 -> (B, nbytes) int32, MSB first."""
    out = torch.zeros((bits.shape[0], nbytes), dtype=I32, device=bits.device)
    for k in range(8):
        out = out + (bits[:, k::8] << (7 - k))
    return out


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis (width padded to a power of two)."""
    w = x.shape[-1]
    p = 1 << (w - 1).bit_length()
    if p != w:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (p - w,), dtype=x.dtype,
                                      device=x.device)], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


class RSDevice:
    """Batched RS decoder on a torch device; mirrors reed_solomon.ReedSolomon
    semantics (decode returns (corrected, nerrors) with -1 = uncorrectable,
    input left unmodified). `dual=True` decodes dual-basis (channel-domain)
    codewords directly — the conversion is fused into the GF(2) operators."""

    def __init__(self, k: int = 223, dual: bool = True,
                 fcr: int | None = None, prim: int = 11,
                 poly: int = PRIM_POLY,
                 device: str | torch.device | None = None):
        self.device = dev = resolve_device(device)
        self.n = 255
        self.k = k
        self.nroots = 255 - k
        self.t = self.nroots // 2
        self.fcr = fcr if fcr is not None else (112 if k == 223 else 120)
        self.prim = prim
        self.poly = poly
        self.dual = dual
        exp, log, mul = gf_tables(poly)
        nroots = self.nroots
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                        device=dev)

        # GF(256) product / inverse tables (inv[0] = 0, as a^254)
        mul_i = mul.astype(np.int32)
        inv = np.zeros(256, np.int32)
        inv[1:] = np.argmax(mul_i[1:] == 1, axis=1)
        self._mul = torch.as_tensor(mul_i.reshape(-1), device=dev)
        self._inv = torch.as_tensor(inv, device=dev)
        self._shifts = torch.as_tensor(_MSB_FIRST.astype(np.int32), device=dev)

        # --- syndrome operator (2040, nroots*8), dual conversion fused -----
        deg = 254 - np.arange(255)
        j = np.arange(nroots)
        expo = np.mod(deg[:, None].astype(np.int64)
                      * prim * (self.fcr + j)[None, :], 255)
        P = exp[expo].astype(np.uint8)                      # (255, nroots)
        basis = (1 << _MSB_FIRST).astype(np.uint8)          # MSB-first bit k
        # bit k set in the DUAL byte contributes from_dual(2^(7-k)) in the
        # standard domain (from_dual is GF(2)-linear)
        basis_std = FROM_DUAL[basis] if dual else basis
        prod = mul[basis_std[None, :, None], P[:, None, :]]  # (255,8,nroots)
        Msyn = np.unpackbits(prod[..., None], axis=-1, count=8)
        self._Msyn = f32(Msyn.reshape(255 * 8, nroots * 8))

        # --- Chien / derivative / Omega evaluation operators ----------------
        lpow = np.arange(255)
        i_l = np.arange(nroots + 1)
        Z = exp[np.mod(-prim * np.outer(lpow, i_l).astype(np.int64), 255)]
        self._Mc = f32(self._lin_eval_matrix(Z, mul))        # (264, 2040)
        # derivative: sum over odd i of Lambda_i x^(i-1)
        Zd = np.zeros_like(Z)
        for ii in range(1, nroots + 1, 2):
            Zd[:, ii] = exp[np.mod(-prim * (ii - 1) * lpow.astype(np.int64),
                                   255)]
        self._Md = f32(self._lin_eval_matrix(Zd, mul))
        Zo = exp[np.mod(-prim * np.outer(lpow, np.arange(nroots)
                                         ).astype(np.int64), 255)]
        self._Mo = f32(self._lin_eval_matrix(Zo, mul))       # (256, 2040)
        # X^(1-fcr) factor per location
        self._xpow = torch.as_tensor(
            exp[np.mod(prim * lpow.astype(np.int64) * (1 - self.fcr), 255)
                ].astype(np.int32), device=dev)[None, :]
        self._to_dual = torch.as_tensor(TO_DUAL.astype(np.int32), device=dev)

        # index tables for the BM / Omega Toeplitz gathers
        r_idx = np.arange(nroots)[:, None] - np.arange(nroots + 1)[None, :]
        self._ss_idx = torch.as_tensor(np.clip(r_idx, 0, nroots - 1),
                                       device=dev)
        self._ss_mask = torch.as_tensor(r_idx >= 0, device=dev)
        t_idx = np.arange(nroots)[:, None] - np.arange(nroots)[None, :]
        self._t_idx = torch.as_tensor(np.clip(t_idx, 0, nroots), device=dev)
        self._t_mask = torch.as_tensor(t_idx >= 0, device=dev)

    @staticmethod
    def _lin_eval_matrix(Z: np.ndarray, mul: np.ndarray) -> np.ndarray:
        """Bit-sliced operator for v[l] = XOR_i gf_mul(c_i, Z[l, i]):
        (ncoef*8, 255*8) with MSB-first bit layout."""
        npts, ncoef = Z.shape
        basis = (1 << _MSB_FIRST).astype(np.uint8)
        prod = mul[basis[None, :, None], Z.T[:, None, :].astype(np.uint8)]
        bits = np.unpackbits(prod[..., None], axis=-1, count=8)
        return bits.reshape(ncoef * 8, npts * 8).astype(np.float32)

    # ------------------------------------------------------------ GF(256)
    def gf_mul_dev(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise GF(256) product of int32 arrays (broadcasting)."""
        a, b = torch.broadcast_tensors(a.to(I32), b.to(I32))
        return self._mul[((a << 8) | b).long()]

    def gf_inv_dev(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse (0 -> 0)."""
        return self._inv[a.long()]

    # ------------------------------------------------------------------ core
    def syndromes(self, cw: torch.Tensor) -> torch.Tensor:
        """cw: (B, 255) int32 bytes (dual-domain iff self.dual).
        Returns (B, nroots) int32 standard-domain syndromes."""
        sb = _bitmatmul(_unpack_bits(cw, self._shifts), self._Msyn)
        return _pack_bits_gf(sb, self.nroots)

    def decode(self, cw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """cw: (B, 255) uint8/int32 codewords (dual-domain iff self.dual).
        Returns (corrected (B,255) int32, nerrors (B,) int32; -1 = fail)."""
        cw = cw.to(I32)
        B = cw.shape[0]
        nroots = self.nroots
        dev = cw.device
        zero = torch.zeros((), dtype=I32, device=dev)

        S = self.syndromes(cw)                     # (B, nroots) standard
        no_errors = ~(S != 0).any(dim=1)

        # SS[r, :, i] = S_{r-i} (0 for i > r), gathered once
        SS = torch.where(self._ss_mask, S[:, self._ss_idx], zero
                         ).permute(1, 0, 2)              # (nroots, B, nr+1)

        Lam = torch.zeros((B, nroots + 1), dtype=I32, device=dev)
        Lam[:, 0] = 1
        Bp = torch.zeros((B, nroots + 1), dtype=I32, device=dev)
        Bp[:, 1] = 1                                        # x·1
        L = torch.zeros((B,), dtype=I32, device=dev)
        b = torch.ones((B,), dtype=I32, device=dev)
        zcol = torch.zeros((B, 1), dtype=I32, device=dev)
        for r in range(nroots):
            d = _xor_fold(self.gf_mul_dev(Lam, SS[r]))
            d_zero = d == 0
            grow = (~d_zero) & (2 * L <= r)
            coef = self.gf_mul_dev(d, self.gf_inv_dev(b))
            Lnew = Lam ^ self.gf_mul_dev(coef[:, None], Bp)
            Bp = torch.cat([zcol, torch.where(grow[:, None], Lam, Bp)[:, :-1]],
                           dim=1)
            b = torch.where(grow, d, b)
            L = torch.where(grow, r + 1 - L, L)
            Lam = torch.where(d_zero[:, None], Lam, Lnew)

        # Omega = S * Lambda mod x^nroots via a Toeplitz of Lambda
        lam_bits = _unpack_bits(Lam, self._shifts)              # (B, 264)
        T = torch.where(self._t_mask, Lam[:, self._t_idx], zero)  # (B,nr,nr)
        Om = _xor_fold(self.gf_mul_dev(S[:, None, :], T))       # (B, nroots)

        # Chien + Forney over all 255 locations via bit-matmuls
        vals = _pack_bits_gf(_bitmatmul(lam_bits, self._Mc), 255)
        lam_d = _pack_bits_gf(_bitmatmul(lam_bits, self._Md), 255)
        om_val = _pack_bits_gf(
            _bitmatmul(_unpack_bits(Om, self._shifts), self._Mo), 255)
        is_root = vals == 0                               # (B, 255)
        nerr = is_root.to(I32).sum(dim=1, dtype=I32)

        mag = self.gf_mul_dev(self.gf_mul_dev(self._xpow, om_val),
                              self.gf_inv_dev(lam_d))
        mag = torch.where(is_root, mag, zero)
        # error at Chien index l sits at byte 254-l -> reverse
        corr = mag.flip(1)
        if self.dual:
            corr = self._to_dual[corr.long()]
        corrected = cw ^ corr

        S2 = self.syndromes(corrected)
        ok = ~(S2 != 0).any(dim=1)
        good = (ok & (L <= self.t)) | no_errors
        nerrors = torch.where(no_errors, zero,
                              torch.where(good, nerr, torch.full_like(nerr, -1)))
        out = torch.where(good[:, None], corrected, cw)
        return out, nerrors.to(I32)

    def decode_interleaved(self, data: torch.Tensor, depth: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """data: (B, 255*depth) byte-interleaved (codeword b = data[b::depth]).
        Returns (corrected (B, 255*depth), nerrors (B, depth))."""
        B = data.shape[0]
        cws = data.reshape(B, 255, depth).transpose(1, 2).reshape(
            B * depth, 255)
        corrected, nerr = self.decode(cws)
        out = corrected.reshape(B, depth, 255).transpose(1, 2).reshape(
            B, 255 * depth)
        return out, nerr.reshape(B, depth)
