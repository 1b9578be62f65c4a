"""DVB-S2 receive chain: clock-recovered symbols -> BBFrames -> TS — port
of satdump_tpu/ops/dvbs2/rx.py.

Batched composition of plsync + demap + LDPC + BCH (the body of the
reference's module_dvbs2_demod.cpp process_s2/process_s2_bch threads,
restructured so every heavy stage runs on all frames of a block at once).
The PL layer (frame search, PLS decode, per-frame phase recovery) and BCH
run on the host, as in the JAX package; the soft demap and the LDPC
min-sum run on `device` (default cuda), with one copy of the payloads to
it and one of the decoded bits back.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.dvbs2 import defs
from satdump_tpu_torch.ops.dvbs2.bch import get_bch
from satdump_tpu_torch.ops.dvbs2.demap import deinterleave, soft_demap_tensor
from satdump_tpu_torch.ops.dvbs2.ldpc import get_ldpc
from satdump_tpu_torch.ops.dvbs2.plsync import (decode_pls, find_frame_offset,
                                                recover_payload)
from satdump_tpu_torch.ops.dvbs2.scrambling import bb_derandomize
from satdump_tpu_torch.utils.device import resolve_device, to_numpy


class DVBS2Demod:
    """Stateful symbol-stream -> BBFrame decoder for one MODCOD."""

    def __init__(self, modcod: int, shortframes: bool = False,
                 pilots: bool = False, ldpc_iters: int = 30,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = defs.get_modcod_cfg(modcod, shortframes, pilots)
        self.frame_len = defs.plframe_len(self.cfg)
        self.bch = get_bch(self.cfg.frame, self.cfg.rate)
        self.ldpc = get_ldpc(self.cfg.frame, self.cfg.rate, iters=ldpc_iters)
        self.kbch = self.bch.kbch
        self._carry = np.zeros(0, np.complex64)
        self.stats: Dict[str, float] = {
            "frames": 0, "ldpc_ok": 0, "bch_ok": 0, "bch_corrected": 0,
            "detected_modcod": -1, "detected_shortframes": False,
            "detected_pilots": False}

    def process(self, symbols: np.ndarray) -> np.ndarray:
        """Symbol block (1 sps, any length) -> (B, kbch/8) BBFrames
        (descrambled, header+datafield). Carries partial frames across
        calls."""
        payloads, nv = self.pl_layer(symbols)
        if payloads is None:
            return np.zeros((0, self.kbch // 8), np.uint8)
        return self.bch_layer(self.fec_layer(payloads, nv))

    def pl_layer(self, symbols: np.ndarray
                 ) -> Tuple[np.ndarray | None, float]:
        """Host: find the block's whole PLFRAMEs, decode each header and
        recover each payload's phase. Returns ((B, slots*90) complex64
        payloads, the noise variance) or (None, 0) when no whole frame is
        there yet."""
        x = np.concatenate([self._carry, np.asarray(symbols, np.complex64)])
        off, score = find_frame_offset(x, self.frame_len)
        n_frames = (len(x) - off) // self.frame_len
        if n_frames == 0:
            self._carry = x[-2 * self.frame_len:] if len(x) else x
            return None, 0.0
        used = off + n_frames * self.frame_len
        self._carry = x[used:].copy()
        frames = x[off: used].reshape(n_frames, self.frame_len)

        payloads = []
        noise_vars = []
        for f in frames:
            pls, cfo, phase = decode_pls(f[: defs.HDR_LEN])
            self.stats["detected_modcod"] = pls >> 2
            self.stats["detected_shortframes"] = bool(pls & 2)
            self.stats["detected_pilots"] = bool(pls & 1)
            pay = recover_payload(f, self.cfg, cfo, phase)
            payloads.append(pay)
            # noise estimate from corrected header residual
            n = np.arange(defs.HDR_LEN)
            h = f[: defs.HDR_LEN] * np.exp(-1j * (cfo * n + phase))
            ref = np.concatenate([defs.sof_symbols(),
                                  defs.pls_symbols()[pls]])
            noise_vars.append(float(np.mean(np.abs(h - ref) ** 2)))
        self.stats["frames"] += n_frames
        return np.stack(payloads), max(float(np.median(noise_vars)), 1e-3)

    def fec_layer(self, payloads: np.ndarray, nv: float) -> np.ndarray:
        """Device: soft demap, deinterleave and LDPC of (B, slots*90)
        payloads; returns the (B, K) BCH codewords' bits on the host."""
        y = torch.from_numpy(np.ascontiguousarray(payloads, np.complex64))
        soft = soft_demap_tensor(y.to(self.device), self.cfg.constellation,
                                 self.cfg.g1, self.cfg.g2, noise_var=nv)
        cw_soft = deinterleave(soft, self.cfg.constellation, self.cfg.rate)
        bits, ok = self.ldpc.decode_tensor(-cw_soft)   # positive = bit 0
        self.stats["ldpc_ok"] += int(ok.sum())
        return to_numpy(bits[:, : self.ldpc.K])

    def bch_layer(self, nbch_bits: np.ndarray) -> np.ndarray:
        """Host: BCH decode and BB derandomize (B, K) bits -> BBFrames."""
        corrected, ncorr = self.bch.decode(nbch_bits)
        good = ncorr >= 0
        self.stats["bch_ok"] += int(good.sum())
        self.stats["bch_corrected"] += int(ncorr[good].sum())
        kbits = corrected[good, : self.kbch]
        if kbits.shape[0] == 0:
            return np.zeros((0, self.kbch // 8), np.uint8)
        frames_bytes = np.packbits(kbits, axis=-1)
        return bb_derandomize(frames_bytes)
